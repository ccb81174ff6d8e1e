"""Dequantize-in-kernel bf16 matmul (port of ``kernels/dequant_matmul.py``),
kernel B5.

    y = x_bf16 @ dequant(W)^T      f32 accumulation, out in x's dtype

The weight stays packed (int4 nibbles, int8 or fp8 bytes, f32 group scales
and zero points) and each (row, group) strip is dequantized to bf16 inside
the kernel (``csrc/dequant_matmul.cu``), with the TPU kernel bodies'
roundings, which are not :func:`~..qformats.dequantize`'s:

* int4, no zero points: ``bf16(code - 8) * bf16(s)``, one rounding of the
  exact product (``_int4_kernel`` :84-85, :97-99);
* int4 with zero points: ``bf16((code - 8 - z) * s)`` in f32 (:81-82, :94-95);
* int8: ``bf16((code - z) * s)`` in f32 (:122-130);
* fp8 e4m3 / e5m2: ``bf16(code * s + z)`` in f32, z added (:152-161).

:func:`dequant_matmul` routes as the JAX function does: a weight that
:func:`supported` rejects goes to :func:`dequant_matmul_dense`
(dequantize, then a float32 matmul) — the JAX package's routing by shape,
not a fallback on failure. A supported weight goes to
:func:`dequant_matmul_codes`, which launches the kernel for CUDA tensors
(or raises) and runs :func:`dequant_matmul_plain` for CPU tensors. The
plain version builds the same bf16 weight and multiplies f32 copies, so
kernel and plain version differ only in the f32 summation order.

On the card the K dimension is split over whole groups (whole group pairs
for int4 pair planes) when the output tiles alone would leave SMs idle:
:func:`split_plan` picks the number of splits (split z takes units
[z U / s, (z + 1) U / s), floored, so the splits differ by at most one),
and with more than one split the kernel writes f32 partials to a workspace
that a second kernel adds in split order, so the result does not depend on
scheduling. Any even group size runs on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..device import full_f32_accumulation
from ..qformats.formats import ElemFormat
from ..qformats.qtensor import QTensor, _unpack_nibbles, _unpack_nibbles_pairs, dequantize
from . import _build

# weight formats of the C interface
F_INT8, F_INT4_PAIRS, F_INT4_HALVES, F_FP8_E4M3, F_FP8_E5M2 = range(5)
_CODE_DTYPES = {F_INT8: torch.int8, F_INT4_PAIRS: torch.uint8, F_INT4_HALVES: torch.uint8,
                F_FP8_E4M3: torch.float8_e4m3fn, F_FP8_E5M2: torch.float8_e5m2}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dims(qt: QTensor):
    """(N, C, g) from the array shapes (JAX ``_dims`` :179): codes (N, C[/2]),
    scales (N, G)."""
    N, cp = qt.codes.shape
    G = qt.scales.shape[-1]
    gp = cp // G
    g = 2 * gp if qt.quantizer.fmt == ElemFormat.int4 else gp
    return N, G * g, g


def supported(qt: QTensor) -> bool:
    """The JAX kernel's eligibility predicate (``_supported`` :193), kept so
    that both packages route every shape alike."""
    q = qt.quantizer
    if q.eff_axes != -1 or len(qt.shape) != 2 or qt.codes.dim() != 2:
        return False
    if q.qtype == "int" and q.fmt in (ElemFormat.int4, ElemFormat.int8):
        pass
    elif q.qtype in ("fp", "mx") and q.fmt in (ElemFormat.fp8_e4m3, ElemFormat.fp8_e5m2):
        pass
    else:
        return False
    N, C, g = dims(qt)
    if qt.shape[-1] % g:  # logical C was padded at pack time
        return False
    if not (C % g == 0 and g % 2 == 0 and N % 128 == 0 and C % 128 == 0 and g >= 128):
        return False
    # int4 K-blocks must yield a packed lane dim that tiles (>= 128 bytes)
    if q.fmt == ElemFormat.int4 and (C // g) % 2 and g // 2 < 128:
        return False
    return True


def weight_format(qt: QTensor) -> int:
    if qt.fmt == ElemFormat.int8:
        return F_INT8
    if qt.fmt == ElemFormat.int4:
        return F_INT4_PAIRS if qt.pair_planes else F_INT4_HALVES
    return F_FP8_E4M3 if qt.fmt == ElemFormat.fp8_e4m3 else F_FP8_E5M2


# ---------------------------------------------------------------------------
# Split-K plan of the kernel
# ---------------------------------------------------------------------------

TILE_M, TILE_N = 128, 64   # output tile of one CTA (csrc/dequant_matmul.cu TM, TN)
MAX_SPLITS = 16
FILL = 1.5                 # CTAs wanted per SM before K is split


def split_units(C: int, g: int, fmt: int) -> int:
    """What a split walks whole: groups, or group pairs for int4 pair
    planes (a byte holds one element of each group of its pair)."""
    G = C // g
    return G // 2 if fmt == F_INT4_PAIRS else G


def plan_splits(tiles: int, units: int, sms: int) -> int:
    """Number of K-splits s for a grid of ``tiles`` output tiles over
    ``units`` K units: the smallest power of two with tiles * s >=
    FILL * sms, at most the largest power of two within both the unit count
    and MAX_SPLITS; 1 when the tiles already fill the card. The W4A8 core
    plans by the same rule."""
    cap = min(units, MAX_SPLITS)
    s = 1
    while tiles * s < FILL * sms and 2 * s <= cap:
        s *= 2
    return s


def split_plan(M: int, N: int, C: int, g: int, fmt: int, sms: int) -> int:
    """:func:`plan_splits` over this kernel's tiles and units
    (:func:`split_units`)."""
    return plan_splits(-(-M // TILE_M) * -(-N // TILE_N), split_units(C, g, fmt), sms)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def dequant_weight_bf16(codes, scales, zeros, fmt: int) -> torch.Tensor:
    """(N, C) bf16 weight with the kernel bodies' roundings."""
    N, G = scales.shape
    s, z = scales[:, :, None], None if zeros is None else zeros[:, :, None]
    if fmt in (F_INT4_PAIRS, F_INT4_HALVES):
        if fmt == F_INT4_PAIRS:
            nib = _unpack_nibbles_pairs(codes.reshape(N, G // 2, -1), 1)
        else:
            nib = _unpack_nibbles(codes.reshape(N, G, -1), 2)
        v = nib.float() - 8.0
        if z is None:  # exact product of two bf16 values, rounded once
            w = (v * s.to(torch.bfloat16).float()).to(torch.bfloat16)
        else:
            w = ((v - z) * s).to(torch.bfloat16)
    elif fmt == F_INT8:
        b = codes.reshape(N, G, -1).float()
        w = ((b if z is None else b - z) * s).to(torch.bfloat16)
    else:
        p = codes.reshape(N, G, -1).float() * s
        w = (p if z is None else p + z).to(torch.bfloat16)
    return w.reshape(N, -1)


def dequant_matmul_plain(x_bf16, codes, scales, zeros, fmt: int, out_dtype):
    """Plain version of B5: (M, N) in ``out_dtype``."""
    w = dequant_weight_bf16(codes, scales, zeros, fmt)
    return torch.matmul(x_bf16.float(), w.float().t()).to(out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _check(x_bf16, codes, scales, zeros, fmt, out_dtype):
    if x_bf16.dtype != torch.bfloat16 or x_bf16.dim() != 2:
        raise ValueError("x must be a 2-D bf16 tensor")
    if fmt not in _CODE_DTYPES or codes.dtype != _CODE_DTYPES[fmt] or codes.dim() != 2:
        raise ValueError(f"codes must be 2-D {_CODE_DTYPES.get(fmt)} for format {fmt}")
    if scales.dtype != torch.float32 or scales.dim() != 2 or (
            zeros is not None and (zeros.dtype != torch.float32 or zeros.shape != scales.shape)):
        raise ValueError("scales (and zeros) must be (N, G) float32")
    M, C = x_bf16.shape
    N, G = scales.shape
    packed4 = fmt in (F_INT4_PAIRS, F_INT4_HALVES)
    if C % G or (C // G) % 2 or codes.shape != (N, C // 2 if packed4 else C):
        raise ValueError(f"codes {tuple(codes.shape)} / scales {tuple(scales.shape)} do not "
                         f"match C={C} with an even group size")
    if fmt == F_INT4_PAIRS and G % 2:
        raise ValueError("pair-planes codes need an even group count")
    tensors = [t for t in (x_bf16, codes, scales, zeros) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("tensors on different devices")
    if x_bf16.is_cuda:
        if out_dtype not in _OUT_KINDS:
            raise ValueError(f"the kernel writes float32, bfloat16 or float16, not {out_dtype}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("kernel inputs must be contiguous")
        if x_bf16.data_ptr() % 16 or codes.data_ptr() % 16:
            raise ValueError("the kernel copies x and codes 16 bytes at a time: 16-byte "
                             "alignment")
        if N % TILE_N:
            raise ValueError(f"the kernel tiles N by {TILE_N} (N={N})")


# x, codes, scales, zeros (or null), out, workspace (or null); M, N, C,
# group, fmt, out_kind, splits
_P, _I = ctypes.c_void_p, ctypes.c_int
_launch = _build.c_launcher("dequant_matmul", "llmc_dequant_matmul", [_P] * 6 + [_I] * 7)


def dequant_matmul_codes(x_bf16, codes, scales, zeros: Optional[torch.Tensor], fmt: int,
                         out_dtype: torch.dtype):
    """B5 on flat codes: x (M, C) bf16, codes (N, C[/2]), scales / zeros
    (N, G) f32 -> (M, N) in ``out_dtype``. On the card K is split as
    :func:`split_plan` says; ``last_grid`` keeps the last launch's grid,
    (N tiles, M tiles, splits)."""
    _check(x_bf16, codes, scales, zeros, fmt, out_dtype)
    if not x_bf16.is_cuda:
        return dequant_matmul_plain(x_bf16, codes, scales, zeros, fmt, out_dtype)
    M, C = x_bf16.shape
    N, G = scales.shape
    out = torch.empty((M, N), dtype=out_dtype, device=x_bf16.device)
    g = C // G
    sms = torch.cuda.get_device_properties(x_bf16.device).multi_processor_count
    s = split_plan(M, N, C, g, fmt, sms)
    part = (torch.empty((s, M, N), dtype=torch.float32, device=x_bf16.device)
            if s > 1 else None)
    _launch(x_bf16.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            None if zeros is None else zeros.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            M, N, C, g, fmt, _OUT_KINDS[out_dtype], s)
    dequant_matmul_codes.launches += 1
    dequant_matmul_codes.last_grid = (N // TILE_N, -(-M // TILE_M), s)
    return out


dequant_matmul_codes.launches = 0
dequant_matmul_codes.last_grid = None


# ---------------------------------------------------------------------------
# Entry points used by the model
# ---------------------------------------------------------------------------


def dequant_matmul_dense(x: torch.Tensor, qt: QTensor, bias=None) -> torch.Tensor:
    """Materialize the dequantized weight, then a float32-accumulated
    matmul (JAX ``dequant_matmul_xla`` :304: the product in x's dtype with
    ``preferred_element_type=float32``). On the CPU both operands go to f32
    (bf16 products are exact there); on the card the product runs in x's
    dtype with cuBLAS's reductions in f32 (``full_f32_accumulation``), the
    matmul a dense weight of the same values gets."""
    w = dequantize(qt)
    if x.is_cuda:
        with full_f32_accumulation():
            y = torch.matmul(x, w.to(x.dtype).t())
    else:
        y = torch.matmul(x.float(), w.float().t()).to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def dequant_matmul(x: torch.Tensor, qt: QTensor, bias=None) -> torch.Tensor:
    """y = x @ W^T for x (..., C) and a packed (N, C) weight; x is cast to
    bf16 for the product (JAX :295, f32 x included) and y comes out in x's
    dtype, bias added after the product."""
    if not supported(qt):
        return dequant_matmul_dense(x, qt, bias)
    N, C, _ = dims(qt)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, C).to(torch.bfloat16).contiguous()
    out = dequant_matmul_codes(x2, qt.codes, qt.scales, qt.zeros, weight_format(qt), x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.reshape(*lead, N)
