"""W4A8 integer matmuls (port of ``kernels/w4a8_matmul.py``).

    y[m, n] = sx[m] * sum_g s_w[n, g] * (x_i8[m, g] . w[n, g])

Four wrappers, each with its own launch counter, over one CUDA kernel
family (``csrc/w4a8_matmul.cu``):

* :func:`matmul_stacked` — B1, one layer of stacked (L, N, C/2) codes;
* :func:`matmul_flat` — B3, unstacked codes, int4 or int8 weights;
* :func:`gateup_silu` — B2, fused [gate | up] + activation;
* :func:`matmul_actq` — B9, B3 with the per-token act quant on the card
  (raw bf16 / f32 acts in), reached through
  ``w4a8_matmul(..., act_inside=True)``.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain PyTorch version beside it (:func:`w4a8_plain`,
:func:`gateup_plain`), which sums in the same order as the kernel. The JAX
kernel's pair-planes path folds a +8 bias into the even groups' dots and
subtracts it after, so its f32 sums differ from these at the f32-ulp
level; the int32 per-group dots are exact in both.

All four run one int8 tensor-core core. On the card they split K over
whole groups (whole group pairs for int4 pair planes) when the output
tiles alone would leave SMs idle: :func:`split_plan` picks the number of
splits s with B5's rule, split z takes units [z U / s, (z + 1) U / s)
(:func:`split_bounds`), and the f32 sums of the splits are added in split
order before the act scale (B2: before its epilogue, per half).
``w4a8_plain(..., splits=s)`` and ``gateup_plain(..., splits=s)`` sum in
that order too, so B1/B3/B9 are bitwise equal to theirs at every split
count (B2 up to its f32 activation); with ``splits=1`` each is the unsplit
sum. B2's CTA takes 32 gate rows and the up rows of the same columns: 64
weight rows like the others', so its plan is the core's over the 2I rows
(its output tile is 128 x 32). B9 quantizes each row once (a kernel of
its own) into scratch codes, then runs the core.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..qformats.formats import ElemFormat
from ..qformats.qtensor import QTensor
from . import _build
from .dequant_matmul import plan_splits

W_INT8, W_PAIRS, W_HALVES = 0, 1, 2
_ACTS = {"silu": 1, "swish": 1, "gelu": 2, "gelu_python": 2,
         "gelu_new": 3, "gelu_pytorch_tanh": 3, "gelu_tanh": 3}


def quantize_acts_per_token(x: torch.Tensor):
    """Per-token symmetric int8 (int8-g[-1]-rw): codes (M, C) int8 and the
    (M, 1) f32 scale."""
    x32 = x.float()
    absmax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    # The JAX package runs this under ``jit``, where XLA turns the division
    # by 127 into a multiplication by its f32 reciprocal (PyTorch does the
    # same on CUDA, but divides on the CPU); the port writes the
    # multiplication out so that CPU, card and kernel B9 agree with it.
    # The division by the scale stays a true division.
    scale = torch.clamp_min(absmax * (1.0 / 127.0), 1e-5)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def weight_dims(qt: QTensor):
    """(N, C, g) from the array shapes; codes ([L,] N, C[/2]), scales
    ([L,] N, G)."""
    N, cp = qt.codes.shape[-2:]
    G = qt.scales.shape[-1]
    gp = cp // G
    g = 2 * gp if qt.fmt == ElemFormat.int4 else gp
    return N, G * g, g


def supported(qt: QTensor) -> bool:
    """The JAX kernel's eligibility predicate, kept so that the port routes
    each projection as the JAX package does."""
    q = qt.quantizer
    if q.eff_axes != -1 or len(qt.shape) != 2 or qt.codes.dim() not in (2, 3) \
            or q.zero_point:
        return False
    if not (q.qtype == "int" and q.fmt in (ElemFormat.int4, ElemFormat.int8)):
        return False
    N, C, g = weight_dims(qt)
    if qt.shape[-1] % g:
        return False
    return (C % g == 0 and g % 256 in (0, 128) and N % 128 == 0
            and C % 128 == 0 and g >= 128)


def gateup_silu_ok(qt: QTensor, act: str) -> bool:
    if act not in _ACTS or not supported(qt):
        return False
    N2, _, _ = weight_dims(qt)
    return N2 % 2 == 0 and any((N2 // 2) % t == 0 for t in (1024, 512, 256, 128))


def _wfmt(qt: QTensor) -> int:
    if qt.fmt == ElemFormat.int8:
        return W_INT8
    return W_PAIRS if qt.pair_planes else W_HALVES


# ---------------------------------------------------------------------------
# Split-K plan of the core (B1, B2, B3, B9)
# ---------------------------------------------------------------------------

TILE_M, TILE_N = 128, 64   # x rows and weight rows of one CTA (csrc/w4a8_matmul.cu TM, TN)


def split_units(C: int, g: int, wfmt: int) -> int:
    """What a split walks whole: groups, or group pairs for int4 pair
    planes (a byte holds one element of each group of its pair)."""
    G = C // g
    return G // 2 if wfmt == W_PAIRS else G


def split_bounds(units: int, splits: int):
    """The units [u0, u1) of each split, as the kernel cuts them: split z
    starts at floor(z * units / splits), so the splits differ by at most
    one unit."""
    return [(z * units // splits, (z + 1) * units // splits) for z in range(splits)]


def split_plan(M: int, N: int, C: int, g: int, wfmt: int, sms: int) -> int:
    """K-splits of a launch over N weight rows (B2: 2I): B5's rule
    (:func:`~.dequant_matmul.plan_splits`) over this kernel's tiles and
    units."""
    tiles = -(-M // TILE_M) * -(-N // TILE_N)
    return plan_splits(tiles, split_units(C, g, wfmt), sms)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _int_weights(codes: torch.Tensor, G: int, wfmt: int) -> torch.Tensor:
    """(N, C) signed int8 weight values from flat codes."""
    N = codes.shape[0]
    if wfmt == W_INT8:
        return codes
    gp = codes.shape[1] // G
    if wfmt == W_PAIRS:
        pb = codes.reshape(N, G // 2, 2 * gp)
        vals = torch.stack([pb & 0x0F, pb >> 4], dim=2).reshape(N, G, 2 * gp)
    else:
        cb = codes.reshape(N, G, gp)
        vals = torch.cat([cb & 0x0F, cb >> 4], dim=2)
    return (vals.to(torch.int16) - 8).to(torch.int8).reshape(N, -1)


def _scaled_sum(x_i8, codes, scales, wfmt, splits: int = 1):
    """sum_g float(x_g . w_g) * s_w[:, g], f32 (M, N): each split's groups
    (:func:`split_bounds`) in group order from zero, then the splits' sums
    in split order."""
    M, C = x_i8.shape
    N, G = scales.shape
    g = C // G
    w = _int_weights(codes, G, wfmt)
    # integer dots are exact in the float type while |sum| < 2^24 (f32) —
    # always true for g <= 1024 at 8-bit operands; float64 beyond
    ft = torch.float32 if g <= 1024 else torch.float64
    xf, wf = x_i8.to(ft), w.to(ft)
    units = split_units(C, g, wfmt)
    per = G // units   # groups per unit
    total = None
    for u0, u1 in split_bounds(units, splits):
        acc = torch.zeros((M, N), dtype=torch.float32, device=x_i8.device)
        for gi in range(u0 * per, u1 * per):
            part = (xf[:, gi * g:(gi + 1) * g] @ wf[:, gi * g:(gi + 1) * g].T).float()
            acc = acc + part * scales[:, gi]
        total = acc if total is None else total + acc
    return total


def w4a8_plain(x_i8, codes, scales, sx, wfmt: int, out_dtype: torch.dtype, splits: int = 1):
    """Plain version of B1/B3: (M, N) in ``out_dtype``, K summed in
    ``splits`` splits as the kernel sums it."""
    return (_scaled_sum(x_i8, codes, scales, wfmt, splits) * sx).to(out_dtype)


def _activation(act: str, g: torch.Tensor) -> torch.Tensor:
    code = _ACTS[act]
    if code == 1:
        return F.silu(g)
    return F.gelu(g, approximate="none" if code == 2 else "tanh")


def gateup_plain(x_i8, codes, scales, sx, wfmt: int, act: str,
                 out_dtype: torch.dtype, splits: int = 1):
    """Plain version of B2: codes hold [gate | up] rows; returns (M, I).
    Each half is summed in ``splits`` splits as the kernel sums it, scaled
    by sx and rounded through ``out_dtype``; act(g) * u in f32, rounded
    once."""
    I = codes.shape[0] // 2
    g = (_scaled_sum(x_i8, codes[:I], scales[:I], wfmt, splits) * sx).to(out_dtype).float()
    u = (_scaled_sum(x_i8, codes[I:], scales[I:], wfmt, splits) * sx).to(out_dtype).float()
    return (_activation(act, g) * u).to(out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_weights(x, codes, scales, wfmt, out_dtype, tensors):
    """Checks shared by every wrapper; ``tensors`` are all the inputs."""
    if x.dim() != 2:
        raise ValueError("x must be a 2-D tensor")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported out dtype {out_dtype}")
    if scales.dtype != torch.float32:
        raise ValueError("scales must be float32")
    want = torch.int8 if wfmt == W_INT8 else torch.uint8
    if codes.dtype != want:
        raise ValueError(f"codes must be {want} for format {wfmt}")
    M, C = x.shape
    N, G = scales.shape[-2:]
    if C % G or (C // G) % 128:
        raise ValueError(f"group size must be a multiple of 128 (C={C}, G={G})")
    if wfmt == W_PAIRS and G % 2:
        raise ValueError("pair-planes codes need an even group count")
    if codes.shape[-2:] != (N, C if wfmt == W_INT8 else C // 2):
        raise ValueError(f"codes shape {tuple(codes.shape)} does not match (N={N}, C={C})")
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    if x.is_cuda:
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("kernel inputs must be contiguous")
        if x.data_ptr() % 16 or codes.data_ptr() % 16:
            raise ValueError("the kernel loads x and codes 16 bytes at a time: "
                             "their data must be 16-byte aligned")


def _check(x_i8, codes, scales, sx, wfmt, out_dtype):
    if x_i8.dtype != torch.int8:
        raise ValueError("x_i8 must be a 2-D int8 tensor")
    if sx.dtype != torch.float32:
        raise ValueError("scales and sx must be float32")
    _check_weights(x_i8, codes, scales, wfmt, out_dtype, (x_i8, codes, scales, sx))
    if sx.numel() != x_i8.shape[0]:
        raise ValueError("sx must hold one scale per row")


# x, w, scales, sx, out, workspace (or null); M, N, C, group, wfmt, out_bf16, splits
_P, _I = ctypes.c_void_p, ctypes.c_int
_matmul_launch = _build.c_launcher("w4a8_matmul", "llmc_w4a8_matmul", [_P] * 6 + [_I] * 7)
# x, w, scales, sx, out, workspace (or null); M, I, C, group, wfmt, out_bf16, act, splits
_gateup_launch = _build.c_launcher("w4a8_matmul", "llmc_w4a8_gateup", [_P] * 6 + [_I] * 8)
# x, w, scales, act codes, act scales, out, workspace (or null); M, N, C,
# group, wfmt, out_bf16, x_bf16, splits
_actq_launch = _build.c_launcher("w4a8_matmul", "llmc_w4a8_matmul_actq", [_P] * 7 + [_I] * 8)


def _plan(x, scales, wfmt: int, splits: Optional[int]) -> int:
    """The split count of a call on x (M, C) and scales (N, G): the
    caller's ``splits`` (1 to the unit count), else :func:`split_plan` for
    the card's SMs (1 on the CPU)."""
    (M, C), (N, G) = x.shape, scales.shape
    g = C // G
    if splits is not None:
        units = split_units(C, g, wfmt)
        if not 1 <= splits <= units:
            raise ValueError(f"splits must lie in [1, {units}] (the K units), not {splits}")
        return splits
    if not x.is_cuda:
        return 1
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return split_plan(M, N, C, g, wfmt, sms)


def _launch(wrapper, launcher, ptrs, x, scales, wfmt, out_dtype, splits, tail=(),
            fused: bool = False):
    """Allocate the output (and the split workspace), launch, count, and
    keep the grid on ``wrapper.last_grid``: (N tiles, M tiles, splits).
    ``fused``: B2, whose N = 2I weight rows give I output columns."""
    (M, C), (N, G) = x.shape, scales.shape
    n_out = N // 2 if fused else N
    s = _plan(x, scales, wfmt, splits)
    out = torch.empty((M, n_out), dtype=out_dtype, device=x.device)
    part = torch.empty((s, M, N), dtype=torch.float32, device=x.device) if s > 1 else None
    launcher(*ptrs, out.data_ptr(), None if part is None else part.data_ptr(), M, n_out, C,
             C // G, wfmt, int(out_dtype == torch.bfloat16), *tail, s)
    wrapper.launches += 1
    wrapper.last_grid = (-(-N // TILE_N), -(-M // TILE_M), s)
    return out


def matmul_stacked(x_i8, codes, scales, sx, layer: int, wfmt: int,
                   out_dtype: torch.dtype, splits: Optional[int] = None):
    """B1: layer ``layer`` of stacked codes (L, N, C[/2]) / scales (L, N, G).
    The kernel reads the layer in place from the stacked buffers. K is
    split as :func:`split_plan` says, or in ``splits`` splits."""
    _check(x_i8, codes, scales, sx, wfmt, out_dtype)
    if codes.dim() != 3 or not 0 <= layer < codes.shape[0]:
        raise ValueError("matmul_stacked needs stacked codes and a valid layer")
    cl, sl = codes[layer], scales[layer]
    if not x_i8.is_cuda:
        return w4a8_plain(x_i8, cl, sl, sx, wfmt, out_dtype,
                          splits=_plan(x_i8, sl, wfmt, splits))
    return _launch(matmul_stacked, _matmul_launch,
                   (x_i8.data_ptr(), cl.data_ptr(), sl.data_ptr(), sx.data_ptr()),
                   x_i8, sl, wfmt, out_dtype, splits)


matmul_stacked.launches = 0
matmul_stacked.last_grid = None


def matmul_flat(x_i8, codes, scales, sx, wfmt: int, out_dtype: torch.dtype,
                splits: Optional[int] = None):
    """B3: unstacked codes (N, C[/2]) / scales (N, G); ``splits`` as for
    :func:`matmul_stacked`."""
    _check(x_i8, codes, scales, sx, wfmt, out_dtype)
    if codes.dim() != 2:
        raise ValueError("matmul_flat needs 2-D codes")
    if not x_i8.is_cuda:
        return w4a8_plain(x_i8, codes, scales, sx, wfmt, out_dtype,
                          splits=_plan(x_i8, scales, wfmt, splits))
    return _launch(matmul_flat, _matmul_launch,
                   (x_i8.data_ptr(), codes.data_ptr(), scales.data_ptr(), sx.data_ptr()),
                   x_i8, scales, wfmt, out_dtype, splits)


matmul_flat.launches = 0
matmul_flat.last_grid = None


def gateup_silu(x_i8, codes, scales, sx, layer: int, wfmt: int, act: str,
                out_dtype: torch.dtype, splits: Optional[int] = None):
    """B2: fused [gate | up] of stacked codes (L, 2I, C[/2]) + activation,
    (M, I) out, read in place from the stacked buffers. ``splits`` as for
    :func:`matmul_stacked`; one launch count per call, the split-K reduce
    included."""
    _check(x_i8, codes, scales, sx, wfmt, out_dtype)
    if codes.dim() != 3 or not 0 <= layer < codes.shape[0] or codes.shape[1] % 2:
        raise ValueError("gateup_silu needs stacked [gate | up] codes and a valid layer")
    if act not in _ACTS:
        raise ValueError(f"unsupported activation {act!r}")
    cl, sl = codes[layer], scales[layer]
    if not x_i8.is_cuda:
        return gateup_plain(x_i8, cl, sl, sx, wfmt, act, out_dtype,
                            splits=_plan(x_i8, sl, wfmt, splits))
    return _launch(gateup_silu, _gateup_launch,
                   (x_i8.data_ptr(), cl.data_ptr(), sl.data_ptr(), sx.data_ptr()),
                   x_i8, sl, wfmt, out_dtype, splits, tail=(_ACTS[act],), fused=True)


gateup_silu.launches = 0
gateup_silu.last_grid = None


def actq_plain(x, codes, scales, wfmt: int, out_dtype: torch.dtype, splits: int = 1):
    """Plain version of B9: :func:`quantize_acts_per_token`, then B3's."""
    x_i8, sx = quantize_acts_per_token(x)
    return w4a8_plain(x_i8, codes, scales, sx, wfmt, out_dtype, splits=splits)


def matmul_actq(x, codes, scales, wfmt: int, out_dtype: torch.dtype,
                splits: Optional[int] = None):
    """B9: raw acts x (M, C) bf16 or f32, per-token int8 quantized on the
    card (each row once, into scratch codes and scales), times unstacked
    codes (N, C[/2]) / scales (N, G); ``splits`` as for
    :func:`matmul_stacked`. One launch count per call."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("x must be bfloat16 or float32")
    _check_weights(x, codes, scales, wfmt, out_dtype, (x, codes, scales))
    if codes.dim() != 2:
        raise ValueError("matmul_actq needs 2-D codes")
    if not x.is_cuda:
        return actq_plain(x, codes, scales, wfmt, out_dtype, splits=_plan(x, scales, wfmt, splits))
    M, C = x.shape
    xq = torch.empty((M, C), dtype=torch.int8, device=x.device)
    sxq = torch.empty((M,), dtype=torch.float32, device=x.device)
    return _launch(matmul_actq, _actq_launch,
                   (x.data_ptr(), codes.data_ptr(), scales.data_ptr(), xq.data_ptr(),
                    sxq.data_ptr()),
                   x, scales, wfmt, out_dtype, splits, tail=(int(x.dtype == torch.bfloat16),))


matmul_actq.launches = 0
matmul_actq.last_grid = None


# ---------------------------------------------------------------------------
# Entry points used by the model
# ---------------------------------------------------------------------------


def w4a8_matmul(x: torch.Tensor, qt: QTensor, bias=None,
                layer: Optional[int] = None, act_inside: bool = False) -> torch.Tensor:
    """y = act_q(x) @ W^T with per-token int8 acts. ``layer`` selects one
    layer of a stacked QTensor (B1); without it the weights are flat (B3),
    or, with ``act_inside``, the act quantizer runs inside the kernel (B9,
    flat weights only)."""
    N, C, g = weight_dims(qt)
    lead = x.shape[:-1]
    if act_inside:
        if layer is not None:
            raise ValueError("act_inside applies to flat weights, not to a stacked layer")
        out = matmul_actq(x.reshape(-1, C).contiguous(), qt.codes, qt.scales, _wfmt(qt),
                          x.dtype)
    else:
        x_i8, sx = quantize_acts_per_token(x.reshape(-1, C))
        if layer is not None:
            out = matmul_stacked(x_i8, qt.codes, qt.scales, sx, layer, _wfmt(qt), x.dtype)
        else:
            out = matmul_flat(x_i8, qt.codes, qt.scales, sx, _wfmt(qt), x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.reshape(*lead, N)


def gateup_silu_matmul(x: torch.Tensor, qt: QTensor, act: str, layer: int):
    """h = act(x @ Wg^T) * (x @ Wu^T) over the stacked fused gateup QTensor."""
    N2, C, g = weight_dims(qt)
    lead = x.shape[:-1]
    x_i8, sx = quantize_acts_per_token(x.reshape(-1, C))
    out = gateup_silu(x_i8, qt.codes, qt.scales, sx, layer, _wfmt(qt), act, x.dtype)
    return out.reshape(*lead, N2 // 2)
