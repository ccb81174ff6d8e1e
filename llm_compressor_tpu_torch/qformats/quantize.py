"""Quantizer specs and quantize/dequantize transforms (port of
``qformats/quantize.py``).

A quantizer is a frozen, hashable :class:`Quantizer` spec plus plain
functions over tensors. Integer formats follow the reference numerics: the
restrictive range +-7 / +-127, round-half-even value rounding, scales
clamped at ``SCALE_EPS``, math in float32 and the result cast back to the
input dtype. Float formats (``qtype="fp"``: fp8 e4m3 / e5m2, fp4 e2m1) scale
by absmax / max_norm (or a min-max midpoint zero point in the real domain)
and round through :func:`~.numerics.quantize_elemwise`. MX scales are powers
of two, ``2**(floor(log2(absmax)) - emax)`` clipped to the 8-bit scale
exponent range; NVFP4 scales are fp8 e4m3 group scales times one f32 scale,
``absmax / (448 * 6)`` over the whole tensor. ``mse=True`` refines any of
them with the MSE clip search: p = 1 - i/100 for i in [0, 80), scored by
``sum |qdq(x) - x|**2.4`` per group.

Every solver takes ``jitted``: the JAX package runs some callers under
``jax.jit``, where XLA turns a division by a constant into a product with
its f32 reciprocal, and others eagerly. The MSE search runs inside a
``lax.fori_loop``, which XLA compiles whoever calls it, and its first
candidate (p = 1) always replaces the eager solve: so it solves with the
jitted rounding for every caller.

The MX exponent is taken exactly (``frexp``) and the power of two built from
its bits, where the JAX package takes ``floor(log2(.))`` and ``exp2``, which
its CPU backend computes inexactly at some integers (ROADMAP.md queue C).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from .blocking import BlockMeta, block, resolve_group, unblock
from .formats import FP32_MIN_NORMAL, ElemFormat, FormatParams, format_params
from .numerics import quantize_elemwise

SCALE_EPS = 1e-5


@dataclass(frozen=True)
class Quantizer:
    """Static description of a quantization scheme.

    qtype: "dummy" | "int" | "fp" | "mx" | "nvfp"
    group_size: 0 per-tensor, -1 per-token, -2 per-channel, >0 per-group
    axes: -1 row-wise, -2 column-wise (which axis groups run along)
    """

    qtype: str = "dummy"
    fmt: Optional[ElemFormat] = None
    group_size: int = -1
    axes: int = -1
    zero_point: bool = False
    mse: bool = False
    scale_ebits: int = 8  # MX shared-scale exponent bits

    def __post_init__(self):
        if self.qtype not in ("dummy", "int", "fp", "mx", "nvfp"):
            raise ValueError(f"Unknown qtype {self.qtype!r}")
        if self.qtype == "int" and self.fmt not in (ElemFormat.int4, ElemFormat.int8):
            raise ValueError(f"INT quantizer requires int4/int8, got {self.fmt}")
        if self.qtype == "fp" and self.fmt not in (
                ElemFormat.fp4_e2m1, ElemFormat.fp8_e4m3, ElemFormat.fp8_e5m2):
            raise ValueError(f"FP quantizer requires an fp format, got {self.fmt}")
        if self.qtype == "nvfp" and self.fmt != ElemFormat.fp4_e2m1:
            raise ValueError("NVFP quantizer supports fp4_e2m1 only")

    @property
    def eff_axes(self) -> int:
        """Per-token forces row-wise, per-channel forces column-wise."""
        if self.group_size == -1:
            return -1
        if self.group_size == -2:
            return -2
        return self.axes

    @property
    def params(self) -> FormatParams:
        return format_params(self.fmt)

    @property
    def bits(self) -> int:
        return 16 if self.qtype == "dummy" else self.fmt.bits

    def with_axes_flipped(self) -> "Quantizer":
        """Flip row/column orientation (the second matmul operand)."""
        gs = self.group_size
        if gs == -1:
            gs = -2
        elif gs == -2:
            gs = -1
        return replace(self, group_size=gs, axes=-1 if self.eff_axes == -2 else -2)


def _minmax(q: Quantizer, xb: torch.Tensor, axes):
    if axes is None:
        dims, keep = tuple(range(xb.dim())), False
    else:
        dims, keep = (axes,), True
    if q.zero_point:
        max_val = torch.amax(xb, dim=dims, keepdim=keep)
        min_val = torch.amin(xb, dim=dims, keepdim=keep)
    else:
        max_val = torch.amax(torch.abs(xb), dim=dims, keepdim=keep)
        min_val = -max_val
    return max_val.float(), min_val.float()


def _div(x, c: float, jitted: bool):
    """``x / c`` for a constant ``c``, rounded as the JAX package rounds it:
    under ``jax.jit`` XLA rewrites the division into a product with the f32
    reciprocal (one rounding more), eager JAX divides. The eager divisor is
    a tensor on ``x``'s device: PyTorch's CUDA kernels turn a division by a
    Python number into that same product."""
    if jitted:
        return x * (1.0 / c)
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _fma(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (a fused multiply-add) for f32
    values: their f64 product is exact, and the f64 sum rounds only where
    the terms lie more than 29 binary orders apart."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    return (a * b.double() + c.double()).float()


# In the MSE search each candidate solves at (p * max, p * min). XLA's CPU
# backend fuses the loop body and LLVM contracts some of its products and
# sums into fused multiply-adds; the ``p`` branches below round as it does
# (measured bitwise against the JAX package, tests/test_torch_formats.py).


def _span(max_val, min_val, p):
    """max - min; in the search fma(p, max, -(p * min))."""
    return max_val - min_val if p is None else _fma(p, max_val, -(p * min_val))


def _mid(max_val, min_val, p):
    """(max + min) / 2; in the search fma(p, max, p * min) / 2."""
    return (max_val + min_val) / 2.0 if p is None else _fma(p, max_val, p * min_val) / 2.0


def _scaled(v, p):
    return v if p is None else p * v


def _solve_int(q: Quantizer, max_val, min_val, jitted: bool, p=None):
    q_max = float(q.params.int_max)
    if q.zero_point:
        scales = torch.clamp_min(_div(_span(max_val, min_val, p), 2.0 * q_max, jitted),
                                 SCALE_EPS)
        zeros = torch.round(-q_max - _scaled(min_val, p) / scales)
    else:
        scales = _div(_scaled(max_val, p), q_max, jitted)
        zeros = torch.zeros_like(scales)
    return scales, zeros


def _solve_fp(q: Quantizer, max_val, min_val, jitted: bool, p=None):
    fp = q.params
    if q.zero_point:
        scales = _div(_span(max_val, min_val, p), 2.0 * fp.max_norm, jitted)
        zeros = _mid(max_val, min_val, p)
    else:
        scales = _div(_scaled(max_val, p), fp.max_norm, jitted)
        zeros = torch.zeros_like(scales)
    return scales, zeros


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exactly 2**e for integer-valued f32 ``e`` in [-127, 128] (128 gives
    inf), built from the f32 bits; NaN stays NaN."""
    ei = torch.nan_to_num(e, nan=0.0).to(torch.int32)
    bits = torch.where(ei > -127, (ei + 127) << 23, torch.full_like(ei, 1 << 22))
    return torch.where(torch.isnan(e), e, bits.view(torch.float32))


def _absmax_zeros(q: Quantizer, max_val, min_val, p):
    """(absmax, zeros) of the MX / NVFP solvers: a real-domain midpoint
    zero point, or none. In the search the absmax subtracts a midpoint
    that XLA contracts the other way, fma(p, min, p * max) / 2."""
    if not q.zero_point:
        absmax = _scaled(max_val, p)
        return absmax, torch.zeros_like(absmax)
    zeros = _mid(max_val, min_val, p)
    if p is None:
        return max_val - zeros, zeros
    return p * max_val - _mid(min_val, max_val, p), zeros


def _solve_mx(q: Quantizer, max_val, min_val, jitted: bool, p=None):
    fp = q.params
    scale_emax = 2 ** (q.scale_ebits - 1) - 1
    absmax, zeros = _absmax_zeros(q, max_val, min_val, p)
    safe = absmax + FP32_MIN_NORMAL * (absmax == 0).float()
    exact = (torch.frexp(safe).exponent - 1).float()
    shared_exp = torch.where(torch.isfinite(safe), exact, torch.log2(safe)) - fp.emax
    shared_exp = torch.where(shared_exp > scale_emax,
                             torch.full_like(shared_exp, scale_emax + 1), shared_exp)
    shared_exp = torch.clamp_min(shared_exp, -scale_emax)
    return _pow2(shared_exp), zeros


def _solve_nvfp(q: Quantizer, max_val, min_val, jitted: bool, p=None):
    fp = q.params
    sp = format_params(ElemFormat.fp8_e4m3)
    absmax, zeros = _absmax_zeros(q, max_val, min_val, p)
    global_absmax = torch.amax(torch.abs(absmax))
    fp32_scale = torch.clamp_min(_div(global_absmax, sp.max_norm * fp.max_norm, jitted), 1e-12)
    group_scaled = absmax / (fp32_scale * fp.max_norm)
    fp8_scales = quantize_elemwise(group_scaled, sp, round="nearest")
    return fp8_scales * fp32_scale, zeros


_SOLVERS = {"int": _solve_int, "fp": _solve_fp, "mx": _solve_mx, "nvfp": _solve_nvfp}


def fake_quantize_blocked(q: Quantizer, xb, scales, zeros, jitted: bool = False):
    """Quantize-dequantize a blocked array with given group params. Under
    ``jax.jit`` the fp, MX and NVFP formats' ``value * scale + zero`` is
    one fused multiply-add; ``jitted`` rounds it so (with a zero point: a
    zero zero point adds nothing either way)."""
    if q.qtype == "dummy":
        return xb
    if q.qtype != "int":
        x32 = (xb.float() - zeros) / scales
        qv = quantize_elemwise(x32, q.params, round="nearest", saturate_normals=True)
        dq = _fma(qv, scales, zeros) if jitted and q.zero_point else qv * scales + zeros
        return dq.to(xb.dtype)
    q_max = float(q.params.int_max)
    qv = torch.clamp(torch.round(xb.float() / scales + zeros), -q_max, q_max)
    return ((qv - zeros) * scales).to(xb.dtype)


def _mse_clip(q: Quantizer, xb, max_val, min_val, scales, zeros, axes,
              norm: float = 2.4, grid: int = 100, maxshrink: float = 0.8):
    """The clip-range grid search: solve at p * (max, min) for p = 1 - i/grid,
    i in [0, maxshrink * grid), and keep per group the candidate of least
    ``sum |qdq(x) - x|**norm``; a later candidate wins only if strictly
    smaller. Jitted rounding throughout (see the module doc); p is
    ``fma(-i, f32(1/grid), 1)``, as XLA computes ``1 - i/grid``."""
    solver = _SOLVERS[q.qtype]
    x32 = xb.float()
    dims = tuple(range(x32.dim())) if axes is None else (axes,)
    keep = axes is not None
    best = torch.full_like(scales, float("inf"))
    step = float(torch.tensor(1.0 / grid, dtype=torch.float32))
    for i in range(int(maxshrink * grid)):
        p = float(torch.tensor(1.0 - i * step, dtype=torch.float32))
        s1, z1 = solver(q, max_val, min_val, True, p)
        dq = fake_quantize_blocked(q, x32, s1, z1, jitted=True)
        e = torch.sum(torch.abs(dq - x32) ** norm, dim=dims, keepdim=keep)
        take = e < best
        best = torch.where(take, e, best)
        scales = torch.where(take, s1, scales)
        zeros = torch.where(take, z1, zeros)
    return scales, zeros


def find_params_blocked(q: Quantizer, xb, axes, jitted: bool = False):
    """Solve (scales, zeros) for an already-blocked array; reduce over
    ``axes`` (all of them when None: per tensor). ``jitted`` rounds the
    scales as the JAX package's jitted callers do (``quantize_dequant``,
    GPTQ); the default, as its eager ones (RTN's
    ``quantize_dequant_with_params``, ``quantize_pack``). The MSE search
    rounds as jitted in both (module doc)."""
    max_val, min_val = _minmax(q, xb, axes)
    scales, zeros = _SOLVERS[q.qtype](q, max_val, min_val, jitted)
    if q.mse:
        scales, zeros = _mse_clip(q, xb, max_val, min_val, scales, zeros, axes)
    return torch.clamp_min(scales, SCALE_EPS), zeros


def find_params(q: Quantizer, x, jitted: bool = False):
    """Per-group (scales, zeros) of raw ``x`` (blocked internally): shapes
    ``(N, G, 1)`` for an (N, C) weight with row-wise groups; scalars for
    per-tensor quantizers; (None, None) for the dummy quantizer. ``jitted``
    as for :func:`find_params_blocked`."""
    if q.qtype == "dummy":
        return None, None
    xb, _, axes = block_for(q, x)
    return find_params_blocked(q, xb, axes, jitted)


def block_for(q: Quantizer, x) -> tuple[torch.Tensor, Optional[BlockMeta], Optional[int]]:
    """Block ``x`` per the quantizer's group config. Per-tensor returns
    (x, None, None)."""
    group, axes = resolve_group(q.group_size, q.eff_axes, x.shape)
    if group == 0:
        return x, None, None
    xb, meta = block(x, group, axes)
    return xb, meta, axes


def _qdq(q: Quantizer, x, jitted: bool):
    if q.qtype == "dummy":
        return x, (None, None)
    xb, meta, axes = block_for(q, x)
    scales, zeros = find_params_blocked(q, xb, axes, jitted)
    x_dq = fake_quantize_blocked(q, xb, scales, zeros, jitted)
    if meta is not None:
        x_dq = unblock(x_dq, meta)
    return x_dq, (scales, zeros)


def quantize_dequant_with_params(q: Quantizer, x):
    """Block -> solve params -> quantize-dequantize -> unblock; also
    returns the solved params. Eager rounding, as the JAX function (RTN
    calls it outside ``jit``)."""
    return _qdq(q, x, jitted=False)


def quantize_dequant(q: Quantizer, x):
    """Full fake quantization with the group statistics solved per call
    (dynamic activation quantization). Jitted rounding, as the JAX
    function, which is ``@jax.jit``."""
    return _qdq(q, x, jitted=True)[0]
