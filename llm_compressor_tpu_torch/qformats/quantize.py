"""Quantizer specs and quantize/dequantize transforms (port of
``qformats/quantize.py``).

A quantizer is a frozen, hashable :class:`Quantizer` spec plus plain
functions over tensors. Integer formats follow the reference numerics: the
restrictive range +-7 / +-127, round-half-even value rounding, scales
clamped at ``SCALE_EPS``, math in float32 and the result cast back to the
input dtype. Float formats (``qtype="fp"``: fp8 e4m3 / e5m2, fp4 e2m1) scale
by absmax / max_norm (or a min-max midpoint zero point in the real domain)
and round through :func:`~.numerics.quantize_elemwise`. The MX / NVFP
solvers and the MSE clip search are not ported yet (ROADMAP.md, queue A
items 2 and 9).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from .blocking import BlockMeta, block, resolve_group, unblock
from .formats import ElemFormat, FormatParams, format_params
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

    def with_axes_flipped(self) -> "Quantizer":
        """Flip row/column orientation (the second matmul operand)."""
        gs = self.group_size
        if gs == -1:
            gs = -2
        elif gs == -2:
            gs = -1
        return replace(self, group_size=gs, axes=-1 if self.eff_axes == -2 else -2)


def _check_ported(q: Quantizer) -> None:
    if q.qtype not in ("int", "fp"):
        raise NotImplementedError(
            f"{q.qtype} quantizers are not ported yet: ROADMAP.md queue A item 2")


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
    reciprocal (one rounding more), eager JAX divides."""
    return x * (1.0 / c) if jitted else x / c


def _solve_int(q: Quantizer, max_val, min_val, jitted: bool):
    q_max = float(q.params.int_max)
    if q.zero_point:
        scales = torch.clamp_min(_div(max_val - min_val, 2.0 * q_max, jitted), SCALE_EPS)
        zeros = torch.round(-q_max - min_val / scales)
    else:
        scales = _div(max_val, q_max, jitted)
        zeros = torch.zeros_like(scales)
    return scales, zeros


def _solve_fp(q: Quantizer, max_val, min_val, jitted: bool):
    p = q.params
    if q.zero_point:
        scales = _div(max_val - min_val, 2.0 * p.max_norm, jitted)
        zeros = (max_val + min_val) / 2.0
    else:
        scales = _div(max_val, p.max_norm, jitted)
        zeros = torch.zeros_like(scales)
    return scales, zeros


_SOLVERS = {"int": _solve_int, "fp": _solve_fp}


def fake_quantize_blocked(q: Quantizer, xb, scales, zeros):
    """Quantize-dequantize a blocked array with given group params."""
    if q.qtype == "dummy":
        return xb
    _check_ported(q)
    if q.qtype == "fp":
        x32 = (xb.float() - zeros) / scales
        qv = quantize_elemwise(x32, q.params, round="nearest", saturate_normals=True)
        return (qv * scales + zeros).to(xb.dtype)
    q_max = float(q.params.int_max)
    qv = torch.clamp(torch.round(xb.float() / scales + zeros), -q_max, q_max)
    return ((qv - zeros) * scales).to(xb.dtype)


def find_params_blocked(q: Quantizer, xb, axes, jitted: bool = False):
    """Solve (scales, zeros) for an already-blocked array; reduce over
    ``axes``. ``jitted`` rounds the scales as the JAX package's jitted
    callers do (``quantize_dequant``, GPTQ); the default, as its eager ones
    (RTN's ``quantize_dequant_with_params``, ``quantize_pack``)."""
    _check_ported(q)
    max_val, min_val = _minmax(q, xb, axes)
    scales, zeros = _SOLVERS[q.qtype](q, max_val, min_val, jitted)
    return torch.clamp_min(scales, SCALE_EPS), zeros


def find_params(q: Quantizer, x, jitted: bool = False):
    """Per-group (scales, zeros) of raw ``x`` (blocked internally): shapes
    ``(N, G, 1)`` for an (N, C) weight with row-wise groups; scalars for
    per-tensor quantizers; (None, None) for the dummy quantizer. ``jitted``
    as for :func:`find_params_blocked`."""
    if q.qtype == "dummy":
        return None, None
    xb, meta, axes = block_for(q, x)
    if meta is None:
        _check_ported(q)
        max_val, min_val = _minmax(q, xb, None)
        scales, zeros = _SOLVERS[q.qtype](q, max_val, min_val, jitted)
        return torch.clamp_min(scales, SCALE_EPS), zeros
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
    x_dq = fake_quantize_blocked(q, xb, scales, zeros)
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
