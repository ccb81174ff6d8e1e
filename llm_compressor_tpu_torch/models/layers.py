"""Primitive layer ops (port of ``models/layers.py``).

Norms (RMSNorm, LayerNorm), activations, rotary embeddings with llama3
scaling, BLOOM's ALiBi slopes, and the quantization-aware linear / matmul
ops. Weights use the (out_features, in_features) orientation; they arrive
as plain tensors, packed :class:`~..qformats.QTensor` or a
:class:`LayerSlice` of a stacked one.

:func:`qlinear` keeps the JAX package's routing so that numbers match:
* a LayerSlice with int8 per-token acts and M <= 256 rows -> the stacked
  W4A8 kernel (B1); any other LayerSlice is taken as its layer's QTensor
  (a view);
* a QTensor with int8 per-token acts and (M <= 256 or C/g <= 16) -> the
  flat W4A8 kernel (B3);
* otherwise the acts are quantized as configured, then M > 256 rows
  (prefill) -> plain dequantization + torch.matmul, and M <= 256 -> the
  dequantize-in-kernel matmul (B5; weight-only serving).
The thresholds were measured on a TPU; re-tuning them for the H100 is
later work (ROADMAP.md).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import dequant_matmul as dm
from ..kernels import w4a8_matmul as wm
from ..qformats import ElemFormat, QTensor, Quantizer, dequantize, quantize_dequant
from ..qformats.config import OpQuantConfig
from .config import RopeScaling


def rms_norm(x, weight, eps: float, plus_one: bool = False):
    """RMSNorm in float32; with ``plus_one`` (Gemma) the weight is applied
    as ``1 + w``, added in float32 after the normalisation."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (x32 * w).to(x.dtype)


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm in float32 (the mean, then the biased variance of the
    centred values), weight and bias added in float32."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    d = x32 - mu
    out = d * torch.rsqrt(torch.mean(d * d, dim=-1, keepdim=True) + eps)
    out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def apply_norm(cfg, x, p):
    """The model's norm given a param dict {'weight': w[, 'bias': b]}."""
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, p["weight"], cfg.rms_norm_eps, cfg.norm_weight_plus_one)
    return layer_norm(x, p["weight"], p.get("bias"), cfg.rms_norm_eps)


def activation(name: str, x):
    if name in ("silu", "swish"):
        return F.silu(x)
    if name in ("gelu", "gelu_python"):
        return F.gelu(x, approximate="none")
    if name in ("gelu_new", "gelu_pytorch_tanh", "gelu_tanh"):
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"Unknown activation {name}")


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def rope_inv_freq(dim: int, theta: float, scaling: Optional[RopeScaling],
                  device=None) -> torch.Tensor:
    """Inverse frequencies with llama3-style rescaling (HF 'llama3')."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    inv = 1.0 / (theta ** exps)
    if scaling is None or scaling.kind == "default":
        return inv
    if scaling.kind == "linear":
        return inv / scaling.factor
    if scaling.kind == "llama3":
        low = scaling.original_max_position / scaling.low_freq_factor
        high = scaling.original_max_position / scaling.high_freq_factor
        wavelen = 2.0 * math.pi / inv
        smooth = (scaling.original_max_position / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor)
        mid = (1 - smooth) * inv / scaling.factor + smooth * inv
        return torch.where(wavelen > low, inv / scaling.factor,
                           torch.where(wavelen < high, inv, mid))
    raise ValueError(f"Unsupported rope scaling {scaling.kind}")


def rope_cos_sin(positions, inv_freq):
    """positions (B, T) int -> cos/sin (B, T, rot_dim) f32."""
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x, cos, sin):
    """HF rotate-half convention. x: (B, T, H, D); cos/sin: (B, T, D)."""
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * c + rotated * s


@functools.lru_cache(maxsize=None)
def alibi_slopes(n_heads: int, device) -> torch.Tensor:
    """HF BLOOM's slopes, (H,) f32 on ``device``: powers of 2^(-8/n), with
    the odd-head interleave for a head count that is not a power of two
    (JAX :134-146, single-device form). Made once per (head count,
    device): inside a decode they are a tensor already on the card (a copy
    from the host would refuse a CUDA graph's capture)."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    powers = [base ** (i + 1) for i in range(closest)]
    if closest != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        n_rem = min(closest, n_heads - closest)
        powers += [extra_base ** (2 * i + 1) for i in range(n_rem)]
    return torch.tensor(powers, dtype=torch.float32, device=device)


def alibi_bias(n_heads: int, kv_positions: torch.Tensor) -> torch.Tensor:
    """(H, 1, S) f32 additive bias: slope_h * kv_position (JAX :149-161)."""
    slopes = alibi_slopes(n_heads, kv_positions.device)
    return slopes[:, None, None] * kv_positions[None, None, :].float()


def maybe_quant(q: Optional[Quantizer], x):
    if q is None or q.qtype == "dummy":
        return x
    return quantize_dequant(q, x)


class LayerSlice:
    """One layer's view into a stacked packed weight: ``qt`` holds stacked
    arrays (codes (L, N, C[/2]), scales (L, N, G)) and ``layer`` is the
    index. The stacked kernel reads the layer in place."""

    __slots__ = ("qt", "layer")

    def __init__(self, qt: QTensor, layer: int):
        self.qt = qt
        self.layer = layer

    def materialize(self) -> QTensor:
        return self.qt.layer(self.layer)


def int8_per_token(ai: Optional[Quantizer]) -> bool:
    """Symmetric int8 per-token quantizer: the W4A8 kernels' act format."""
    return (ai is not None and ai.qtype == "int" and ai.fmt == ElemFormat.int8
            and ai.group_size == -1 and not ai.zero_point)


def _groups(qt: QTensor) -> int:
    """C / g: the number of K groups of a packed weight."""
    _, C, g = wm.weight_dims(qt)
    return C // g


def qlinear(x, weight, bias=None, op: Optional[OpQuantConfig] = None):
    """y = act_out_q( act_in_q(x) @ W^T + b ), routed as the module doc says."""
    ai = op.act_in if op is not None else None
    m_rows = math.prod(x.shape[:-1])
    layer = None
    if isinstance(weight, LayerSlice):
        if int8_per_token(ai) and m_rows <= 256 and wm.supported(weight.qt):
            weight, layer = weight.qt, weight.layer
        else:
            weight = weight.materialize()

    if isinstance(weight, QTensor):
        if layer is not None:
            y = wm.w4a8_matmul(x, weight, bias, layer=layer)
        elif int8_per_token(ai) and wm.supported(weight) and (
                m_rows <= 256 or _groups(weight) <= 16):
            y = wm.w4a8_matmul(x, weight, bias)
        else:
            x = maybe_quant(ai, x)
            if m_rows > 256:
                # prefill: one dequantization feeds a plain matmul (float32
                # accumulation in both backends), as the JAX package leaves
                # it to XLA
                w = dequantize(weight).to(x.dtype)
                y = torch.matmul(x, w.t())
                if bias is not None:
                    y = y + bias.to(y.dtype)
            else:
                y = dm.dequant_matmul(x, weight, bias)
    else:
        x = maybe_quant(ai, x)
        y = torch.matmul(x, weight.t())
        if bias is not None:
            y = y + bias.to(y.dtype)
    if op is not None:
        y = maybe_quant(op.act_out, y)
    return y


def qmatmul_qk(q4, k4t, op: Optional[OpQuantConfig] = None):
    """scores = out_q( in1_q(Q) @ in2_q(K^T) ); Q (B, H, T, D), K^T
    (B, H, D, S). The second operand's quantizer runs row-wise over its
    last axis."""
    if op is not None:
        q4 = maybe_quant(op.act_in, q4)
        q2 = op.act_in
        if q2.qtype != "dummy":
            q2 = q2.with_axes_flipped() if q2.eff_axes == -2 else q2
            k4t = quantize_dequant(q2, k4t)
    s = torch.einsum("bhtd,bhds->bhts", q4.float(), k4t.float())
    if op is not None:
        s = maybe_quant(op.act_out, s.to(q4.dtype)).float()
    return s


def qmatmul_sv(probs, v4, op: Optional[OpQuantConfig] = None):
    """out = out_q( in1_q(S) @ in2_q(V) ); S (B, H, T, S), V (B, H, S, D).
    V is quantized column-wise (per channel over the sequence axis)."""
    if op is not None:
        probs = maybe_quant(op.act_in, probs)
        q2 = op.act_in
        if q2.qtype != "dummy":
            q2 = q2.with_axes_flipped() if q2.eff_axes == -1 else q2
            v4 = quantize_dequant(q2, v4)
    out = torch.einsum("bhts,bhsd->bhtd", probs.float(), v4.float())
    if op is not None:
        out = maybe_quant(op.act_out, out.to(v4.dtype)).float()
    return out
