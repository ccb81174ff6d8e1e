"""Primitive layer ops (port of ``models/layers.py``).

Norms (RMSNorm, LayerNorm), activations, rotary embeddings with llama3
scaling, BLOOM's ALiBi slopes, and the quantization-aware linear / matmul
ops. Weights use the (out_features, in_features) orientation; they arrive
as plain tensors, packed :class:`~..qformats.QTensor` or a
:class:`LayerSlice` of a stacked one.

:func:`qlinear` routes a packed weight by :func:`w4a8_route`, given int8
per-token acts and a weight the W4A8 kernels take: a LayerSlice within
the device's row limit goes to the stacked W4A8 kernel (B1), read in
place; any other LayerSlice is taken as its layer's QTensor (a view); a
QTensor within the limit, or of C/g <= 16 K groups at any M, goes to the
flat W4A8 kernel (B3). The limit is 256 rows on the CPU, the JAX
package's (tuned on a TPU), so that the CPU tests see the JAX package's
routes, and :data:`CARD_W4A8_ROWS` on the card, where the integer kernels
beat the dense route up to that batch at any C/g (measured on the H100,
PERF.md). Otherwise the acts are quantized as configured, then M > 256
rows (prefill) -> plain dequantization + torch.matmul, and M <= 256 ->
the dequantize-in-kernel matmul (B5; weight-only serving).

Tensor parallelism (``parallel/tp.py``): inside :func:`tp_trace` a
row-parallel slot (``o``, ``down``, ``fc2``: its contraction dim sharded
over the model group) takes a per-token act scale from the absmax over the
whole row (an ``all_reduce(MAX)``), multiplies without its bias, rounds
its partial to the input's dtype, sums the partials with one
``all_reduce(SUM)`` in that dtype and adds the bias after, as the JAX
package's ``psum`` does; :func:`alibi_bias` takes the slopes of the global
heads.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import torch
import torch.distributed as dist
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
    """(H, 1, S) f32 additive bias: slope_h * kv_position (JAX :149-161).
    Inside :func:`tp_trace` ``n_heads`` is the local head count and the
    slopes are those of the global heads: the table of ``n_heads * size``
    heads, sliced at ``rank * n_heads``."""
    if _TP["group"] is not None and _TP["size"] > 1:
        slopes = alibi_slopes(n_heads * _TP["size"], kv_positions.device)
        slopes = slopes[_TP["rank"] * n_heads:(_TP["rank"] + 1) * n_heads]
    else:
        slopes = alibi_slopes(n_heads, kv_positions.device)
    return slopes[:, None, None] * kv_positions[None, None, :].float()


# The tensor-parallel context (JAX :174-190): the model group while
# ``parallel/tp.py`` runs a rank's shard, its size and this rank's index in
# it. Row-parallel slots have their contraction dim sharded.
_TP = {"group": None, "size": 1, "rank": 0}
_TP_ROW_SLOTS = frozenset(("o", "down", "fc2"))


@contextlib.contextmanager
def tp_trace(group, size: int = 1):
    """Run the model code inside as one rank of a tensor-parallel model
    group of ``size`` ranks: row-parallel :func:`qlinear` slots reduce over
    ``group``, ALiBi takes the global heads' slopes."""
    prev = dict(_TP)
    _TP.update(group=group, size=size, rank=dist.get_rank(group) if group is not None else 0)
    try:
        yield
    finally:
        _TP.update(prev)


def maybe_quant(q: Optional[Quantizer], x):
    if q is None or q.qtype == "dummy":
        return x
    return quantize_dequant(q, x)


def _quant_global_per_token(q: Quantizer, x, group):
    """Per-token fake quantization with the absmax of the whole (sharded)
    row, an ``all_reduce(MAX)`` over ``group`` (JAX :312-325, its ``pmax``).
    Only symmetric int per-token quantizers (the serving act config) take
    the global absmax; others quantize their local row. The division by
    ``qmax`` is the product with its reciprocal, as XLA rounds it under
    ``jit``."""
    if not (q.qtype == "int" and q.group_size == -1 and not q.zero_point):
        return quantize_dequant(q, x)
    qmax = float(q.params.int_max)
    x32 = x.float()
    absmax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(absmax * (1.0 / qmax), 1e-9)
    return (torch.clamp(torch.round(x32 / scale), -qmax, qmax) * scale).to(x.dtype)


def _quant_in(ai: Optional[Quantizer], x, group):
    """The act quantizer of a linear's input: global per-token under
    tensor parallelism (``group`` set), else as configured."""
    if group is not None and ai is not None and ai.qtype != "dummy":
        return _quant_global_per_token(ai, x, group)
    return maybe_quant(ai, x)


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


# The most rows at which a W4A8 linear takes the integer kernels at any C/g
# on the card. quantize_acts_per_token + B1 beat the dense route (fake
# quant + dequantize + torch.matmul), each in a CUDA graph, by 14 % or more
# at every row count up to 3072 for Qwen3's down and Phi-2's qkv and fc2,
# tied at 4096 for Phi-2's qkv and lost at 6144 (PERF.md;
# ``tools/w4a8_crossover.py``).
CARD_W4A8_ROWS = 3072
# The JAX package's limit, tuned on a TPU: it routes the CPU.
_TPU_W4A8_ROWS = 256


def w4a8_route(ai: Optional[Quantizer], qt: QTensor, m_rows: int, on_card: bool,
               in_place: bool = False) -> bool:
    """Whether a linear of ``m_rows`` rows over the packed weight ``qt``
    (flat, or the stack a LayerSlice reads) takes the W4A8 kernels: int8
    per-token acts, a weight they take, and M within the device's limit,
    or, unless ``in_place`` (B1 reading a LayerSlice where it lies), C/g <=
    16 K groups at any M. Off the card the limit is the JAX package's 256
    rows, so the port's routes are the JAX package's."""
    if not (int8_per_token(ai) and wm.supported(qt)):
        return False
    if m_rows <= (CARD_W4A8_ROWS if on_card else _TPU_W4A8_ROWS):
        return True
    _, C, g = wm.weight_dims(qt)
    return not in_place and C // g <= 16


def qlinear(x, weight, bias=None, op: Optional[OpQuantConfig] = None,
            slot: Optional[str] = None):
    """y = act_out_q( act_in_q(x) @ W^T + b ), routed as the module doc says.
    ``slot`` names the projection; inside :func:`tp_trace` a row-parallel
    slot sums its partial products over the model group (JAX :244-345)."""
    ai = op.act_in if op is not None else None
    m_rows = math.prod(x.shape[:-1])
    group = _TP["group"] if slot in _TP_ROW_SLOTS else None
    mm_bias = None if group is not None else bias
    layer = None
    if isinstance(weight, LayerSlice):
        if w4a8_route(ai, weight.qt, m_rows, x.is_cuda, in_place=True):
            weight, layer = weight.qt, weight.layer
        else:
            weight = weight.materialize()

    if isinstance(weight, QTensor):
        if layer is not None or w4a8_route(ai, weight, m_rows, x.is_cuda):
            y = wm.w4a8_matmul(x, weight, mm_bias, layer=layer, absmax_group=group)
        else:
            x = _quant_in(ai, x, group)
            if m_rows > 256:
                # prefill: one dequantization feeds a plain matmul (float32
                # accumulation in both backends), as the JAX package leaves
                # it to XLA
                w = dequantize(weight).to(x.dtype)
                y = torch.matmul(x, w.t())
                if mm_bias is not None:
                    y = y + mm_bias.to(y.dtype)
            else:
                y = dm.dequant_matmul(x, weight, mm_bias)
    else:
        x = _quant_in(ai, x, group)
        y = torch.matmul(x, weight.t())
        if mm_bias is not None:
            y = y + mm_bias.to(y.dtype)
    if group is not None:
        # each partial in the input's dtype, summed in it, then the bias
        y = y.to(x.dtype).contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
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
