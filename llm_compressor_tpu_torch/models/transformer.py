"""The transformer core of the nine architectures: Llama, Qwen2, Qwen3,
Gemma, Gemma2, Gemma3, OPT, BLOOM and Phi (port of ``models/transformer.py``).

Plain functions over a params dict:

    embed()    tokens -> hidden (Gemma's embedding scale, OPT-350m's
               project_in, OPT's learned positions, BLOOM's LayerNorm)
    attention(), mlp(), decoder_layer()
    head()     hidden -> logits (final norm, OPT-350m's project_out,
               lm_head with Phi's bias, Gemma2's softcap)
    forward_hidden()  the decoder stack, at given positions
    forward()  the full model

Each layer has its own rope (:func:`rope_for_layer`: Gemma3's local layers
take their own theta, Phi rotates the first ``rotary_dim`` dims, OPT and
BLOOM have none) and its own mask (:func:`make_causal_mask`: a sliding
window on the local layers of Gemma2 and Gemma3), computed once per
variant (:func:`layer_ropes`). BLOOM adds ALiBi over the absolute key
positions; OPT and BLOOM scale the query before the QK matmul (in the
query's dtype), the others the scores after it.

Quantization is threaded through as a :class:`LayerOps`, the per-layer
resolution of a :class:`~..qformats.QuantConfig`. A ``taps`` dict passed
to :func:`decoder_layer` collects the inputs of the linears for
calibration (``attn_in``, ``o_in``, ``mlp_in``, ``down_in``) and the
attention matmuls' operands and outputs for the profiler (``qk_in1``,
``qk_in2``, ``qk_out``, ``sv_in1``, ``sv_in2``, ``sv_out``), as the JAX
package's taps replace torch forward hooks. ``fuse_model``
concatenates q|k|v and gate|up (BLOOM's q|k|v is fused already; an fc1/fc2
MLP has no gate|up); ``stack_model`` stacks the layers along a
leading axis, and :func:`layer_view` gives one layer of the stack (dense
tensors as views, packed weights as :class:`~.layers.LayerSlice`).

The layers run in a Python loop, each with its own :class:`LayerOps`, so a
mixed-precision (MPQ) plan needs no plan of its own here;
:func:`scan_segments` gives the runs of equal layers that the JAX package
scans one by one, which the engine's checks walk as it does. Packed
weights of different formats do not stack (in neither package): such a
model is served unstacked.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import torch

from ..kernels import w4a8_matmul as wm
from ..qformats.config import OpQuantConfig, QuantConfig
from ..qformats.qtensor import QTensor
from .config import ModelConfig
from .layers import (
    LayerSlice,
    activation,
    alibi_bias,
    apply_norm,
    apply_rope,
    layer_norm,
    qlinear,
    qmatmul_qk,
    qmatmul_sv,
    rms_norm,
    rope_cos_sin,
    rope_inv_freq,
    softcap,
    w4a8_route,
)

Params = Dict[str, Any]

NEG_INF = -1e9
# linear slots per family, in the reference's module order (JAX :60-71)
_SLOTS = {
    "gated": ("q", "k", "v", "o", "gate", "up", "down"),
    "mlp": ("q", "k", "v", "o", "fc1", "fc2"),
    "fused": ("qkv", "o", "fc1", "fc2"),
}


def arch_slots(cfg: ModelConfig) -> tuple:
    """Linear slots of the architecture, in the reference's module order."""
    if cfg.fused_qkv:
        return _SLOTS["fused"]
    return _SLOTS[cfg.mlp_style]


def op_names(cfg: ModelConfig, layer_idx: int) -> Dict[str, str]:
    """Slot -> op name, the reference's torch module names (MPQ overrides
    and profiles name ops so)."""
    i = layer_idx
    if cfg.arch == "opt":
        p = f"decoder.layers.{i}"
        return {"q": f"{p}.self_attn.q_proj", "k": f"{p}.self_attn.k_proj",
                "v": f"{p}.self_attn.v_proj", "o": f"{p}.self_attn.out_proj",
                "fc1": f"{p}.fc1", "fc2": f"{p}.fc2",
                "qk": f"{p}.self_attn.qk_matmul", "sv": f"{p}.self_attn.sv_matmul"}
    if cfg.arch == "bloom":
        p = f"transformer.h.{i}"
        return {"qkv": f"{p}.self_attention.query_key_value",
                "o": f"{p}.self_attention.dense",
                "fc1": f"{p}.mlp.dense_h_to_4h", "fc2": f"{p}.mlp.dense_4h_to_h",
                "qk": f"{p}.self_attention.qk_matmul", "sv": f"{p}.self_attention.sv_matmul"}
    p = f"layers.{i}"
    if cfg.arch == "phi":
        return {"q": f"{p}.self_attn.q_proj", "k": f"{p}.self_attn.k_proj",
                "v": f"{p}.self_attn.v_proj", "o": f"{p}.self_attn.dense",
                "fc1": f"{p}.mlp.fc1", "fc2": f"{p}.mlp.fc2",
                "qk": f"{p}.self_attn.qk_matmul", "sv": f"{p}.self_attn.sv_matmul"}
    return {
        "q": f"{p}.self_attn.q_proj", "k": f"{p}.self_attn.k_proj",
        "v": f"{p}.self_attn.v_proj", "o": f"{p}.self_attn.o_proj",
        "gate": f"{p}.mlp.gate_proj", "up": f"{p}.mlp.up_proj",
        "down": f"{p}.mlp.down_proj",
        "qk": f"{p}.self_attn.qk_matmul", "sv": f"{p}.self_attn.sv_matmul",
    }


@dataclass(frozen=True)
class LayerOps:
    """Per-layer quantizer resolution: ``linears`` maps slot name ->
    OpQuantConfig; ``qk``/``sv`` are the attention matmul slots."""

    linears: tuple
    qk: Optional[OpQuantConfig] = None
    sv: Optional[OpQuantConfig] = None

    def get(self, slot: str) -> Optional[OpQuantConfig]:
        for s, op in self.linears:
            if s == slot:
                return op
        return None


def layer_ops(cfg: ModelConfig, qcfg: Optional[QuantConfig], layer_idx: int) -> Optional[LayerOps]:
    if qcfg is None:
        return None
    names = op_names(cfg, layer_idx)
    return LayerOps(
        linears=tuple((s, qcfg.for_op(names[s], "linear")) for s in arch_slots(cfg)),
        qk=qcfg.for_op(names["qk"], "matmul"),
        sv=qcfg.for_op(names["sv"], "matmul"),
    )


def _slot(ops: Optional[LayerOps], slot: str) -> Optional[OpQuantConfig]:
    return ops.get(slot) if ops is not None else None


def _tap(taps: Optional[dict], key: str, value) -> None:
    if taps is not None:
        taps[key] = value


def in_dtype(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float: a tensor times it
    equals the JAX product of two values of that dtype (exact in float32,
    rounded once), and no copy to the card is made (a CUDA graph's capture
    refuses one)."""
    return torch.tensor(v, dtype=dtype).item()


def embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
          positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids (B, T) at ``positions`` (B, T) (0..T-1 if None) -> hidden
    states (B, T, hidden) (JAX :162-178): Gemma's scale, rounded to the
    embedding's dtype first (HF rounds sqrt(hidden) the same way);
    OPT-350m's ``project_in``; OPT's learned positions, offset by
    ``learned_pos_offset``; BLOOM's embedding LayerNorm."""
    h = params["embed"]["weight"][tokens.long()]
    if cfg.embed_scale is not None:
        h = h * in_dtype(cfg.embed_scale, h.dtype)
    if cfg.project_in_dim is not None:
        h = qlinear(h, params["project_in"]["weight"])
    if cfg.pos_embedding == "learned":
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        table = params["pos_embed"]["weight"]
        # an index past the table is clamped, as a JAX gather clamps it (an
        # idle batcher slot at max_len embeds such a position)
        idx = torch.clamp(positions.long() + cfg.learned_pos_offset, max=table.shape[0] - 1)
        h = h + table[idx]
    if cfg.embedding_layernorm:
        h = apply_norm(cfg, h, params["embed_ln"])
    return h


def head(params: Params, cfg: ModelConfig, h: torch.Tensor,
         qcfg: Optional[QuantConfig] = None) -> torch.Tensor:
    """Final norm (where the config has one), OPT-350m's ``project_out``,
    lm_head with its bias (Phi) -> f32 logits (B, T, vocab), softcapped
    where the config says (Gemma2) (JAX :181-197)."""
    if cfg.final_norm and "final_norm" in params:
        h = apply_norm(cfg, h, params["final_norm"])
    if cfg.project_in_dim is not None:
        h = qlinear(h, params["project_out"]["weight"])
    lm = params.get("lm_head")
    w, b = (params["embed"]["weight"], None) if lm is None else (lm["weight"], lm.get("bias"))
    op = qcfg.for_op("lm_head", "head") if qcfg is not None else None
    return softcap(qlinear(h, w, b, op).float(), cfg.final_logit_softcapping)


def rope_for_layer(cfg: ModelConfig, layer_idx: int, positions: torch.Tensor):
    """cos/sin (B, T, rotary_dim) f32 for one layer, (None, None) without
    rope (OPT, BLOOM): Gemma3's local layers take ``rope_local_theta`` and
    no scaling (JAX :444-457)."""
    if cfg.pos_embedding != "rope":
        return None, None
    theta, scaling = cfg.rope_theta, cfg.rope_scaling
    if cfg.rope_local_theta is not None and cfg.layer_type(layer_idx) == "sliding_attention":
        theta, scaling = cfg.rope_local_theta, None
    inv = rope_inv_freq(cfg.rotary_dim, theta, scaling, device=positions.device)
    return rope_cos_sin(positions, inv)


def layer_ropes(cfg: ModelConfig, positions: torch.Tensor) -> list:
    """Every layer's (cos, sin), computed once per rope variant (the JAX
    package's ``rope_stack``)."""
    local = lambda i: (cfg.rope_local_theta is not None
                       and cfg.layer_type(i) == "sliding_attention")
    variants = {}
    for i in range(cfg.num_layers):
        if local(i) not in variants:
            variants[local(i)] = rope_for_layer(cfg, i, positions)
    return [variants[local(i)] for i in range(cfg.num_layers)]


def window_mask(q_positions, kv_positions, window: int = 0) -> torch.Tensor:
    """(B, T, S) additive f32 causal mask (0 / NEG_INF); a ``window`` > 0
    keeps keys at positions > q - window as well (JAX :205-214)."""
    qp, kp = q_positions[:, :, None], kv_positions[:, None, :]
    keep = kp <= qp
    if window > 0:
        keep = keep & (kp > qp - window)
    zero = torch.zeros((), dtype=torch.float32, device=q_positions.device)
    return torch.where(keep, zero, torch.full_like(zero, NEG_INF))


def make_causal_mask(cfg: ModelConfig, layer_idx: int, q_positions, kv_positions):
    """(B, 1, T, S) additive f32 mask of one layer, sliding-window aware."""
    return window_mask(q_positions, kv_positions, cfg.layer_window(layer_idx))[:, None]


def layer_masks(cfg: ModelConfig, q_positions, kv_positions) -> list:
    """Every layer's (B, T, S) mask, computed once per window size."""
    masks = {}
    for i in range(cfg.num_layers):
        w = cfg.layer_window(i)
        if w not in masks:
            masks[w] = window_mask(q_positions, kv_positions, w)
    return [masks[cfg.layer_window(i)] for i in range(cfg.num_layers)]


def _rope(x, cos, sin, rot: int):
    """Rope on the first ``rot`` dims of x (Phi's partial rotary), all of
    them where ``rot`` is the head dim."""
    if rot < x.shape[-1]:
        return torch.cat([apply_rope(x[..., :rot], cos, sin), x[..., rot:]], dim=-1)
    return apply_rope(x, cos, sin)


def project_qkv(lp: Params, cfg: ModelConfig, x, ops: Optional[LayerOps], cos, sin):
    """QKV projection (biases where the layer has them; BLOOM's fused
    projection interleaved (H, 3, D) along N), q/k norms, rope (none where
    ``cos`` is None) for a (B, T, E) slice -> q (B, T, H, D), k/v
    (B, T, KV, D) (JAX :242-282)."""
    B, T, _ = x.shape
    ap = lp["attn"]
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.fused_qkv:
        y = qlinear(x, ap["qkv"]["weight"], ap["qkv"].get("bias"),
                    _slot(ops, "qkv")).reshape(B, T, H, 3, D)
        q, k, v = y[..., 0, :], y[..., 1, :], y[..., 2, :]
    elif "qkv_cat" in ap:
        y = qlinear(x, ap["qkv_cat"]["weight"], ap["qkv_cat"].get("bias"), _slot(ops, "q"))
        q = y[..., :H * D].reshape(B, T, H, D)
        k = y[..., H * D:(H + KV) * D].reshape(B, T, KV, D)
        v = y[..., (H + KV) * D:].reshape(B, T, KV, D)
    else:
        q = qlinear(x, ap["q"]["weight"], ap["q"].get("bias"), _slot(ops, "q")).reshape(B, T, H, D)
        k = qlinear(x, ap["k"]["weight"], ap["k"].get("bias"), _slot(ops, "k")).reshape(B, T, KV, D)
        v = qlinear(x, ap["v"]["weight"], ap["v"].get("bias"), _slot(ops, "v")).reshape(B, T, KV, D)
    if cfg.qk_norm:   # per-head-dim RMS norm (qwen3 plain, gemma3 plus-one)
        q = rms_norm(q, ap["q_norm"]["weight"], cfg.rms_norm_eps, cfg.norm_weight_plus_one)
        k = rms_norm(k, ap["k_norm"]["weight"], cfg.rms_norm_eps, cfg.norm_weight_plus_one)
    elif cfg.qk_layernorm:   # phi option
        q = layer_norm(q, ap["q_norm"]["weight"], ap["q_norm"].get("bias"), cfg.rms_norm_eps)
        k = layer_norm(k, ap["k_norm"]["weight"], ap["k_norm"].get("bias"), cfg.rms_norm_eps)
    if cos is not None:
        q, k = _rope(q, cos, sin, cfg.rotary_dim), _rope(k, cos, sin, cfg.rotary_dim)
    return q, k, v


def prescaled(cfg: ModelConfig) -> bool:
    """OPT and BLOOM scale the query before the QK matmul (reference
    ``opt.py:113``, ``bloom.py:66-108``), the others the scores after it."""
    return cfg.arch in ("opt", "bloom")


def attention(lp: Params, cfg: ModelConfig, x, cos, sin, mask,
              ops: Optional[LayerOps] = None, taps: Optional[dict] = None) -> torch.Tensor:
    """Multi-head attention with GQA; ``mask`` (B, 1, T, S) (JAX :224-347):
    OPT's and BLOOM's query scaled in its dtype before the QK matmul,
    BLOOM's ALiBi over the absolute key positions, the softcap before the
    mask, the o projection's bias."""
    B, T, _ = x.shape
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    _tap(taps, "attn_in", x)
    q, k, v = project_qkv(lp, cfg, x, ops, cos, sin)
    r = H // KV
    k = k[:, :, :, None, :].expand(B, T, KV, r, D).reshape(B, T, H, D)
    v = v[:, :, :, None, :].expand(B, T, KV, r, D).reshape(B, T, H, D)
    q4, k4t, v4 = q.transpose(1, 2), k.permute(0, 2, 3, 1), v.transpose(1, 2)
    if prescaled(cfg):
        q4 = q4 * in_dtype(cfg.attn_scale, q4.dtype)
    _tap(taps, "qk_in1", q4)
    _tap(taps, "qk_in2", k4t)
    scores = qmatmul_qk(q4, k4t, ops.qk if ops is not None else None)
    if not prescaled(cfg):
        scores = scores * cfg.attn_scale
    if cfg.pos_embedding == "alibi":
        scores = scores + alibi_bias(H, torch.arange(T, device=x.device))[None]
    scores = softcap(scores, cfg.attn_logit_softcapping) + mask   # the softcap before the mask
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    _tap(taps, "qk_out", scores)
    _tap(taps, "sv_in1", probs)
    _tap(taps, "sv_in2", v4)
    out = qmatmul_sv(probs, v4, ops.sv if ops is not None else None).to(x.dtype)
    _tap(taps, "sv_out", out)
    out = out.transpose(1, 2).reshape(B, T, H * D)
    _tap(taps, "o_in", out)
    o = lp["attn"]["o"]
    return qlinear(out, o["weight"], o.get("bias"), _slot(ops, "o"), slot="o")


def _try_fused_gateup(cfg: ModelConfig, mp: Params, x, gop: Optional[OpQuantConfig]):
    """The fused gate|up + activation kernel (B2) for a stacked gateup
    weight, where qlinear would take the W4A8 kernels (:func:`w4a8_route`);
    None otherwise."""
    w = mp["gateup"]["weight"]
    if not isinstance(w, LayerSlice) or gop is None or gop.act_out.qtype != "dummy":
        return None
    if not (wm.gateup_silu_ok(w.qt, cfg.hidden_act)
            and w4a8_route(gop.act_in, w.qt, x.shape[:-1].numel(), x.is_cuda)):
        return None
    return wm.gateup_silu_matmul(x, w.qt, cfg.hidden_act, w.layer)


def mlp(lp: Params, cfg: ModelConfig, x, ops: Optional[LayerOps] = None,
        taps: Optional[dict] = None):
    """The gated MLP (gate|up fused where ``fuse_model`` fused it), or
    fc1 -> activation -> fc2 with biases (JAX :365-398)."""
    mp = lp["mlp"]
    _tap(taps, "mlp_in", x)
    if cfg.mlp_style != "gated":
        h = activation(cfg.hidden_act, qlinear(x, mp["fc1"]["weight"], mp["fc1"].get("bias"),
                                               _slot(ops, "fc1")))
        _tap(taps, "down_in", h)
        return qlinear(h, mp["fc2"]["weight"], mp["fc2"].get("bias"), _slot(ops, "fc2"),
                       slot="fc2")
    if "gateup" in mp:
        gop = _slot(ops, "gate")
        h = None if taps is not None else _try_fused_gateup(cfg, mp, x, gop)
        if h is None:
            y = qlinear(x, mp["gateup"]["weight"], None, gop)
            I = y.shape[-1] // 2
            h = activation(cfg.hidden_act, y[..., :I]) * y[..., I:]
    else:
        gt = qlinear(x, mp["gate"]["weight"], None, _slot(ops, "gate"))
        u = qlinear(x, mp["up"]["weight"], None, _slot(ops, "up"))
        h = activation(cfg.hidden_act, gt) * u
    _tap(taps, "down_in", h)
    return qlinear(h, mp["down"]["weight"], None, _slot(ops, "down"), slot="down")


def residual_block(lp: Params, cfg: ModelConfig, x, attend, ops: Optional[LayerOps] = None,
                   taps: Optional[dict] = None) -> torch.Tensor:
    """The residual block around ``attend`` (its input -> attention output)
    (JAX :405-441): pre-norm, with Gemma2/3's norm on the attention output
    and their pre/post feed-forward norms; Phi's parallel residual (one
    input norm for attention and MLP); OPT-350m's post-norm
    (``do_layer_norm_before`` False: the norms after each residual add).
    The MLP's ``mlp_in`` tap is its input."""
    if cfg.parallel_residual:
        xn = apply_norm(cfg, x, lp["ln1"])
        a = attend(xn)
        return x + a + mlp(lp, cfg, xn, ops, taps)
    if not cfg.do_layer_norm_before:
        x = apply_norm(cfg, x + attend(x), lp["ln1"])
        return apply_norm(cfg, x + mlp(lp, cfg, x, ops, taps), lp["ln2"])
    a = attend(apply_norm(cfg, x, lp["ln1"]))
    if cfg.post_attn_residual_norm:
        a = apply_norm(cfg, a, lp["post_attn_norm"])
    x = x + a
    if cfg.pre_post_ffw_norm:
        m = mlp(lp, cfg, apply_norm(cfg, x, lp["pre_ffw_norm"]), ops, taps)
        return x + apply_norm(cfg, m, lp["post_ffw_norm"])
    return x + mlp(lp, cfg, apply_norm(cfg, x, lp["ln2"]), ops, taps)


def decoder_layer(lp: Params, cfg: ModelConfig, x, cos, sin, mask,
                  ops: Optional[LayerOps] = None, taps: Optional[dict] = None) -> torch.Tensor:
    """One decoder block, the unit of layer-by-layer calibration."""
    return residual_block(lp, cfg, x, lambda xn: attention(lp, cfg, xn, cos, sin, mask, ops, taps),
                          ops, taps)


# ---------------------------------------------------------------------------
# Serving transforms
# ---------------------------------------------------------------------------


def _shard_interleave(arrs, shards: int):
    """[a0_s | a1_s | ...] for each shard s in turn, along dim 0: shard s
    of the result (split in ``shards`` equal rows) is the concatenation of
    every input's shard s, the tensor-parallel fused layout (JAX :537-550)."""
    if shards == 1:
        return torch.cat(arrs)
    return torch.cat([a[s * (a.shape[0] // shards):(s + 1) * (a.shape[0] // shards)]
                      for s in range(shards) for a in arrs])


def _concat_linear(entries, shards: int = 1) -> Params:
    """Linear entries concatenated along N; biases too (zeros for an entry
    without one), as JAX :553-592 does. ``shards`` > 1 interleaves them per
    tensor-parallel shard (:func:`_shard_interleave`): such params run only
    on a model group of that size."""
    ws = [e["weight"] for e in entries]
    if isinstance(ws[0], QTensor):
        q0 = ws[0]
        N = sum(w.shape[0] for w in ws)
        weight = replace(
            q0,
            codes=_shard_interleave([w.codes for w in ws], shards),
            scales=_shard_interleave([w.scales for w in ws], shards),
            zeros=None if q0.zeros is None else _shard_interleave([w.zeros for w in ws], shards),
            shape=(N,) + tuple(q0.shape[1:]),
            blocked_shape=(N,) + tuple(q0.blocked_shape[1:]),
        )
    else:
        weight = _shard_interleave(ws, shards)
    out = {"weight": weight}
    biases = [e.get("bias") for e in entries]
    b0 = next((b for b in biases if b is not None), None)
    if b0 is not None:
        out["bias"] = _shard_interleave([b0.new_zeros(w.shape[0]) if b is None else b
                                         for b, w in zip(biases, ws)], shards)
    return out


def _fusible(entries, ops: Optional[LayerOps], slots) -> bool:
    """Slots fuse when they share quantizer behaviour, no act_out quantizer
    and compatible weights (row-wise groups concatenate exactly along N)."""
    if ops is not None:
        opcfgs = [ops.get(s) for s in slots]
        if any(o != opcfgs[0] for o in opcfgs[1:]):
            return False
        if opcfgs[0] is not None and opcfgs[0].act_out.qtype != "dummy":
            return False
    ws = [e["weight"] for e in entries]
    if any(isinstance(w, QTensor) != isinstance(ws[0], QTensor) for w in ws):
        return False
    if isinstance(ws[0], QTensor):
        q0 = ws[0]
        if q0.quantizer.eff_axes != -1:
            return False
        return all(w.quantizer == q0.quantizer
                   and tuple(w.shape[1:]) == tuple(q0.shape[1:])
                   and tuple(w.blocked_shape[1:]) == tuple(q0.blocked_shape[1:])
                   and (w.zeros is None) == (q0.zeros is None)
                   and w.pair_planes == q0.pair_planes for w in ws)
    return all(w.dim() == 2 and w.shape[1] == ws[0].shape[1] for w in ws)


def fuse_model(params: Params, cfg: ModelConfig,
               qcfg: Optional[QuantConfig] = None, shards: int = 1) -> Params:
    """Concatenate q/k/v into ``qkv_cat`` and gate/up into ``gateup`` in
    every layer (in place), when every layer fuses; BLOOM's q|k|v is one
    projection already and an fc1/fc2 MLP has no gate|up (JAX :626-668).
    ``shards`` > 1 interleaves each concatenation per tensor-parallel shard,
    so that each rank's row block of the fused weight is its own
    [q_s | k_s | v_s] (``parallel/tp.py``, ``fused=True``); heads and the
    FFN width must divide by it."""
    layers = params["layers"]
    if shards > 1 and (cfg.num_heads % shards or cfg.num_kv_heads % shards
                       or cfg.intermediate_size % shards):
        raise ValueError(f"heads/ffn not divisible by shards={shards}")
    can_qkv = not cfg.fused_qkv and all(
        _fusible([lp["attn"][s] for s in ("q", "k", "v")], layer_ops(cfg, qcfg, i),
                 ("q", "k", "v")) for i, lp in enumerate(layers))
    can_gu = cfg.mlp_style == "gated" and all(
        _fusible([lp["mlp"][s] for s in ("gate", "up")], layer_ops(cfg, qcfg, i),
                 ("gate", "up")) for i, lp in enumerate(layers))
    for lp in layers:
        if can_qkv:
            ap = lp["attn"]
            ap["qkv_cat"] = _concat_linear([ap.pop("q"), ap.pop("k"), ap.pop("v")], shards)
        if can_gu:
            mp = lp["mlp"]
            mp["gateup"] = _concat_linear([mp.pop("gate"), mp.pop("up")], shards)
    return params


def _stack(nodes):
    n0 = nodes[0]
    if isinstance(n0, dict):
        return {k: _stack([n[k] for n in nodes]) for k in n0}
    if isinstance(n0, QTensor):
        if any(n.quantizer != n0.quantizer or n.codes.shape != n0.codes.shape
               or n.pair_planes != n0.pair_planes or (n.zeros is None) != (n0.zeros is None)
               for n in nodes):
            raise ValueError("the layers' packed weights differ in format (an MPQ plan): "
                             "serve the model unstacked")
        return replace(n0, codes=torch.stack([n.codes for n in nodes]),
                       scales=torch.stack([n.scales for n in nodes]),
                       zeros=None if n0.zeros is None
                       else torch.stack([n.zeros for n in nodes]))
    return torch.stack(nodes)


def stack_layers(params: Params):
    """The per-layer trees stacked along a leading L axis (JAX :716-718),
    packed weights as stacked QTensors. Raises ``ValueError`` when the
    layers' packed weights differ in format."""
    return _stack(params["layers"])


def stack_model(params: Params) -> Params:
    """Serving form: the per-layer list becomes one stacked dict
    ``layers_stacked`` (:func:`stack_layers`; JAX :721-727)."""
    new = dict(params)
    new["layers_stacked"] = stack_layers(params)
    del new["layers"]
    return new


def layer_view(stacked, i: int):
    """Layer ``i`` of a stacked tree: tensors as views, QTensors as
    LayerSlice (the kernels read the stacked buffers in place)."""
    if isinstance(stacked, dict):
        return {k: layer_view(v, i) for k, v in stacked.items()}
    if isinstance(stacked, QTensor):
        return LayerSlice(stacked, i)
    return stacked[i]


def iter_layers(params: Params):
    """(index, per-layer params) over either params form."""
    if "layers_stacked" in params:
        st = params["layers_stacked"]
        n = st["ln1"]["weight"].shape[0]
        return ((i, layer_view(st, i)) for i in range(n))
    return enumerate(params["layers"])


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   qcfg: Optional[QuantConfig] = None,
                   positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, T) at ``positions`` (B, T) (0..T-1 if None) -> the last
    hidden states (B, T, hidden), before the final norm (JAX :730-777).
    The positions reach the embedding (OPT's learned positions), the ropes
    and the masks. Stacked or per-layer params."""
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    h = embed(params, cfg, tokens, positions)
    ropes = layer_ropes(cfg, positions)
    masks = layer_masks(cfg, positions, positions)
    for i, lp in iter_layers(params):
        h = decoder_layer(lp, cfg, h, *ropes[i], masks[i][:, None], layer_ops(cfg, qcfg, i))
    return h


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            qcfg: Optional[QuantConfig] = None,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, T) -> f32 logits (B, T, vocab): :func:`forward_hidden`,
    then :func:`head`."""
    return head(params, cfg, forward_hidden(params, cfg, tokens, qcfg, positions), qcfg)


# ---------------------------------------------------------------------------
# Layer uniformity (the JAX package's scan plan)
# ---------------------------------------------------------------------------


def quant_uniform(cfg: ModelConfig, qcfg: Optional[QuantConfig]) -> bool:
    """True when every layer resolves the same quantizers."""
    if qcfg is not None and qcfg.overrides:
        o0 = layer_ops(cfg, qcfg, 0)
        return all(layer_ops(cfg, qcfg, i) == o0 for i in range(cfg.num_layers))
    return True


def uniform_layers(cfg: ModelConfig, qcfg: Optional[QuantConfig]) -> bool:
    """True when every layer has the same static behaviour: no sliding
    window or local rope theta, one layer type, equal quantizers (JAX
    :460-468)."""
    if cfg.sliding_window is not None or cfg.rope_local_theta is not None:
        return False
    if cfg.layer_types and len(set(cfg.layer_types)) > 1:
        return False
    return quant_uniform(cfg, qcfg)


def scan_segments(cfg: ModelConfig, qcfg: Optional[QuantConfig]):
    """Maximal runs of contiguous layers with equal :class:`LayerOps`:
    ``[(start, stop, ops), ...]`` covering ``range(num_layers)``, the runs
    the JAX package scans one by one."""
    if qcfg is None or not qcfg.overrides:
        return [(0, cfg.num_layers, layer_ops(cfg, qcfg, 0))]
    segs = []
    start, cur = 0, layer_ops(cfg, qcfg, 0)
    for i in range(1, cfg.num_layers):
        o = layer_ops(cfg, qcfg, i)
        if o != cur:
            segs.append((start, i, cur))
            start, cur = i, o
    segs.append((start, cfg.num_layers, cur))
    return segs
