"""Prefill and greedy decode over the int8 KV cache (port of
``engine/generate.py``: ``prefill`` :1009, ``decode_step`` :1019,
``decode_greedy_steps`` :1029).

* Prefill (T > 1) runs the attention in plain PyTorch, as the JAX package
  runs it in XLA: the whole cache window is dequantized and the QK / SV
  activation quantizers are applied as configured (``_cached_attention``).
* Decode (T = 1) runs the int8-codes attention of the W4A8 serving config
  through the fused-append kernel B4, which writes the token's K/V codes in
  place and attends over the slot's window. The JAX package decodes the
  same tokens and cache codes whether new tokens go to a side block or
  straight into the cache; the port writes in place.

The decode loop is a Python loop over steps and layers; a CUDA graph is
later work (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.decode_attention import decode_attention_append
from ..models.config import ModelConfig
from ..models.layers import apply_norm, int8_per_token, qlinear, qmatmul_qk, qmatmul_sv
from ..models.transformer import (
    LayerOps,
    causal_mask,
    embed,
    head,
    iter_layers,
    layer_ops,
    mlp,
    project_qkv,
    rope_for_positions,
)
from ..qformats import QuantConfig
from .kvcache import KVCache, _quant_i8, append_prefill, read


def int8_attention(ops: Optional[LayerOps]) -> bool:
    """Both attention matmuls take symmetric int8 per-token inputs and no
    output quantizer: the int8-codes attention of kernel B4 (the JAX
    package's ``acts_mode`` True)."""
    return ops is not None and all(
        int8_per_token(op.act_in) and op.act_out.qtype == "dummy" for op in (ops.qk, ops.sv))


def _prefill_attention(lp, cfg: ModelConfig, layer: int, x, cache: KVCache,
                       ops: Optional[LayerOps], cos, sin, mask):
    """Attention of a (B, T, E) prompt slice: write its K/V codes into the
    cache, then attend over the dequantized window with the activation
    quantizers as configured (JAX ``_cached_attention``, T > 1)."""
    B, T, _ = x.shape
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    r = H // KV
    q, k, v = project_qkv(lp, cfg, x, ops, cos, sin)
    append_prefill(cache, layer, k, v, 0)
    K, V = read(cache, layer, x.dtype)                     # (B, KV, S, D)
    S = K.shape[2]
    # the r query heads of a kv head as (r * T) rows; every quantizer here
    # works per row or per column, so the grouping of rows changes nothing
    q4 = q.reshape(B, T, KV, r, D).permute(0, 2, 3, 1, 4).reshape(B, KV, r * T, D)
    scores = qmatmul_qk(q4, K.transpose(-1, -2), ops.qk if ops is not None else None)
    scores = scores.reshape(B, KV, r, T, S) * cfg.attn_scale + mask[:, None, None]
    probs = torch.softmax(scores, dim=-1).to(x.dtype).reshape(B, KV, r * T, S)
    out = qmatmul_sv(probs, V, ops.sv if ops is not None else None)
    out = out.reshape(B, KV, r, T, D).permute(0, 3, 1, 2, 4).reshape(B, T, H * D)
    out = out.to(x.dtype)
    return qlinear(out, lp["attn"]["o"]["weight"], None, ops.get("o") if ops else None)


def _decode_attention(lp, cfg: ModelConfig, layer: int, x, cache: KVCache,
                      ops: LayerOps, cos, sin):
    """int8-codes attention of one new token per slot through kernel B4."""
    B = x.shape[0]
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = project_qkv(lp, cfg, x, ops, cos, sin)
    kc, ks = _quant_i8(k)                                  # (B, KV, 1, D), (B, KV, 1)
    vc, vs = _quant_i8(v)
    out = decode_attention_append(
        q.reshape(B, KV, H // KV, D).float(),
        kc[:, :, 0].contiguous(), vc[:, :, 0].contiguous(),
        ks[:, :, 0].contiguous(), vs[:, :, 0].contiguous(),
        cache.k[layer], cache.v[layer], cache.k_scale[layer], cache.v_scale[layer],
        cache.lengths, scale=cfg.attn_scale)
    out = out.to(x.dtype).reshape(B, 1, H * D)             # head h = kv * r + j
    return qlinear(out, lp["attn"]["o"]["weight"], None, ops.get("o"))


def _layer(lp, cfg: ModelConfig, x, ops, attend):
    """Pre-norm residual block; ``attend`` maps the normed input to the
    attention output."""
    x = x + attend(apply_norm(cfg, x, lp["ln1"]))
    return x + mlp(lp, cfg, apply_norm(cfg, x, lp["ln2"]), ops)


@torch.inference_mode()
def prefill(params, tokens: torch.Tensor, cache: KVCache, *, cfg: ModelConfig,
            qcfg: Optional[QuantConfig] = None):
    """Encode the prompt (B, T) into ``cache`` (in place); returns the
    last-position logits (B, V) f32 and the cache."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    kv_pos = torch.arange(cache.max_len, device=tokens.device)[None, :].expand(B, -1)
    h = embed(params, cfg, tokens)
    cos, sin = rope_for_positions(cfg, positions)
    mask = causal_mask(positions, kv_pos)
    for i, lp in iter_layers(params):
        ops = layer_ops(cfg, qcfg, i)
        h = _layer(lp, cfg, h, ops, lambda xn: _prefill_attention(
            lp, cfg, i, xn, cache, ops, cos, sin, mask))
    logits = head(params, cfg, h[:, -1:, :], qcfg)
    cache.lengths.fill_(T)
    return logits[:, -1, :], cache


def _check_decode(params, cfg: ModelConfig, cache: KVCache, qcfg, n: int) -> None:
    for i in range(cfg.num_layers):
        if not int8_attention(layer_ops(cfg, qcfg, i)):
            raise NotImplementedError(
                "decode is ported for the int8 per-token attention config only "
                "(the W4A8 serving path): ROADMAP.md queue A item 5")
    if int(cache.lengths.max()) + n > cache.max_len:
        raise ValueError(f"{n} decode steps overrun the cache (max_len {cache.max_len})")


def _decode_one(params, token, cache: KVCache, cfg: ModelConfig, qcfg):
    positions = cache.lengths.long()[:, None]
    h = embed(params, cfg, token)
    cos, sin = rope_for_positions(cfg, positions)
    for i, lp in iter_layers(params):
        ops = layer_ops(cfg, qcfg, i)
        h = _layer(lp, cfg, h, ops, lambda xn: _decode_attention(
            lp, cfg, i, xn, cache, ops, cos, sin))
    logits = head(params, cfg, h, qcfg)
    cache.lengths += 1
    return logits[:, -1, :]


@torch.inference_mode()
def decode_step(params, token: torch.Tensor, cache: KVCache, *, cfg: ModelConfig,
                qcfg: Optional[QuantConfig] = None):
    """One token per slot (B, 1) -> (logits (B, V) f32, cache); the cache is
    updated in place."""
    _check_decode(params, cfg, cache, qcfg, 1)
    return _decode_one(params, token, cache, cfg, qcfg), cache


@torch.inference_mode()
def decode_greedy_steps(params, token: torch.Tensor, cache: KVCache, *, n: int,
                        cfg: ModelConfig, qcfg: Optional[QuantConfig] = None):
    """``n`` greedy decode steps -> (tokens (B, n) int32, cache).
    ``tokens[:, i]`` is the argmax after consuming ``token`` and ``i``
    generated predecessors."""
    _check_decode(params, cfg, cache, qcfg, n)
    out = []
    for _ in range(n):
        logits = _decode_one(params, token, cache, cfg, qcfg)
        token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out.append(token)
    return torch.cat(out, dim=1), cache
