"""Prefill, decode and sampling over the KV cache (port of
``engine/generate.py``: ``prefill`` :1009, ``decode_step`` :1019,
``decode_greedy_steps`` :1029, ``_sample`` :1089, ``generate`` :1099,
``generate_text`` :1132).

Attention per layer, chosen as the JAX package's ``_cached_attention``
chooses it:

* Decode (T = 1) over an int8 cache whose attention matmuls both take
  symmetric int8 per-token inputs (:func:`acts_mode` True, the W4A8
  serving config) runs the int8-codes attention through the fused-append
  kernel B4, which writes the token's K/V codes in place and attends over
  the slot's window. The JAX package decodes the same tokens and cache
  codes whether new tokens go to a side block or straight into the cache.
* Everything else — prefill, and decode over a bf16 cache or with other
  attention quantizers — writes K/V into the cache (at ``start`` for
  prefill, at each slot's length for decode) and runs grouped-query float
  attention in plain PyTorch over the whole cache window, applying the QK /
  SV activation quantizers as configured (JAX :306-363, which runs it
  outside any Pallas kernel).

Each layer takes its own rope (Gemma3's local theta) and its own sliding
window (Gemma2/3's local layers): in the float attention as its mask, in
B4, B6 and B7 as the ``window`` argument, a Python int per layer that a
CUDA graph bakes in as it bakes in the layer loop (the graph's key holds
the config). Gemma2's attention softcap is applied after the scale and
before the mask on every path. Each slot's positions reach ``embed``
(OPT's learned positions). OPT and BLOOM scale the query before the QK
matmul: in its dtype on the float path, in float32 before the int8
attention kernels, which then take the scale 1.0 (OPT; JAX :276-281,
:511-516, :687-692). BLOOM's ALiBi stays on the float path in every mode
(its bias over absolute key positions, the slopes made once per device),
as the JAX package keeps it off its kernels.

``decode_greedy_steps(..., attention=...)`` also runs the JAX package's
side-block decode (its "FreshKV" scan path, :469-653, :760-928), which
the JAX package selects with import-time switches: ``"two_part"``
(``LLMC_ATTN_APPEND=0``) and ``"hybrid"`` (``LLMC_ATTN_APPEND=0
LLMC_FUSED_ATTN=1``). The main cache stays read-only during the steps;
each step's K/V go to a side block through B8, attention reads ``[main |
side]`` through B7 (two-part) or B6 plus PyTorch (hybrid), and the block
is merged into the cache once after the steps.

On the card, where JAX runs one jitted dispatch, the port replays one
CUDA graph (``engine/graph.py``) kept on the cache: ``decode_greedy_steps``
captures all ``n`` steps (in the side-block modes each step's lane ``t`` is
baked in, as the JAX scan traces it) and ``decode_step`` one step, so
``generate``'s sampling loop replays one graph per token. The first call
for a key on a cache runs eagerly and warms the kernels up, the second
captures, later calls replay: a call made once on a new cache costs what
the eager loop costs. The host checks that the steps fit the cache once
per call, before the graph. A ``decode_greedy_steps`` call is an
``engine.decode`` span and the check an ``engine.check`` span
(``utils/trace.py``). The eager loop over steps and layers is the
CPU path, and the card's with ``graph=False``.
``generate_text`` wraps ``generate`` in the reference's chat template, or
``generate_speculative`` (``engine/speculative.py``) with ``speculative``.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..device import full_f32_accumulation
from ..kernels.decode_attention import (
    decode_attention,
    decode_attention_append,
    hybrid_decode_attention,
)
from ..models.config import ModelConfig
from ..models.layers import alibi_bias, int8_per_token, qlinear, qmatmul_qk, qmatmul_sv, softcap
from ..models.transformer import (
    LayerOps,
    embed,
    head,
    in_dtype,
    iter_layers,
    layer_masks,
    layer_ops,
    layer_ropes,
    prescaled,
    project_qkv,
    residual_block,
    scan_segments,
)
from ..qformats import QuantConfig
from ..utils import trace
from . import graph as graphs
from .kvcache import (
    FreshKV,
    KVCache,
    _quant_i8,
    append_decode,
    append_prefill,
    init_cache,
    init_fresh,
    merge_fresh,
    read,
    write_fresh,
)

ATTENTION_MODES = ("append", "two_part", "hybrid")
LOGGER = logging.getLogger("llm_compressor_tpu_torch")


def acts_mode(qk_op, sv_op):
    """The decode-attention mode of the attention-matmul quantizers: False
    when neither matmul quantizes its inputs (exact float attention), True
    when both take symmetric int8 per-token inputs and no output quantizer
    (int8-codes attention), None otherwise (float attention with the
    quantizers applied as configured)."""
    def kind(op):
        if op is None or op.act_in.qtype == "dummy":
            return "none"
        if int8_per_token(op.act_in) and op.act_out.qtype == "dummy":
            return "i8"
        return "other"

    k1, k2 = kind(qk_op), kind(sv_op)
    if k1 == "none" and k2 == "none":
        return False
    if k1 == "i8" and k2 == "i8":
        return True
    return None


def _float_attention(cfg: ModelConfig, layer: int, x, q, cache: KVCache,
                     ops: Optional[LayerOps], mask):
    """Grouped-query attention of q (B, T, H, D) over the layer's whole
    cache window, without the KV -> H broadcast (JAX :306-363)."""
    B, T, _ = x.shape
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    r = H // KV
    K, V = read(cache, layer, x.dtype)                     # (B, KV, S, D)
    S = K.shape[2]
    # the r query heads of a kv head as (r * T) rows; every quantizer here
    # works per row or per column, so the grouping of rows changes nothing
    q4 = q.reshape(B, T, KV, r, D).permute(0, 2, 3, 1, 4).reshape(B, KV, r * T, D)
    if prescaled(cfg):   # OPT, BLOOM: the query scaled in its dtype
        q4 = q4 * in_dtype(cfg.attn_scale, q4.dtype)
    scores = qmatmul_qk(q4, K.transpose(-1, -2), ops.qk if ops is not None else None)
    scores = scores.reshape(B, KV, r, T, S)
    if not prescaled(cfg):
        scores = scores * cfg.attn_scale
    if cfg.pos_embedding == "alibi":   # head h = kv * r + j
        scores = scores + alibi_bias(H, torch.arange(S, device=x.device)).reshape(
            KV, r, 1, S)[None]
    scores = softcap(scores, cfg.attn_logit_softcapping)
    scores = scores + mask[:, None, None]
    probs = torch.softmax(scores, dim=-1).to(x.dtype).reshape(B, KV, r * T, S)
    out = qmatmul_sv(probs, V, ops.sv if ops is not None else None)
    out = out.reshape(B, KV, r, T, D).permute(0, 3, 1, 2, 4).reshape(B, T, H * D)
    return out.to(x.dtype)


def _i8_query(cfg: ModelConfig, q):
    """(the f32 query rows (B, KV, r, D), the scale the int8 attention
    kernels apply to the scores): OPT's query is scaled here in float32 and
    the kernel's scale is 1.0 (JAX :276-281, :511-516, :687-692)."""
    B = q.shape[0]
    q4 = q.reshape(B, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim).float()
    if cfg.arch == "opt":
        return q4 * cfg.attn_scale, 1.0
    return q4, cfg.attn_scale


def _i8_decode_attention(cfg: ModelConfig, layer: int, q, k, v, cache: KVCache):
    """int8-codes attention of one new token per slot through kernel B4,
    which also writes the token's codes at each slot's length."""
    B = q.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    kc, ks = _quant_i8(k)                                  # (B, KV, 1, D), (B, KV, 1)
    vc, vs = _quant_i8(v)
    q4, scale = _i8_query(cfg, q)
    out = decode_attention_append(
        q4, kc[:, :, 0].contiguous(), vc[:, :, 0].contiguous(),
        ks[:, :, 0].contiguous(), vs[:, :, 0].contiguous(),
        cache.k[layer], cache.v[layer], cache.k_scale[layer], cache.v_scale[layer],
        cache.lengths, window=cfg.layer_window(layer), scale=scale,
        softcap=cfg.attn_logit_softcapping)
    return out.reshape(B, 1, H * D)                        # head h = kv * r + j


def _cached_attention(lp, cfg: ModelConfig, layer: int, x, cache: KVCache,
                      ops: Optional[LayerOps], cos, sin, mask, start):
    """Attention of a (B, T, E) slice: ``start`` set is prefill (K/V written
    at [start, start + T) of every slot), ``start`` None is decode (at each
    slot's length). Routed as the module doc says."""
    q, k, v = project_qkv(lp, cfg, x, ops, cos, sin)
    qk, sv = (ops.qk, ops.sv) if ops is not None else (None, None)
    if (start is None and cache.quantized and x.shape[1] == 1 and acts_mode(qk, sv) is True
            and cfg.pos_embedding != "alibi"):   # BLOOM's ALiBi: the float path
        out = _i8_decode_attention(cfg, layer, q, k, v, cache).to(x.dtype)
    else:
        if start is None:
            T = x.shape[1]   # T > 1: a speculative verify step
            append_decode(cache, layer, k, v,
                          cache.lengths[:, None] + torch.arange(T, device=x.device)[None, :])
        else:
            append_prefill(cache, layer, k, v, start)
        out = _float_attention(cfg, layer, x, q, cache, ops, mask)
    return _o_proj(lp, out, ops)


def _o_proj(lp, out, ops: Optional[LayerOps]):
    """The attention's output projection, with its bias where it has one."""
    o = lp["attn"]["o"]
    return qlinear(out, o["weight"], o.get("bias"), ops.get("o") if ops else None, slot="o")


def _forward_cached(params, cfg: ModelConfig, tokens, cache: KVCache, qcfg, start):
    """Hidden states (B, T, E) of ``tokens`` at positions [start, start + T)
    (prefill; ``start`` a Python int or a 0-d int64 device tensor, as the
    batcher's chunk graph passes it) or at each slot's length (decode,
    ``start`` None), writing their K/V into ``cache``."""
    B, T = tokens.shape
    dev = tokens.device
    if start is None:
        positions = cache.lengths.long()[:, None] + torch.arange(T, device=dev)[None, :]
    else:
        positions = (start + torch.arange(T, device=dev))[None, :].expand(B, T)
    kv_pos = torch.arange(cache.max_len, device=dev)[None, :].expand(B, -1)
    h = embed(params, cfg, tokens, positions)
    ropes = layer_ropes(cfg, positions)
    masks = layer_masks(cfg, positions, kv_pos)
    for i, lp in iter_layers(params):
        ops = layer_ops(cfg, qcfg, i)
        h = residual_block(lp, cfg, h, lambda xn: _cached_attention(
            lp, cfg, i, xn, cache, ops, *ropes[i], masks[i], start), ops)
    return h


@torch.inference_mode()
def prefill(params, tokens: torch.Tensor, cache: KVCache, *, cfg: ModelConfig,
            qcfg: Optional[QuantConfig] = None):
    """Encode the prompt (B, T) into ``cache`` (in place); returns the
    last-position logits (B, V) f32 and the cache. Its bf16 matmuls
    accumulate and reduce in float32 (:func:`~..device.full_f32_accumulation`),
    as the JAX package asks."""
    with full_f32_accumulation():
        h = _forward_cached(params, cfg, tokens, cache, qcfg, start=0)
        logits = head(params, cfg, h[:, -1:, :], qcfg)
    cache.lengths.fill_(tokens.shape[1])
    return logits[:, -1, :], cache


def _check_decode(cache: KVCache, n: int) -> None:
    """Raise where ``n`` steps overrun the cache: one host sync, made before
    a graph's capture or replay, never inside it."""
    with trace.span("engine.check"):
        longest = int(cache.lengths.max())
    if longest + n > cache.max_len:
        raise ValueError(f"{n} decode steps overrun the cache (max_len {cache.max_len})")


def use_graph(graph: Optional[bool], token: torch.Tensor) -> bool:
    """Whether to replay a CUDA graph: by default on the card and not on
    the CPU; ``graph=True`` on CPU tensors raises instead of running the
    loop."""
    if graph is None:
        return token.is_cuda
    if graph and not token.is_cuda:
        raise ValueError("graph=True needs CUDA tensors; the CPU runs the eager loop")
    return graph


def _decode_one(params, token, cache: KVCache, cfg: ModelConfig, qcfg):
    h = _forward_cached(params, cfg, token, cache, qcfg, start=None)
    logits = head(params, cfg, h, qcfg)
    cache.lengths += 1
    return logits[:, -1, :]


@torch.inference_mode()
def decode_step(params, token: torch.Tensor, cache: KVCache, *, cfg: ModelConfig,
                qcfg: Optional[QuantConfig] = None, graph: Optional[bool] = None):
    """One token per slot (B, 1) -> (logits (B, V) f32, cache); the cache is
    updated in place. On the card, from the second call on a cache, one
    replay of a one-step graph with a static token buffer (``graph`` as
    :func:`use_graph` says)."""
    _check_decode(cache, 1)
    if not use_graph(graph, token):
        return _decode_one(params, token, cache, cfg, qcfg), cache
    logits = graphs.run(cache, ("decode_step", cfg, qcfg),
                        lambda tok: _decode_one(params, tok, cache, cfg, qcfg),
                        (token,), reads=params)
    return logits, cache


def fresh_path_ok(params, cfg: ModelConfig, cache: KVCache,
                  qcfg: Optional[QuantConfig]) -> bool:
    """Whether the side-block decode can run (JAX :907-928): stacked
    layers, an int8 cache, no ALiBi (BLOOM's scores need the bias over
    absolute positions), and int8 per-token acts on both attention
    matmuls in every run of equal layers (``scan_segments``)."""
    if (params.get("layers_stacked") is None or not cache.quantized
            or cfg.pos_embedding == "alibi"):
        return False
    return all(ops is not None and acts_mode(ops.qk, ops.sv) is True
               for _, _, ops in scan_segments(cfg, qcfg))


def _fresh_attention(lp, cfg: ModelConfig, layer: int, x, cache: KVCache, fresh: FreshKV,
                     t: int, len0, ops: Optional[LayerOps], cos, sin, mode: str):
    """Side-block attention of one (B, 1, E) slice (JAX :501-653, the two
    non-append modes): B8 writes the token's codes at lane ``t``, then B7
    (``"two_part"``) or B6 with the side part in PyTorch (``"hybrid"``)
    attends over the read-only main rows ``< len0`` and lanes ``<= t``."""
    B = x.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    q, k, v = project_qkv(lp, cfg, x, ops, cos, sin)
    kc, ks = _quant_i8(k)                                  # (B, KV, 1, D), (B, KV, 1)
    vc, vs = _quant_i8(v)
    write_fresh(fresh, layer, t, *(a[:, :, 0].contiguous() for a in (kc, vc, ks, vs)))
    attend = decode_attention if mode == "two_part" else hybrid_decode_attention
    q4, scale = _i8_query(cfg, q)
    out = attend(q4, cache.k[layer], cache.v[layer],
                 cache.k_scale[layer], cache.v_scale[layer], len0, len0 + t,
                 cfg.layer_window(layer), t, fresh.layer(layer), scale=scale,
                 softcap=cfg.attn_logit_softcapping)
    out = out.to(x.dtype).reshape(B, 1, H * D)             # head h = kv * r + j
    return _o_proj(lp, out, ops)


def _forward_decode_fresh(params, cfg: ModelConfig, tokens, cache: KVCache, fresh: FreshKV,
                          t: int, len0, qcfg, mode: str):
    """Hidden states (B, 1, E) of step ``t`` at positions ``len0 + t``
    (JAX :760-904, non-append branches)."""
    positions = len0.long()[:, None] + t
    h = embed(params, cfg, tokens, positions)
    ropes = layer_ropes(cfg, positions)
    for i, lp in iter_layers(params):
        ops = layer_ops(cfg, qcfg, i)
        h = residual_block(lp, cfg, h, lambda xn: _fresh_attention(
            lp, cfg, i, xn, cache, fresh, t, len0, ops, *ropes[i], mode), ops)
    return h


def _greedy_steps(params, token, cache: KVCache, n: int, cfg: ModelConfig, qcfg,
                  attention: str):
    """The ``n`` steps of :func:`decode_greedy_steps`, with no host sync:
    the body of its graph, and its eager loop."""
    out = []
    if attention == "append":
        for _ in range(n):
            logits = _decode_one(params, token, cache, cfg, qcfg)
            token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            out.append(token)
        return torch.cat(out, dim=1)
    len0 = cache.lengths.clone()
    fresh = init_fresh(cfg.num_layers, cache.batch, n, cfg.num_kv_heads, cfg.head_dim,
                       device=cache.k.device)
    for t in range(n):
        h = _forward_decode_fresh(params, cfg, token, cache, fresh, t, len0, qcfg, attention)
        logits = head(params, cfg, h, qcfg)[:, -1, :]
        token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out.append(token)
    merge_fresh(cache, fresh, len0, n, check=False)    # checked by the caller
    return torch.cat(out, dim=1)


@torch.inference_mode()
def decode_greedy_steps(params, token: torch.Tensor, cache: KVCache, *, n: int,
                        cfg: ModelConfig, qcfg: Optional[QuantConfig] = None,
                        attention: str = "append", graph: Optional[bool] = None):
    """``n`` greedy decode steps -> (tokens (B, n) int32, cache).
    ``tokens[:, i]`` is the argmax after consuming ``token`` and ``i``
    generated predecessors.

    ``attention`` is the port's explicit form of the JAX package's
    import-time switches:

    * ``"append"`` (``LLMC_ATTN_APPEND=1``, the default): each step writes
      its K/V into the cache in place (B4 for the int8-codes attention);
    * ``"two_part"`` (``LLMC_ATTN_APPEND=0``): the cache stays read-only,
      step ``t`` goes to lane ``t`` of an ``n``-lane side block (B8), B7
      attends over ``[main | side]``, and :func:`merge_fresh` writes the
      block into the cache after the steps;
    * ``"hybrid"`` (``LLMC_ATTN_APPEND=0 LLMC_FUSED_ATTN=1``): as
      ``"two_part"``, but B6 takes the main window and PyTorch the side
      part and the assembly.

    BLOOM's ALiBi keeps its attention on the float path in every mode, as
    the JAX package keeps it on the carried cache under either switch: its
    side-block modes run the ``"append"`` steps. Otherwise the side-block
    modes raise ``ValueError`` where :func:`fresh_path_ok` is False. On the
    card the ``n`` steps are one CUDA graph kept on the cache: the first call for these buffers, ``n``, configs and mode runs
    eagerly, the second captures, later calls replay (``graph`` as
    :func:`use_graph` says; ``graph=False`` runs the eager loop, which
    decodes the same tokens and cache bitwise)."""
    if attention not in ATTENTION_MODES:
        raise ValueError(f"attention must be one of {ATTENTION_MODES}, not {attention!r}")
    if cfg.pos_embedding == "alibi":
        attention = "append"
    if attention != "append" and not fresh_path_ok(params, cfg, cache, qcfg):
        raise ValueError(f"attention={attention!r} needs stacked layers, an int8 cache and "
                         "int8 per-token acts on both attention matmuls")
    replay = use_graph(graph, token)
    with trace.span("engine.decode"):
        _check_decode(cache, n)
        if not replay:
            return _greedy_steps(params, token, cache, n, cfg, qcfg, attention), cache
        toks = graphs.run(cache, ("decode_greedy_steps", n, cfg, qcfg, attention),
                          lambda tok: _greedy_steps(params, tok, cache, n, cfg, qcfg, attention),
                          (token,), reads=params)
    return toks, cache


def top_k_filter(logits: torch.Tensor, top_k: Optional[int]) -> torch.Tensor:
    """Logits below the k-th largest of their row set to -inf (ties at the
    k-th value kept), as the JAX ``_sample`` does."""
    if top_k is None:
        return logits
    kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
    return torch.where(logits < kth, torch.full_like(logits, float("-inf")), logits)


def _sample(logits: torch.Tensor, temperature: float, top_k: Optional[int],
            generator: torch.Generator) -> torch.Tensor:
    """Reference sampling semantics: top-k filter, then a draw from
    softmax(logits / temperature), or the argmax at temperature 0. The
    draws come from ``generator`` (not the JAX package's random bits)."""
    logits = top_k_filter(logits, top_k)
    if temperature > 0.0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def generate(params, cfg: ModelConfig, prompt_tokens: np.ndarray, max_new_tokens: int = 100,
             temperature: float = 0.0, top_k: Optional[int] = None,
             eos_id: Optional[int] = None, qcfg: Optional[QuantConfig] = None,
             quantized_kv: bool = False, max_len: Optional[int] = None,
             seed: int = 0, graph: Optional[bool] = None) -> np.ndarray:
    """Autoregressive generation with a KV cache on the params' device (a
    bf16 cache, or int8 with ``quantized_kv``) of ``max_len`` rows (prompt
    + new tokens if None). Returns prompt + generated tokens (B, T_out)
    int32; stops early when slot 0 samples ``eos_id``. Each step is a
    :func:`decode_step` (``graph`` as there)."""
    dev = params["embed"]["weight"].device
    prompt_tokens = np.asarray(prompt_tokens, dtype=np.int32)
    B, T = prompt_tokens.shape
    cache = init_cache(cfg.num_layers, B, max_len or T + max_new_tokens, cfg.num_kv_heads,
                       cfg.head_dim, quantized=quantized_kv, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits, cache = prefill(params, torch.from_numpy(prompt_tokens).to(dev), cache,
                            cfg=cfg, qcfg=qcfg)
    out = [prompt_tokens]
    for _ in range(max_new_tokens):
        nxt = _sample(logits, temperature, top_k, gen).to(torch.int32)
        nxt_np = nxt.cpu().numpy()
        if eos_id is not None and int(nxt_np[0]) == eos_id:
            break
        out.append(nxt_np[:, None])
        logits, cache = decode_step(params, nxt[:, None], cache, cfg=cfg, qcfg=qcfg,
                                    graph=graph)
    return np.concatenate(out, axis=1)


CHAT_TEMPLATE = """Below is an instruction that describes a task.
Write a response that appropriately completes the request.

### Instruction:
{message}
"""


def generate_text(params, cfg: ModelConfig, tokenizer, prompt: str,
                  max_new_tokens: int = 100, temperature: float = 0.0,
                  top_k: Optional[int] = None, qcfg: Optional[QuantConfig] = None,
                  quantized_kv: bool = False, use_chat_template: bool = True,
                  speculative: bool = False, k_draft: int = 4) -> str:
    """Chat-templated text generation (the reference's tinychat path):
    ``tokenizer`` has ``encode``, ``decode(ids, skip_special_tokens=...)``
    and ``eos_token_id``. Returns the text after the prompt, without a
    "### Response:" marker. ``speculative`` routes greedy decoding through
    prompt-lookup speculative decoding (``engine/speculative.py``, taken at
    temperature 0 only), and logs its acceptance. Over a bf16 cache it
    gives greedy decoding's text, up to near-ties that a (k+1)-row forward
    rounds otherwise than a one-row one; over an int8 cache
    (``quantized_kv``) its tokens follow the verify step's float attention
    and can differ from those of the int8 decode (B4)."""
    text = CHAT_TEMPLATE.format(message=prompt) if use_chat_template else prompt
    ids = np.asarray([tokenizer.encode(text)], dtype=np.int32)
    if speculative and temperature == 0.0:
        from .speculative import generate_speculative

        hist, stats = generate_speculative(
            params, cfg, ids, max_new_tokens=max_new_tokens, k_draft=k_draft,
            eos_id=tokenizer.eos_token_id, qcfg=qcfg, quantized_kv=quantized_kv)
        LOGGER.info("speculative: mean_accepted=%.2f/%d over %d live rounds%s",
                    stats["mean_accepted"], k_draft, stats["live_rounds"],
                    " (fell back to greedy decode)" if stats["fell_back"] else "")
        out = np.asarray([hist[0]], dtype=np.int32)
    else:
        out = generate(params, cfg, ids, max_new_tokens=max_new_tokens,
                       temperature=temperature, top_k=top_k, eos_id=tokenizer.eos_token_id,
                       qcfg=qcfg, quantized_kv=quantized_kv)
    full = tokenizer.decode(out[0].tolist(), skip_special_tokens=True)
    return full[len(text):].replace("### Response:", "").strip()
