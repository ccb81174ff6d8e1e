"""Tensor-parallel serving with explicit collectives (port of
``parallel/tp.py``).

Each rank of the model group holds its shard and runs the port's own code
and kernels on it, Megatron-style:

* column-parallel q/k/v/gate/up/fc1: the output dim is sharded, the
  activations leave head-sharded, no collective;
* row-parallel o/down/fc2: the contraction dim is sharded; the local
  product is a partial sum, all-reduced over the model group once per
  projection (``models.layers.tp_trace`` drives it inside ``qlinear``);
* the per-token act scale of a row-parallel input is the absmax over the
  whole row (an all-reduce of the max), so the int8 codes are a single
  device's;
* the KV cache holds this rank's KV heads (axis 2 of the port's (L, B, KV,
  S, D)), and its batch over "data" (:func:`tp_serve_fns`);
* an ``lm_head`` is vocab-sharded and the logits are gathered over the
  model group; a tied head (the embedding) is replicated.

A packed QTensor leaf is cut to its local block and rebuilt with its local
shapes, so the kernels (``kernels/w4a8_matmul.weight_dims``, B5's dims)
run on the shard as they would on a model of that size. Serving-fused
``qkv_cat`` / ``gateup`` params shard only in the per-shard interleaved
layout of ``fuse_model(..., shards=n_model)``, declared with
``fused=True``. BLOOM's fused query_key_value is stored per head
interleaved, so a contiguous block of rows is a block of heads; its ALiBi
slopes are those of the global heads (``models.layers.alibi_bias``).
Head and FFN counts must divide by ``n_model``.

The functions return, on every rank, what the JAX package's global array
holds: (B, vocab) logits, the vocab gathered over "model" and, for
:func:`tp_serve_fns`, the batch over "data".

JAX jits both program pairs under ``shard_map`` (JAX :235-248, :299-312).
The port's counterpart is a CUDA graph a rank (``engine/graph.py``): where
every rank of the group has a card of its own, over NCCL
(:func:`graphs_ok`), ``tp_serve_fns``' decode step and both programs of
the TP batcher replay one graph on each rank's card, its collectives
(the act absmax's and the row-parallel sums' all-reduces, the logits'
all-gather into one preallocated tensor) captured inside. Each graph is
keyed by the model group as well as by its buffers. Every rank runs the
same calls in the same order, so each makes its eager first call, whose
collectives set NCCL's communicator up, before any rank captures, and the
ranks' replays launch matching collectives. Over gloo (ranks that share a
card, or the CPU) the steps run eagerly: a capture cannot hold a gloo
collective, which stages through the host.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch
import torch.distributed as dist

from ..engine import graph as graphs
from ..engine.batching import _decode_all, _prefill_chunk
from ..engine.generate import _check_decode, _decode_one, prefill, use_graph
from ..engine.kvcache import KVCache, init_cache
from ..models.config import ModelConfig
from ..models.layers import tp_trace
from ..models.transformer import forward
from ..qformats.config import QuantConfig
from ..qformats.qtensor import QTensor, to_group_halves
from .mesh import (
    axis_group,
    axis_size,
    data_sharding,
    mesh_coords,
    shard_tree,
    tree_map_with_path,
)

_COL_SLOTS = ("q", "k", "v", "gate", "up", "fc1")
_ROW_SLOTS = ("o", "down", "fc2")
_PLAIN_FUSED = ("serving-fused qkv_cat/gateup params require fuse_model(shards=n_model) + "
                "fused=True (per-shard interleaved layout); plain fused params cannot TP-shard")


def tp_supported(cfg: ModelConfig, n_model: int) -> bool:
    """Only head and FFN divisibility is needed (ALiBi and BLOOM's fused
    qkv shard as the module doc says)."""
    return (cfg.num_heads % n_model == 0 and cfg.num_kv_heads % n_model == 0
            and cfg.intermediate_size % n_model == 0)


def _leaf_spec(path, leaf, n_model: int, fused: bool = False) -> tuple:
    """The spec of one serving-param leaf (JAX :62-126); stacked layers
    keep their leading L axis whole. ``fused`` allows ``qkv_cat`` /
    ``gateup`` built by ``fuse_model(shards=n_model)``."""
    keys = list(path)
    lead = [None] if "layers_stacked" in keys else []
    for i, k in enumerate(keys):
        if k in ("attn", "mlp") and i + 1 < len(keys):
            slot, leafname = keys[i + 1], keys[-1]
            if slot in ("qkv_cat", "gateup") and not fused:
                raise ValueError(_PLAIN_FUSED)
            if slot in ("q_norm", "k_norm"):
                return ()
            col = slot in _COL_SLOTS or slot in ("qkv_cat", "gateup", "qkv")
            row = slot in _ROW_SLOTS
            if not (col or row):
                return ()
            nd = leaf.dim() - len(lead)
            if leafname in ("codes", "scales", "zeros"):
                # flat (N, G * gp): a column slot shards N, a row slot G
                ax = len(lead) + (0 if col else 1)
                if leaf.shape[ax] % n_model:
                    raise ValueError(f"{slot} QTensor axis {ax} not divisible by "
                                     f"model={n_model}")
                spec = [None] * nd
                spec[0 if col else 1] = "model"
                return tuple(lead + spec)
            if leafname == "bias":
                return tuple(lead + ["model"]) if col else ()
            if nd == 2:
                return tuple(lead + (["model", None] if col else [None, "model"]))
            return ()
    if "lm_head" in keys and keys[-1] in ("weight", "codes", "scales", "zeros", "bias"):
        return ("model",) + (None,) * (leaf.dim() - 1)   # vocab-sharded
    return ()


def tp_param_specs(params, n_model: int, fused: bool = False):
    """The spec tree of serving params (stacked or per layer), in the shape
    of ``mesh.tree_map_with_path``."""
    return tree_map_with_path(lambda p, leaf: _leaf_spec(p, leaf, n_model, fused), params)


def tp_cache_specs(cache: KVCache) -> KVCache:
    """KV heads over "model", batch over "data": codes or values (L, B, KV,
    S, D), scales (L, B, KV, S), lengths (B,)."""
    kv, sc = (None, "data", "model", None, None), (None, "data", "model", None)
    return KVCache(k=kv, v=kv, k_scale=sc if cache.quantized else None,
                   v_scale=sc if cache.quantized else None, lengths=("data",))


def tp_init_cache(cfg: ModelConfig, mesh, batch: int, max_len: int, quantized: bool = True,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    """This rank's cache of the global ``batch``: its slice of the slots
    and its ``num_kv_heads / n_model`` heads."""
    n_data, n_model = axis_size(mesh, "data"), axis_size(mesh, "model")
    if batch % n_data or cfg.num_kv_heads % n_model:
        raise ValueError(f"batch {batch} / kv heads {cfg.num_kv_heads} do not divide over the "
                         f"{n_data} x {n_model} mesh")
    return init_cache(cfg.num_layers, batch // n_data, max_len, cfg.num_kv_heads // n_model,
                      cfg.head_dim, quantized=quantized, device=device, dtype=dtype)


def _unpair_odd_row_shards(params, n_model: int):
    """Pair-planes int4 QTensors of a row-parallel slot (o/down/fc2, the
    contraction dim sharded) in the group-halves layout where a rank would
    hold an ODD number of groups: a pair's two groups share each byte, so
    a byte block that ends between them is no layout of its groups. Column
    slots shard N and keep their pair planes."""
    def walk(node, slot=None):
        if isinstance(node, QTensor):
            if (slot in _ROW_SLOTS and node.pair_planes
                    and (node.scales.shape[-1] // max(n_model, 1)) % 2):
                return to_group_halves(node)
            return node
        if isinstance(node, dict):
            return {k: walk(v, k if k in _ROW_SLOTS else slot) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, slot) for v in node]
        return node

    return walk(params)


def tp_shard_params(params, cfg: ModelConfig, mesh, fused: bool = False):
    """This rank's shard of serving params (stacked or per layer).
    ``fused=True`` declares ``fuse_model(shards=n_model)`` params."""
    n_model = axis_size(mesh, "model")
    params = _unpair_odd_row_shards(params, n_model)
    specs = tp_param_specs(params, n_model, fused)
    return shard_tree(params, specs, mesh_coords(mesh))


def _check_fused(params, fused: bool) -> None:
    """Refuse serving-fused params not declared ``fused`` (a rank's block
    of plain fused rows is no [q_s | k_s | v_s])."""
    st = params.get("layers_stacked")
    layers = [st] if st is not None else params.get("layers", [])
    if not fused and any("qkv_cat" in lp["attn"] or "gateup" in lp["mlp"] for lp in layers):
        raise ValueError(_PLAIN_FUSED)


def _local_cfg(cfg: ModelConfig, n_model: int) -> ModelConfig:
    return replace(cfg, num_heads=cfg.num_heads // n_model,
                   num_kv_heads=cfg.num_kv_heads // n_model)


GRAPHS_NEED = ("a CUDA graph of a tensor-parallel step needs NCCL with a card a rank: over "
               "gloo (ranks that share a card, or the CPU) the step runs eagerly (graph=None "
               "or False)")

# PyTorch's newer name of ``all_gather_into_tensor``, which it deprecates
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def graphs_ok(mesh) -> bool:
    """Whether the mesh's model group can run a TP step as a CUDA graph:
    it runs over NCCL, which ``launch.pick_backend`` chooses only when
    every rank has a card of its own."""
    return dist.get_backend(axis_group(mesh, "model")) == "nccl"


def _gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The blocks of ``x`` of the ``n`` ranks of ``group``, in rank order,
    concatenated along ``dim``: one all-gather into a tensor allocated
    here, which a CUDA graph's capture can hold."""
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather_single(out, x, group=group)
    return torch.cat(out.view(n, *x.shape).unbind(0), dim=dim)


def _vocab_sharded(params, cfg: ModelConfig) -> bool:
    """Whether this rank holds a block of the head's rows (an ``lm_head``
    cut over "model"), not the whole vocab."""
    lm = params.get("lm_head")
    return lm is not None and lm["weight"].shape[0] != cfg.vocab_size


class _ModelGroup:
    """A model group's view of one mesh: its size, group, the local config
    and whether the logits come back vocab-sharded."""

    def __init__(self, params, cfg: ModelConfig, mesh):
        self.n = axis_size(mesh, "model")
        if not tp_supported(cfg, self.n):
            raise ValueError(f"arch {cfg.arch} not TP-shardable over {self.n}")
        self.group = axis_group(mesh, "model")
        self.lcfg = _local_cfg(cfg, self.n)
        self.vocab_sharded = _vocab_sharded(params, cfg)

    def trace(self):
        return tp_trace(self.group, self.n)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Local logits (..., V / n) or (..., V) -> (..., V)."""
        return _gather(x, -1, self.group, self.n) if self.vocab_sharded else x


def tp_forward(params, cfg: ModelConfig, mesh, tokens: torch.Tensor,
               qcfg: Optional[QuantConfig] = None) -> torch.Tensor:
    """``models.forward`` over this rank's shard (``mesh.shard_params`` or
    :func:`tp_shard_params`): the global tokens (B, T) in, this rank's
    batch slice through the model, the f32 logits (B, T, vocab) out on
    every rank. The explicit counterpart of the JAX package's jitted
    ``forward`` over GSPMD-placed params."""
    tp = _ModelGroup(params, cfg, mesh)
    with tp.trace():
        logits = forward(params, tp.lcfg, data_sharding(mesh, tokens), qcfg)
    return _gather(tp.logits(logits), 0, axis_group(mesh, "data"), axis_size(mesh, "data"))


def tp_serve_fns(params, cfg: ModelConfig, mesh, qcfg: Optional[QuantConfig] = None,
                 fused: bool = False, graph: Optional[bool] = None):
    """(prefill_fn, decode_fn) over this rank's shard.

    ``prefill_fn(p, tokens, cache)`` and ``decode_fn(p, token, cache)``
    take the global tokens (B, T) / (B, 1) and this rank's cache
    (:func:`tp_init_cache`); each returns the last position's logits (B,
    vocab) f32 on every rank and the cache, updated in place. ``params``
    is this rank's shard (``tp_shard_params``).

    ``graph``: by default the decode step, its gathers included, replays
    one CUDA graph kept on the cache where :func:`graphs_ok` (NCCL, a card
    a rank; the first call on a cache runs eagerly, the second captures),
    and runs eagerly otherwise; ``graph=True`` over gloo raises
    ``ValueError``, ``graph=False`` runs eagerly, bitwise the same."""
    tp = _ModelGroup(params, cfg, mesh)
    _check_fused(params, fused)
    data_group, n_data = axis_group(mesh, "data"), axis_size(mesh, "data")
    ok = graphs_ok(mesh)
    if graph and not ok:
        raise ValueError(GRAPHS_NEED)
    key = ("tp_decode_step", tp.lcfg, qcfg, tp.group, data_group)

    def _out(logits):
        return _gather(tp.logits(logits), 0, data_group, n_data)

    def prefill_fn(p, tokens, cache):
        with tp.trace():
            logits, cache = prefill(p, data_sharding(mesh, tokens), cache, cfg=tp.lcfg, qcfg=qcfg)
        return _out(logits), cache

    def step(p, token, cache):
        with tp.trace():
            return _out(_decode_one(p, token, cache, tp.lcfg, qcfg))

    def decode_fn(p, token, cache):
        token = data_sharding(mesh, token)
        _check_decode(cache, 1)
        if not (ok and use_graph(graph, token)):
            with torch.inference_mode():
                return step(p, token, cache), cache
        return graphs.run(cache, key, lambda tok: step(p, tok, cache), (token,), reads=p), cache

    return prefill_fn, decode_fn


def tp_batch_cache_specs(cache: KVCache) -> KVCache:
    """Cache specs of tensor-parallel continuous batching: KV heads over
    "model", the slots REPLICATED (the host schedules them; data-parallel
    serving runs one batcher per replica)."""
    kv, sc = (None, None, "model", None, None), (None, None, "model", None)
    return KVCache(k=kv, v=kv, k_scale=sc if cache.quantized else None,
                   v_scale=sc if cache.quantized else None, lengths=())


def tp_batch_fns(params, cfg: ModelConfig, mesh, qcfg: Optional[QuantConfig] = None,
                 fused: bool = False):
    """(chunk_prefill_fn, decode_all_fn) of ``ContinuousBatcher`` over this
    rank's shard, the two device programs of ``engine/batching.py``:

    * ``chunk_prefill_fn(p, tokens, mini, start, last_idx)`` -> the logits
      (1, vocab) at chunk row ``last_idx``;
    * ``decode_all_fn(p, tokens, cache, active)`` -> logits (B, vocab).

    Both update the cache in place; the logits are whole on every rank."""
    tp = _ModelGroup(params, cfg, mesh)
    _check_fused(params, fused)

    def chunk_prefill_fn(p, tokens, mini, start, last_idx):
        with tp.trace():
            last = _prefill_chunk(p, tokens, mini, start, last_idx, cfg=tp.lcfg, qcfg=qcfg)
        return tp.logits(last)

    def decode_all_fn(p, tokens, cache, active):
        with tp.trace(), torch.inference_mode():
            logits = _decode_all(p, tokens, cache, active, cfg=tp.lcfg, qcfg=qcfg)
        return tp.logits(logits)

    return chunk_prefill_fn, decode_all_fn
