"""KV cache — bf16 or int8-quantized, per-slot lengths (port of
``engine/kvcache.py``).

Layout: (L, B, KV, S, D), one key row D contiguous values. The int8 cache
keeps codes plus one f32 scale per (token, head), (L, B, KV, S); the float
cache (bf16 unless asked otherwise) keeps the values and no scales. Under
tensor parallelism each rank's cache holds its own ``num_kv_heads /
n_model`` heads along axis 2 (``parallel/tp.py``). The JAX package
keeps the sequence on the TPU's lane axis, (L, B, KV, D, S) with
(L, B, KV, 1, S) scales; :func:`to_jax_layout` / :func:`from_jax_layout`
convert for the tests. Decode writes new tokens in place at each slot's
length (for the int8 cache with int8 attention acts, the decode kernel B4
does it) by default. A write at a position past the cache is dropped, as
the JAX package's scatter drops it, without a check that would wait for
the card: a retired batcher slot whose length reached ``max_len`` decodes
on with the others, and so may a verify step's last tokens.
:func:`write_slot` splices a single-slot cache into one slot (continuous
batching).

The side block (:class:`FreshKV`, JAX :150-261) serves the side-block
decode modes of ``decode_greedy_steps``: the main cache stays read-only
during the steps, step ``t``'s K/V land at lane ``t`` of a small per-call
block (kernel B8, :func:`write_fresh`), and :func:`merge_fresh` scatters
the block into the cache once after the steps. Its codes are (L, B, KV, W,
D), the JAX side block's own layout, and its scales (L, B, KV, W); the JAX
package keeps (L, B, KV, 1, W) scales (:func:`fresh_to_jax_layout` /
:func:`fresh_from_jax_layout`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.decode_attention import fresh_write
from .graph import Graphs


@dataclass
class KVCache:
    k: torch.Tensor                      # (L, B, KV, S, D) values, or int8 codes
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]      # (L, B, KV, S) f32 when quantized
    v_scale: Optional[torch.Tensor]
    lengths: torch.Tensor                # (B,) int32 — tokens cached per slot
    # the CUDA graphs captured on this cache (engine/graph.py), freed with it
    graphs: Graphs = field(default_factory=Graphs, init=False, repr=False, compare=False)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def batch(self) -> int:
        return self.k.shape[1]


def init_cache(n_layers: int, batch: int, max_len: int, n_kv: int, head_dim: int,
               quantized: bool = False, device=None, dtype=torch.bfloat16) -> KVCache:
    """A zeroed cache on ``device``: int8 codes and f32 scales with
    ``quantized``, else values in ``dtype`` (bf16, the JAX package's
    default; the tensor-parallel tests hold float32 configs with float32
    caches, as JAX's do)."""
    dev = resolve_device(device)
    shape = (n_layers, batch, n_kv, max_len, head_dim)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if quantized:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            lengths=lengths,
        )
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   k_scale=None, v_scale=None, lengths=lengths)


def _quant_i8(x: torch.Tensor):
    """(B, T, KV, D) -> int8 codes (B, KV, T, D) + scales (B, KV, T):
    absmax over the head dim times 1/127, clamped at 1e-8, round half to
    even. The JAX package computes this under ``jit``, where XLA turns the
    division by 127 into a multiplication by its f32 reciprocal; the port
    writes that multiplication out so that CPU, card and kernel agree."""
    x32 = x.float()
    scale = torch.clamp_min(torch.amax(torch.abs(x32), dim=-1) * (1.0 / 127.0), 1e-8)
    codes = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return codes.transpose(1, 2), scale.transpose(1, 2)


def append_prefill(cache: KVCache, layer: int, k, v, start) -> None:
    """Write k/v (B, T, KV, D) at positions [start, start + T) of every slot.
    ``start`` is a Python int (a slice), or a 0-d int64 device tensor, as
    the batcher's chunk graph takes it (``index_copy_`` along S: a capture
    cannot read a slice bound from the device); both write the same bits."""
    T = k.shape[1]
    if isinstance(start, int):
        put = lambda buf, x: buf[layer, :, :, start:start + T].copy_(x)
    else:
        rows = start + torch.arange(T, device=k.device)
        put = lambda buf, x: buf[layer].index_copy_(2, rows, x)
    for buf, scale_buf, x in ((cache.k, cache.k_scale, k), (cache.v, cache.v_scale, v)):
        if cache.quantized:
            c, s = _quant_i8(x)
            put(buf, c)
            put(scale_buf, s)
        else:
            put(buf, x.transpose(1, 2).to(buf.dtype))


def append_decode(cache: KVCache, layer: int, k, v, positions) -> None:
    """Write T tokens per slot: k/v (B, T, KV, D) at per-slot ``positions``,
    (B,) for one token or (B, T). Positions past the cache are dropped (JAX
    :105-132, whose scatter drops them): such a write lands on the last row
    with the value that row receives anyway, the slot's own write there or
    the row's current contents, so that no index leaves the cache and no
    host check waits for the device."""
    if positions.dim() == 1:
        positions = positions[:, None]
    B, T = positions.shape
    S = cache.max_len
    b = torch.arange(B, device=k.device)
    pos = positions.long()
    keep = pos < S
    at_last = keep & (pos == S - 1)
    has_last, t_last = at_last.any(1), at_last.int().argmax(1)      # (B,)
    target = torch.where(keep, pos, S - 1)

    def put(buf, val):
        """val (B, T, KV[, D]) into buf[layer] at (b, target)."""
        tail = (1,) * (val.dim() - 2)
        last = torch.where(has_last.view(B, *tail), val[b, t_last], buf[layer, :, :, S - 1])
        val = torch.where(keep.view(B, T, *tail), val, last[:, None])
        # advanced indices on (B, S) around a slice: the target is (B, T, KV[, D])
        buf[layer, b[:, None], :, target] = val

    for buf, scale_buf, x in ((cache.k, cache.k_scale, k), (cache.v, cache.v_scale, v)):
        if cache.quantized:
            c, s = _quant_i8(x)
            put(buf, c.transpose(1, 2))
            put(scale_buf, s.transpose(1, 2))
        else:
            put(buf, x.to(buf.dtype))


def write_slot(cache: KVCache, slot: int, k_slot, v_slot, k_scale=None, v_scale=None) -> None:
    """Splice one slot's K/V, (L, KV, T, D) values or codes of the cache's
    dtype, into rows [0, T) of slot ``slot``, in place (JAX :264-273); for
    the int8 cache also its scales (L, KV, T), as the JAX batcher splices
    them beside it (``engine/batching.py:205-214``). Lengths are the
    caller's."""
    T = k_slot.shape[2]
    if T > cache.max_len:
        raise ValueError(f"a slot of {T} rows does not fit the cache (max_len {cache.max_len})")
    if (k_scale is not None) != cache.quantized:
        raise ValueError("scales go with an int8 cache, and only with it")
    cache.k[:, slot, :, :T] = k_slot.to(cache.k.dtype)
    cache.v[:, slot, :, :T] = v_slot.to(cache.v.dtype)
    if cache.quantized:
        cache.k_scale[:, slot, :, :T] = k_scale
        cache.v_scale[:, slot, :, :T] = v_scale


def read(cache: KVCache, layer: int, dtype) -> tuple:
    """(B, KV, S, D) K and V of one layer in ``dtype`` (dequantized for the
    int8 cache)."""
    k, v = cache.k[layer], cache.v[layer]
    if cache.quantized:
        k = k.float() * cache.k_scale[layer][..., None]
        v = v.float() * cache.v_scale[layer][..., None]
    return k.to(dtype), v.to(dtype)


def to_jax_layout(cache: KVCache) -> dict:
    """numpy arrays in the JAX package's layout: codes or values (L, B, KV,
    D, S) — a float cache as float32, which holds bf16 exactly — scales
    (L, B, KV, 1, S) or None, lengths (B,)."""
    vals = lambda t: (t if cache.quantized else t.float()).transpose(-1, -2).cpu().numpy()
    scales = lambda t: None if t is None else t[..., None, :].cpu().numpy()
    return {"k": vals(cache.k), "v": vals(cache.v), "k_scale": scales(cache.k_scale),
            "v_scale": scales(cache.v_scale), "lengths": cache.lengths.cpu().numpy()}


def from_jax_layout(k, v, k_scale, v_scale, lengths, device=None) -> KVCache:
    """Inverse of :func:`to_jax_layout` (numpy arrays in); a float cache
    (no scales; float32 or the JAX cache's own bf16 arrays) is stored in
    bf16."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lens = t(np.asarray(lengths, np.int32))
    if k_scale is None:
        vals = lambda a: t(np.swapaxes(np.asarray(a, np.float32), -1, -2)).to(torch.bfloat16)
        return KVCache(k=vals(k), v=vals(v), k_scale=None, v_scale=None, lengths=lens)
    return KVCache(
        k=t(np.swapaxes(k, -1, -2)), v=t(np.swapaxes(v, -1, -2)),
        k_scale=t(k_scale[..., 0, :]), v_scale=t(v_scale[..., 0, :]), lengths=lens,
    )


@dataclass
class FreshKV:
    """Per-call side block of an int8 cache: codes (L, B, KV, W, D), one
    f32 scale per (token, head) (L, B, KV, W); lane ``j`` holds decode step
    ``j`` of the call."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @property
    def window(self) -> int:
        return self.k.shape[3]

    def layer(self, i: int) -> tuple:
        """Layer ``i``'s (k, v, k_scale, v_scale) views."""
        return self.k[i], self.v[i], self.k_scale[i], self.v_scale[i]


def init_fresh(n_layers: int, batch: int, window: int, n_kv: int, head_dim: int,
               device=None) -> FreshKV:
    """A zeroed int8 side block of ``window`` lanes (the port's side-block
    decode runs over an int8 cache only, as the JAX package's does)."""
    dev = resolve_device(device)
    shape = (n_layers, batch, n_kv, window, head_dim)
    zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=dev)
    return FreshKV(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                   k_scale=zeros(shape[:-1], torch.float32),
                   v_scale=zeros(shape[:-1], torch.float32))


def write_fresh(fresh: FreshKV, layer: int, t: int, kc, vc, ks, vs) -> None:
    """Write one step's codes kc/vc (B, KV, D) int8 and scales ks/vs (B, KV)
    f32 at (layer, lane t), in place: kernel B8 on CUDA tensors, its plain
    version on CPU tensors."""
    fresh_write((fresh.k, fresh.v, fresh.k_scale, fresh.v_scale), (kc, vc, ks, vs), layer, t)


def merge_fresh(cache: KVCache, fresh: FreshKV, lengths0: torch.Tensor, n: int,
                check: bool = True) -> None:
    """Scatter side-block steps [0, n) of every layer into the cache at each
    slot's positions ``lengths0 + j`` and set ``lengths`` to ``lengths0 +
    n``, in place. With ``check``, positions past the cache raise, which
    waits for the device; a caller that has checked the lengths already
    (``decode_greedy_steps``, once per call, before a CUDA graph's capture)
    passes False."""
    if n > fresh.window:
        raise ValueError(f"{n} steps do not fit a side block of {fresh.window} lanes")
    if check and int(lengths0.max()) + n > cache.max_len:
        raise ValueError(f"merging {n} steps overruns the cache (max_len {cache.max_len})")
    b = torch.arange(cache.batch, device=lengths0.device)[:, None]
    pos = lengths0.long()[:, None] + torch.arange(n, device=lengths0.device)[None, :]
    # advanced indices on (B, S) around a slice: the target is (B, n, L, KV[, D])
    cache.k[:, b, :, pos] = fresh.k[:, :, :, :n].permute(1, 3, 0, 2, 4)
    cache.v[:, b, :, pos] = fresh.v[:, :, :, :n].permute(1, 3, 0, 2, 4)
    cache.k_scale[:, b, :, pos] = fresh.k_scale[..., :n].permute(1, 3, 0, 2)
    cache.v_scale[:, b, :, pos] = fresh.v_scale[..., :n].permute(1, 3, 0, 2)
    cache.lengths.copy_(lengths0 + n)


def fresh_to_jax_layout(fresh: FreshKV) -> dict:
    """numpy arrays in the JAX side block's layout: codes (L, B, KV, W, D),
    scales (L, B, KV, 1, W)."""
    return {"k": fresh.k.cpu().numpy(), "v": fresh.v.cpu().numpy(),
            "k_scale": fresh.k_scale[..., None, :].cpu().numpy(),
            "v_scale": fresh.v_scale[..., None, :].cpu().numpy()}


def fresh_from_jax_layout(k, v, k_scale, v_scale, device=None) -> FreshKV:
    """Inverse of :func:`fresh_to_jax_layout` (numpy arrays in)."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return FreshKV(k=t(k), v=t(v), k_scale=t(k_scale[..., 0, :]), v_scale=t(v_scale[..., 0, :]))
