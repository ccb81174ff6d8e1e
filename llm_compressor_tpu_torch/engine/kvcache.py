"""KV cache — bf16 or int8-quantized, per-slot lengths (port of
``engine/kvcache.py``).

Layout: (L, B, KV, S, D), one key row D contiguous values. The int8 cache
keeps codes plus one f32 scale per (token, head), (L, B, KV, S); the bf16
cache keeps the values and no scales. The JAX package
keeps the sequence on the TPU's lane axis, (L, B, KV, D, S) with
(L, B, KV, 1, S) scales; :func:`to_jax_layout` / :func:`from_jax_layout`
convert for the tests. Decode writes new tokens in place at each slot's
length (for the int8 cache with int8 attention acts, the decode kernel B4
does it); the JAX package's side block for new tokens and its merge are
TPU workarounds that the port does not need.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


@dataclass
class KVCache:
    k: torch.Tensor                      # (L, B, KV, S, D) values, or int8 codes
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]      # (L, B, KV, S) f32 when quantized
    v_scale: Optional[torch.Tensor]
    lengths: torch.Tensor                # (B,) int32 — tokens cached per slot

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
               quantized: bool = False, device=None) -> KVCache:
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
    return KVCache(k=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                   v=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
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


def append_prefill(cache: KVCache, layer: int, k, v, start: int) -> None:
    """Write k/v (B, T, KV, D) at positions [start, start + T) of every slot."""
    T = k.shape[1]
    for buf, scale_buf, x in ((cache.k, cache.k_scale, k), (cache.v, cache.v_scale, v)):
        if cache.quantized:
            c, s = _quant_i8(x)
            buf[layer, :, :, start:start + T] = c
            scale_buf[layer, :, :, start:start + T] = s
        else:
            buf[layer, :, :, start:start + T] = x.transpose(1, 2).to(buf.dtype)


def append_decode(cache: KVCache, layer: int, k, v, positions) -> None:
    """Write T tokens per slot: k/v (B, T, KV, D) at per-slot ``positions``,
    (B,) for one token or (B, T)."""
    if positions.dim() == 1:
        positions = positions[:, None]
    b = torch.arange(cache.batch, device=k.device)[:, None]
    pos = positions.long()
    for buf, scale_buf, x in ((cache.k, cache.k_scale, k), (cache.v, cache.v_scale, v)):
        # advanced indices on (B, S) around a slice: the target is (B, T, KV, D)
        if cache.quantized:
            c, s = _quant_i8(x)
            buf[layer, b, :, pos] = c.transpose(1, 2)
            scale_buf[layer, b, :, pos] = s.transpose(1, 2)
        else:
            buf[layer, b, :, pos] = x.to(buf.dtype)


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
