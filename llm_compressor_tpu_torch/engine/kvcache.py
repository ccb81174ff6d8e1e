"""int8 KV cache with per-slot lengths (port of ``engine/kvcache.py``).

Layout: codes (L, B, KV, S, D) int8, scales (L, B, KV, S) f32 — one key
row is D contiguous bytes, which the decode kernel reads as words. The JAX
package keeps the sequence on the TPU's lane axis, (L, B, KV, D, S) with
(L, B, KV, 1, S) scales; :func:`to_jax_layout` / :func:`from_jax_layout`
convert for the tests. Decode writes new tokens in place at each slot's
length (the decode kernel does it); the JAX package's side block for new
tokens and its merge are TPU workarounds that the port does not need.
The bf16 cache is not ported (ROADMAP.md, queue A item 5).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


@dataclass
class KVCache:
    k: torch.Tensor          # (L, B, KV, S, D) int8 codes
    v: torch.Tensor
    k_scale: torch.Tensor    # (L, B, KV, S) f32
    v_scale: torch.Tensor
    lengths: torch.Tensor    # (B,) int32 — tokens cached per slot

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def init_cache(n_layers: int, batch: int, max_len: int, n_kv: int, head_dim: int,
               device=None) -> KVCache:
    dev = resolve_device(device)
    shape = (n_layers, batch, n_kv, max_len, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=dev),
        v=torch.zeros(shape, dtype=torch.int8, device=dev),
        k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


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
    for codes_buf, scale_buf, x in ((cache.k, cache.k_scale, k), (cache.v, cache.v_scale, v)):
        c, s = _quant_i8(x)
        codes_buf[layer, :, :, start:start + T] = c
        scale_buf[layer, :, :, start:start + T] = s


def read(cache: KVCache, layer: int, dtype) -> tuple:
    """Dequantized (B, KV, S, D) K and V of one layer."""
    k = (cache.k[layer].float() * cache.k_scale[layer][..., None]).to(dtype)
    v = (cache.v[layer].float() * cache.v_scale[layer][..., None]).to(dtype)
    return k, v


def to_jax_layout(cache: KVCache) -> dict:
    """numpy arrays in the JAX package's layout: codes (L, B, KV, D, S),
    scales (L, B, KV, 1, S), lengths (B,)."""
    return {
        "k": cache.k.transpose(-1, -2).cpu().numpy(),
        "v": cache.v.transpose(-1, -2).cpu().numpy(),
        "k_scale": cache.k_scale[..., None, :].cpu().numpy(),
        "v_scale": cache.v_scale[..., None, :].cpu().numpy(),
        "lengths": cache.lengths.cpu().numpy(),
    }


def from_jax_layout(k, v, k_scale, v_scale, lengths, device=None) -> KVCache:
    """Inverse of :func:`to_jax_layout` (numpy arrays in)."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return KVCache(
        k=t(np.swapaxes(k, -1, -2)), v=t(np.swapaxes(v, -1, -2)),
        k_scale=t(k_scale[..., 0, :]), v_scale=t(v_scale[..., 0, :]),
        lengths=t(np.asarray(lengths, np.int32)),
    )
