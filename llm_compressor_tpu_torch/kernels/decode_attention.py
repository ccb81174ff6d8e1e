"""Fused-append int8-KV decode attention (port of
``kernels/decode_attention.py::decode_attention_append``), kernel B4.

The cache layer is (B, KV, S, D) int8 codes with (B, KV, S) f32 scales, so
one key row is D contiguous bytes. The wrapper writes the current token's
codes and scales at ``pos[b]`` in place, then attends over the window
``[0, pos]`` (or its last ``window`` positions). Math, as in the JAX
kernel's slim epilogue (``engine/generate.py::_i8_softmax_requant``):

    qi, qs = row_quant_i8(q)                         per query row
    s      = ((float(qi . k) * qs) * k_scale) * scale, softcapped, masked
    e      = exp(s - rowmax(s));  w = e * v_scale
    a      = max(rowmax(w) * (1/127), 1e-8);  pi = clip(round(w / a), +-127)
    out    = float(pi . v) * (a / sum(e))

CUDA tensors launch ``csrc/decode_attention.cu`` or raise; CPU tensors run
:func:`decode_attention_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e9
# q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale, pos,
# out; B, KV, r, D, S, window; scale, softcap; has_softcap
_launch = _build.c_launcher(
    "decode_attention", "llmc_decode_attention_append",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int])


def row_quant_i8(x: torch.Tensor):
    """(.., D) f32 -> int8 codes + per-row scale (absmax * (1/127), >= 1e-8).

    The JAX kernel runs under ``jit``, where XLA turns the division by 127
    into a multiplication by its f32 reciprocal; the port writes that out,
    here and in the CUDA kernel, so that both agree on every device."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax * (1.0 / 127.0), 1e-8)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def _append(new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale, pos):
    b = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[b, :, pos] = new_k
    v_cache[b, :, pos] = new_v
    k_scale[b, :, pos] = new_ks
    v_scale[b, :, pos] = new_vs


def decode_attention_plain(q, new_k, new_v, new_ks, new_vs, k_cache, v_cache,
                           k_scale, v_scale, pos, *, window: int = 0,
                           scale: float, softcap: Optional[float] = None):
    """Plain version of B4 (same arguments as :func:`decode_attention_append`)."""
    _append(new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale, pos)
    S = k_cache.shape[2]
    qi, qs = row_quant_i8(q)                                   # (B, KV, r, D)
    # integer dots in float64: exact for any window this cache can hold
    s32 = torch.einsum("bkrd,bksd->bkrs", qi.double(), k_cache.double()).float()
    s = s32 * qs * k_scale[:, :, None, :] * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    s_ids = torch.arange(S, device=q.device)[None, :]
    p = pos.long()[:, None]
    keep = s_ids <= p
    if window > 0:
        keep &= s_ids > p - window
    s = torch.where(keep[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    sum_row = e.sum(dim=-1, keepdim=True)
    w = e * v_scale[:, :, None, :]
    a = torch.clamp_min(torch.amax(w, dim=-1, keepdim=True) * (1.0 / 127.0), 1e-8)
    pi = torch.clamp(torch.round(w / a), -127, 127)
    o32 = torch.einsum("bkrs,bksd->bkrd", pi.double(), v_cache.double()).float()
    return o32 * (a / sum_row)


def _check(q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale, pos):
    B, KV, r, D = q.shape
    if q.dtype != torch.float32:
        raise ValueError("q must be float32 (B, KV, r, D)")
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8 \
            or k_cache.dim() != 4 or k_cache.shape[:2] != (B, KV) \
            or k_cache.shape[3] != D or v_cache.shape != k_cache.shape:
        raise ValueError("caches must be int8 (B, KV, S, D) matching q")
    S = k_cache.shape[2]
    for t, shp, dt in ((new_k, (B, KV, D), torch.int8), (new_v, (B, KV, D), torch.int8),
                       (new_ks, (B, KV), torch.float32), (new_vs, (B, KV), torch.float32),
                       (k_scale, (B, KV, S), torch.float32),
                       (v_scale, (B, KV, S), torch.float32), (pos, (B,), torch.int32)):
        if tuple(t.shape) != shp or t.dtype != dt:
            raise ValueError(f"expected {dt} {shp}, got {t.dtype} {tuple(t.shape)}")
    tensors = (q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale, pos)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("tensors on different devices")
    if q.is_cuda:
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("kernel inputs must be contiguous")
        if r > 8 or D > 256 or D % 4:
            raise ValueError(f"kernel supports r <= 8 and D <= 256, D % 4 == 0 (r={r}, D={D})")


def decode_attention_append(q, new_k, new_v, new_ks, new_vs, k_cache, v_cache,
                            k_scale, v_scale, pos, *, window: int = 0,
                            scale: float, softcap: Optional[float] = None):
    """q (B, KV, r, D) f32 -> attention output (B, KV, r, D) f32.

    ``new_k``/``new_v`` (B, KV, D) int8 and ``new_ks``/``new_vs`` (B, KV)
    f32 are the current token, written at ``pos`` (B,) int32 into one
    layer's cache: ``k_cache``/``v_cache`` (B, KV, S, D) int8 and
    ``k_scale``/``v_scale`` (B, KV, S) f32, in place. ``pos[b]`` must be
    below S: on the CPU a position outside the cache raises; on the card
    (where checking would wait for the device) the kernel writes nothing
    for that slot and returns NaN. ``window`` <= 0 is full causal
    attention."""
    _check(q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale, pos)
    if not q.is_cuda:
        return decode_attention_plain(
            q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale,
            pos, window=window, scale=scale, softcap=softcap)
    B, KV, r, D = q.shape
    S = k_cache.shape[2]
    out = torch.empty_like(q)
    _launch(q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), new_ks.data_ptr(),
            new_vs.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), pos.data_ptr(), out.data_ptr(),
            B, KV, r, D, S, int(window), float(scale),
            float(softcap) if softcap is not None else 0.0, int(softcap is not None))
    decode_attention_append.launches += 1
    return out


decode_attention_append.launches = 0
