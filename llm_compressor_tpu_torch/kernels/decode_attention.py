"""int8-KV decode attention (port of ``kernels/decode_attention.py``):
kernels B4, B6, B7 and B8.

The cache layer is (B, KV, S, D) int8 codes with (B, KV, S) f32 scales, so
one key row is D contiguous bytes; the side block of the side-block decode
(``engine/kvcache.py::FreshKV``) holds one layer as (B, KV, W, D) codes
with (B, KV, W) scales. Math, as in the JAX kernels' slim epilogue
(``engine/generate.py::_i8_softmax_requant``), over one or two parts:

    qi, qs = row_quant_i8(q)                         per query row
    s      = ((float(qi . k) * qs) * k_scale) * scale, softcapped, masked
    e      = exp(s - rowmax(s));  w = e * v_scale
    a      = max(rowmax(w) * (1/127), 1e-8);  pi = clip(round(w / a), +-127)
    out    = float(pi . v) * (a / sum(e))

* B4 :func:`decode_attention_append` writes the current token's codes at
  ``pos`` in place, then attends over the window ``[0, pos]``;
* B7 :func:`decode_attention` attends read-only over ``[main | side]``:
  main rows ``s < main_len``, side lanes ``j <= t`` (absolute position
  ``main_len + j``), the row max, sum and ``a`` shared by both parts;
* B6 :func:`decode_attention_stats` runs the main part alone and finishes
  the coupling with the side part's row statistics (the hybrid mode);
* B8 :func:`fresh_write` writes one token into a layer's side block.

Every masked lane has the score -1e9. CUDA tensors launch
``csrc/decode_attention.cu`` or raise; CPU tensors run the plain version
beside each wrapper. B4, B6 and B7 share one kernel core whose shared
memory is fixed by (r, D) (:func:`plan`); a cache long enough to hold a
window past the core's resident ``cap`` keys gets an f32 score scratch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

NEG_INF = -1e9
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale, pos,
# out, scratch; B, KV, r, D, S, window, cap, smem, vec; scale, softcap; has_softcap
_launch = _build.c_launcher("decode_attention", "llmc_decode_attention_append",
                            [_P] * 12 + [_I] * 9 + [_F] * 2 + [_I])
# q, k_cache, v_cache, k_scale, v_scale, kf, vf, ksf, vsf, main_len, pos, out,
# scratch; B, KV, r, D, S, W, window, t, cap, smem, vec; scale, softcap; has_softcap
_launch_two_part = _build.c_launcher("decode_attention", "llmc_decode_attention",
                                     [_P] * 13 + [_I] * 11 + [_F] * 2 + [_I])
# qi, qs, m_f, wfm, k_cache, v_cache, k_scale, v_scale, main_len, pos, o32, m,
# a, sum, scratch; B, KV, r, D, S, window, cap, smem, vec; scale, softcap; has_softcap
_launch_stats = _build.c_launcher("decode_attention", "llmc_decode_attention_stats",
                                  [_P] * 15 + [_I] * 9 + [_F] * 2 + [_I])
# kf, vf, ksf, vsf, nk, nv, nks, nvs; B, KV, D, W, layer, t, width, svec
_launch_write = _build.c_launcher("decode_attention", "llmc_fresh_write", [_P] * 8 + [_I] * 8)

# The kernels' shared-memory plan (csrc/decode_attention.cu, ``Layout``):
# keys go through a ring of STAGES chunks of CHUNK keys, and a window of up
# to ``cap`` keys keeps its scores, v scales and prob codes resident.
CHUNK, STAGES = 64, 4
RESIDENT_BYTES = 8192       # the resident window's bytes, which set ``cap``


class Plan(NamedTuple):
    chunk: int      # keys per copied chunk
    cap: int        # keys whose scores stay in shared memory
    scratch: bool   # a longer window is possible: f32 scores in device scratch
    smem: int       # dynamic shared memory per CTA, bytes


def plan(r: int, D: int, S: int, W: int = 0) -> Plan:
    """The shared-memory plan of B4, B6 and B7 for r query rows per kv
    head, head dim D, a main cache of S rows and a side block of W lanes.
    Shared memory depends on r and D only: the ring of K/V chunks (rows of
    D rounded up to 16 bytes, plus the chunk's f32 k scales), 8 rows of q
    codes (padded to an odd multiple of 16 bytes), and the resident
    window: cap keys of r f32 scores (the staged q, (r, D) f32 and 24
    floats, before them), one f32 v scale and r prob codes each (rows
    padded by 16 bytes). A window can outgrow cap only when S + W > cap;
    then the wrapper allocates the f32 score scratch, r * (S + W) floats
    per (slot, kv head)."""
    cap = RESIDENT_BYTES // (5 * r + 4) // CHUNK * CHUNK
    pitch = (D + 15) // 16 * 16
    qpitch = (D + 31) // 32 * 32 + 16
    smem = (STAGES * CHUNK * (pitch + 4) + 8 * qpitch + max(r * cap * 4, r * D * 4 + 96)
            + cap * 4 + r * (cap + 16))
    return Plan(CHUNK, cap, S + W > cap, smem)


def _launch_plan(q, r, D, S, W, codes):
    """(plan, scratch tensor or None, 16-byte copies?) for one launch:
    16-byte copies need D % 16 == 0 and 16-byte aligned K/V codes. The
    kernels copy ``q`` (f32: 16 bytes at a time; B6's int8 codes: 4) and
    the codes at least 4 bytes at a time."""
    if q.data_ptr() % (16 if q.dtype == torch.float32 else 4):
        raise ValueError("q must start on a 16-byte (int8 codes: 4-byte) boundary")
    for t in codes:
        if t.data_ptr() % 4:
            raise ValueError("K/V codes must start on a 4-byte boundary")
    p = plan(r, D, S, W)
    scratch = None
    if p.scratch:
        scratch = torch.empty(q.shape[0] * q.shape[1] * r * (S + W), dtype=torch.float32,
                              device=q.device)
    vec = D % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in codes)
    return p, scratch, vec


def row_quant_i8(x: torch.Tensor):
    """(.., D) f32 -> int8 codes + per-row scale (absmax * (1/127), >= 1e-8).

    The JAX kernel runs under ``jit``, where XLA turns the division by 127
    into a multiplication by its f32 reciprocal; the port writes that out,
    here and in the CUDA kernel, so that both agree on every device."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax * (1.0 / 127.0), 1e-8)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def _scores(qi, qs, k, ks, scale: float, softcap: Optional[float]):
    """((float(qi . k) * qs) * ks) * scale, then the softcap: qi (B, KV, r,
    D) int8, qs (B, KV, r, 1), k (B, KV, S, D) int8, ks (B, KV, S) ->
    (B, KV, r, S) f32. The integer dots run in float64: exact for any window
    a cache can hold."""
    s32 = torch.einsum("bkrd,bksd->bkrs", qi.double(), k.double()).float()
    s = s32 * qs * ks[:, :, None, :] * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    return s


def _masked(s, keep):
    """Scores with the lanes outside ``keep`` (B, S) set to -1e9."""
    return torch.where(keep[:, None, None, :], s, torch.full_like(s, NEG_INF))


def _keep_main(S: int, main_len, pos, window: int):
    """(B, S): rows s < main_len, and s > pos - window for a window > 0."""
    s_ids = torch.arange(S, device=pos.device)[None, :]
    keep = s_ids < main_len.long()[:, None]
    if window > 0:
        keep &= s_ids > (pos.long() - window)[:, None]
    return keep


def _keep_side(W: int, main_len, pos, window: int, t: int):
    """(B, W): side lanes j <= t, at absolute position main_len + j."""
    j = torch.arange(W, device=pos.device)[None, :]
    keep = (j <= t).expand(pos.shape[0], W)
    if window > 0:
        keep = keep & ((main_len.long()[:, None] + j) > (pos.long() - window)[:, None])
    return keep


def _pv(pi, v):
    """float(pi . v): (B, KV, r, S) integer-valued probs, (B, KV, S, D) int8."""
    return torch.einsum("bkrs,bksd->bkrd", pi.double(), v.double()).float()


def i8_softmax_requant(parts_s, parts_vs):
    """The int8-codes attention epilogue over window parts (port of
    ``engine/generate.py::_i8_softmax_requant``): masked scores (B, KV, r,
    S_p) and v scales (B, KV, S_p) per part -> (per-part prob codes as
    integer-valued f32, output scale a / sum (B, KV, r, 1)). The row max and
    ``a`` are shared; the row sum adds the parts' sums in part order."""
    m = torch.amax(parts_s[0], dim=-1, keepdim=True)
    for s in parts_s[1:]:
        m = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    es = [torch.exp(s - m) for s in parts_s]
    sum_row = es[0].sum(dim=-1, keepdim=True)
    for e in es[1:]:
        sum_row = sum_row + e.sum(dim=-1, keepdim=True)
    ws = [e * vs[:, :, None, :] for e, vs in zip(es, parts_vs)]
    a = torch.amax(ws[0], dim=-1, keepdim=True)
    for w in ws[1:]:
        a = torch.maximum(a, torch.amax(w, dim=-1, keepdim=True))
    a = torch.clamp_min(a * (1.0 / 127.0), 1e-8)
    return [torch.clamp(torch.round(w / a), -127, 127) for w in ws], a / sum_row


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _expect(t, shape, dtype, name: str):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def _same_device(tensors):
    if len({t.device for t in tensors}) != 1:
        raise ValueError("tensors on different devices")
    if tensors[0].is_cuda and not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")


def _check_cache(k_cache, v_cache, k_scale, v_scale, B, KV, D):
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8 \
            or k_cache.dim() != 4 or k_cache.shape[:2] != (B, KV) \
            or k_cache.shape[3] != D or v_cache.shape != k_cache.shape:
        raise ValueError("caches must be int8 (B, KV, S, D) matching q")
    S = k_cache.shape[2]
    for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
        _expect(t, (B, KV, S), torch.float32, name)
    return S


def _check_kernel_shape(q, r, D):
    if q.is_cuda and (r > 8 or D > 256 or D % 4):
        raise ValueError(f"kernel supports r <= 8 and D <= 256, D % 4 == 0 (r={r}, D={D})")


# ---------------------------------------------------------------------------
# B4: fused-append attention
# ---------------------------------------------------------------------------


def _append(new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale, pos):
    """The current token at ``pos`` of each slot, in place; a slot whose
    position lies outside the cache writes nothing (its row 0 gets its own
    value back), as the kernel does. Returns which slots wrote (B,)."""
    B, S = k_cache.shape[0], k_cache.shape[2]
    b = torch.arange(B, device=k_cache.device)
    inside = (pos >= 0) & (pos < S)
    at = torch.where(inside, pos, 0).long()
    for buf, new in ((k_cache, new_k), (v_cache, new_v), (k_scale, new_ks), (v_scale, new_vs)):
        buf[b, :, at] = torch.where(inside.view(B, *(1,) * (new.dim() - 1)), new, buf[b, :, at])
    return inside


def decode_attention_append_plain(q, new_k, new_v, new_ks, new_vs, k_cache, v_cache,
                                  k_scale, v_scale, pos, *, window: int = 0,
                                  scale: float, softcap: Optional[float] = None):
    """Plain version of B4 (same arguments as :func:`decode_attention_append`)."""
    inside = _append(new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale, pos)
    S = k_cache.shape[2]
    qi, qs = row_quant_i8(q)                                   # (B, KV, r, D)
    s_ids = torch.arange(S, device=q.device)[None, :]
    p = pos.long()[:, None]
    keep = s_ids <= p
    if window > 0:
        keep &= s_ids > p - window
    s = _masked(_scores(qi, qs, k_cache, k_scale, scale, softcap), keep)
    (pi,), oscale = i8_softmax_requant([s], [v_scale])
    out = _pv(pi, v_cache) * oscale
    return torch.where(inside[:, None, None, None], out, torch.full_like(out, float("nan")))


def _check(q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale, pos):
    B, KV, r, D = q.shape
    if q.dtype != torch.float32:
        raise ValueError("q must be float32 (B, KV, r, D)")
    _check_cache(k_cache, v_cache, k_scale, v_scale, B, KV, D)
    for t, shp, dt, name in ((new_k, (B, KV, D), torch.int8, "new_k"),
                             (new_v, (B, KV, D), torch.int8, "new_v"),
                             (new_ks, (B, KV), torch.float32, "new_ks"),
                             (new_vs, (B, KV), torch.float32, "new_vs"),
                             (pos, (B,), torch.int32, "pos")):
        _expect(t, shp, dt, name)
    _same_device((q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale, pos))
    _check_kernel_shape(q, r, D)


def decode_attention_append(q, new_k, new_v, new_ks, new_vs, k_cache, v_cache,
                            k_scale, v_scale, pos, *, window: int = 0,
                            scale: float, softcap: Optional[float] = None):
    """q (B, KV, r, D) f32 -> attention output (B, KV, r, D) f32.

    ``new_k``/``new_v`` (B, KV, D) int8 and ``new_ks``/``new_vs`` (B, KV)
    f32 are the current token, written at ``pos`` (B,) int32 into one
    layer's cache: ``k_cache``/``v_cache`` (B, KV, S, D) int8 and
    ``k_scale``/``v_scale`` (B, KV, S) f32, in place. A slot whose
    ``pos[b]`` lies outside the cache writes nothing and gets NaN, on the
    card and in the plain version alike (checking would wait for the
    device; a retired batcher slot decodes on at ``max_len``). ``window``
    <= 0 is full causal attention."""
    _check(q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale, pos)
    if not q.is_cuda:
        return decode_attention_append_plain(
            q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale,
            pos, window=window, scale=scale, softcap=softcap)
    B, KV, r, D = q.shape
    S = k_cache.shape[2]
    p, scratch, vec = _launch_plan(q, r, D, S, 0, (new_k, new_v, k_cache, v_cache))
    out = torch.empty_like(q)
    _launch(q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(), new_ks.data_ptr(),
            new_vs.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), pos.data_ptr(), out.data_ptr(),
            _ptr(scratch), B, KV, r, D, S, int(window), p.cap, p.smem, int(vec), float(scale),
            float(softcap) if softcap is not None else 0.0, int(softcap is not None))
    decode_attention_append.launches += 1
    return out


decode_attention_append.launches = 0


# ---------------------------------------------------------------------------
# B7: read-only [main | side] attention
# ---------------------------------------------------------------------------


def decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, main_len, pos,
                           window: int = 0, t: int = 0, fresh=None, *, scale: float,
                           softcap: Optional[float] = None):
    """Plain version of B7 (same arguments as :func:`decode_attention`)."""
    qi, qs = row_quant_i8(q)
    S = k_cache.shape[2]
    parts = [(k_cache, v_cache, k_scale, v_scale, _keep_main(S, main_len, pos, window))]
    if fresh is not None:
        kf, vf, ksf, vsf = fresh
        parts.append((kf, vf, ksf, vsf, _keep_side(kf.shape[2], main_len, pos, window, t)))
    ss = [_masked(_scores(qi, qs, k, ks, scale, softcap), keep) for k, _, ks, _, keep in parts]
    pis, oscale = i8_softmax_requant(ss, [vs for _, _, _, vs, _ in parts])
    o32 = _pv(pis[0], parts[0][1])
    for pi, (_, v, _, _, _) in zip(pis[1:], parts[1:]):
        o32 = o32 + _pv(pi, v)                       # integer-valued: exact
    return o32 * oscale


def _check_lengths(main_len, pos, B):
    _expect(main_len, (B,), torch.int32, "main_len")
    _expect(pos, (B,), torch.int32, "pos")


def decode_attention(q, k_cache, v_cache, k_scale, v_scale, main_len, pos, window: int = 0,
                     t: int = 0, fresh=None, *, scale: float, softcap: Optional[float] = None):
    """q (B, KV, r, D) f32 -> attention over ``[main | side]`` (B, KV, r, D)
    f32, read-only (B7).

    ``k_cache``/``v_cache`` (B, KV, S, D) int8 and ``k_scale``/``v_scale``
    (B, KV, S) f32 are one layer's main cache: rows ``s < main_len`` (B,)
    int32 attend. ``pos`` (B,) int32 is the current token's position (the
    window keeps rows ``> pos - window``; ``window`` <= 0 is full
    attention). ``fresh`` = (kf, vf, ksf, vsf), one layer's side block
    (B, KV, W, D) int8 and (B, KV, W) f32, whose lane ``j`` at position
    ``main_len + j`` attends for ``j <= t``; None is the single-window
    form."""
    B, KV, r, D = q.shape
    if q.dtype != torch.float32:
        raise ValueError("q must be float32 (B, KV, r, D)")
    S = _check_cache(k_cache, v_cache, k_scale, v_scale, B, KV, D)
    _check_lengths(main_len, pos, B)
    tensors = [q, k_cache, v_cache, k_scale, v_scale, main_len, pos]
    W = 0
    if fresh is not None:
        kf, vf, ksf, vsf = fresh
        if kf.dim() != 4:
            raise ValueError("the side block must be int8 (B, KV, W, D)")
        W = kf.shape[2]
        for a, name in ((kf, "kf"), (vf, "vf")):
            _expect(a, (B, KV, W, D), torch.int8, name)
        for a, name in ((ksf, "ksf"), (vsf, "vsf")):
            _expect(a, (B, KV, W), torch.float32, name)
        if not 0 <= t < W:
            raise ValueError(f"side step t={t} outside the block's {W} lanes")
        tensors += [kf, vf, ksf, vsf]
    _same_device(tensors)
    _check_kernel_shape(q, r, D)
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale, main_len, pos,
                                      window, t, fresh, scale=scale, softcap=softcap)
    codes = (k_cache, v_cache) + ((fresh[0], fresh[1]) if fresh is not None else ())
    p, scratch, vec = _launch_plan(q, r, D, S, W, codes)
    out = torch.empty_like(q)
    side = [a.data_ptr() for a in fresh] if fresh is not None else [0, 0, 0, 0]
    _launch_two_part(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
                     v_scale.data_ptr(), *side, main_len.data_ptr(), pos.data_ptr(),
                     out.data_ptr(), _ptr(scratch), B, KV, r, D, S, W, int(window), int(t),
                     p.cap, p.smem, int(vec), float(scale),
                     float(softcap) if softcap is not None else 0.0, int(softcap is not None))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# ---------------------------------------------------------------------------
# B6: main-window partial attention with the side part's coupling stats
# ---------------------------------------------------------------------------


def decode_attention_stats_plain(qi, qs, m_f, wfm, k_cache, v_cache, k_scale, v_scale,
                                 main_len, pos, window: int = 0, *, scale: float,
                                 softcap: Optional[float] = None):
    """Plain version of B6 (same arguments as :func:`decode_attention_stats`)."""
    s = _masked(_scores(qi, qs, k_cache, k_scale, scale, softcap),
                _keep_main(k_cache.shape[2], main_len, pos, window))
    m = torch.maximum(torch.amax(s, dim=-1, keepdim=True), m_f)
    e = torch.exp(s - m)
    sum_m = e.sum(dim=-1, keepdim=True)
    w = e * v_scale[:, :, None, :]
    a = torch.maximum(torch.amax(w, dim=-1, keepdim=True), wfm * torch.exp(m_f - m))
    a = torch.clamp_min(a * (1.0 / 127.0), 1e-8)
    pi = torch.clamp(torch.round(w / a), -127, 127)
    return _pv(pi, v_cache), m, a, sum_m


def decode_attention_stats(qi, qs, m_f, wfm, k_cache, v_cache, k_scale, v_scale, main_len,
                           pos, window: int = 0, *, scale: float,
                           softcap: Optional[float] = None):
    """Main-window partial attention of the hybrid side-block decode (B6).

    ``qi`` (B, KV, r, D) int8 and ``qs`` (B, KV, r, 1) f32 are the row-
    quantized q; ``m_f`` and ``wfm`` (B, KV, r, 1) f32 the side part's
    masked row max and row max of ``exp(s_f - m_f) * v_scale_f``. The main
    rows and window are those of :func:`decode_attention`. Returns (o32 =
    float(pi . V_main), exact while 127^2 * S < 2^24; m = max(m_main, m_f);
    a = max(max w_main, wfm * exp(m_f - m)) * (1/127) clamped at 1e-8; and
    sum_main), each (B, KV, r, 1) but o32 (B, KV, r, D). The kernel needs
    one kept row or a side max above -1e9 in each query row."""
    B, KV, r, D = qi.shape
    if qi.dtype != torch.int8:
        raise ValueError("qi must be int8 (B, KV, r, D)")
    for a, name in ((qs, "qs"), (m_f, "m_f"), (wfm, "wfm")):
        _expect(a, (B, KV, r, 1), torch.float32, name)
    S = _check_cache(k_cache, v_cache, k_scale, v_scale, B, KV, D)
    _check_lengths(main_len, pos, B)
    _same_device([qi, qs, m_f, wfm, k_cache, v_cache, k_scale, v_scale, main_len, pos])
    _check_kernel_shape(qi, r, D)
    if not qi.is_cuda:
        return decode_attention_stats_plain(qi, qs, m_f, wfm, k_cache, v_cache, k_scale,
                                            v_scale, main_len, pos, window, scale=scale,
                                            softcap=softcap)
    p, scratch, vec = _launch_plan(qi, r, D, S, 0, (k_cache, v_cache))
    o32 = torch.empty((B, KV, r, D), dtype=torch.float32, device=qi.device)
    m, a, sum_m = (torch.empty_like(qs) for _ in range(3))
    _launch_stats(qi.data_ptr(), qs.data_ptr(), m_f.data_ptr(), wfm.data_ptr(),
                  k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
                  v_scale.data_ptr(), main_len.data_ptr(), pos.data_ptr(), o32.data_ptr(),
                  m.data_ptr(), a.data_ptr(), sum_m.data_ptr(), _ptr(scratch), B, KV, r, D, S,
                  int(window), p.cap, p.smem, int(vec), float(scale),
                  float(softcap) if softcap is not None else 0.0, int(softcap is not None))
    decode_attention_stats.launches += 1
    return o32, m, a, sum_m


decode_attention_stats.launches = 0


def hybrid_decode_attention(q, k_cache, v_cache, k_scale, v_scale, main_len, pos,
                            window: int, t: int, fresh, *, scale: float,
                            softcap: Optional[float] = None):
    """The hybrid form of :func:`decode_attention` (same arguments; ``fresh``
    required; JAX ``engine/generate.py:540-580``): the side part's masked
    scores and row statistics in plain PyTorch, the main window through B6,
    then the side probs re-quantized with B6's (m, a) and both parts summed
    in PyTorch. Equal to the two-part epilogue up to the exp(m_f - m)
    rescale rounding."""
    qi, qs = row_quant_i8(q)
    kf, vf, ksf, vsf = fresh
    s_f = _masked(_scores(qi, qs, kf, ksf, scale, softcap),
                  _keep_side(kf.shape[2], main_len, pos, window, t))
    m_f = torch.amax(s_f, dim=-1, keepdim=True)
    e_f = torch.exp(s_f - m_f)
    sum_f = e_f.sum(dim=-1, keepdim=True)
    w_f = e_f * vsf[:, :, None, :]
    wfm = torch.amax(w_f, dim=-1, keepdim=True)
    o32m, m, a, sum_m = decode_attention_stats(qi, qs, m_f, wfm, k_cache, v_cache, k_scale,
                                               v_scale, main_len, pos, window, scale=scale,
                                               softcap=softcap)
    r_f = torch.exp(m_f - m)
    pi_f = torch.clamp(torch.round(w_f * (r_f / a)), -127, 127)
    return (o32m + _pv(pi_f, vf)) * (a / (sum_m + sum_f * r_f))


# ---------------------------------------------------------------------------
# B8: one token into the side block
# ---------------------------------------------------------------------------


def fresh_write_plain(fresh, new_kv, layer: int, t: int):
    """Plain version of B8 (same arguments as :func:`fresh_write`)."""
    for buf, new in zip(fresh, new_kv):
        buf[layer, :, :, t] = new
    return fresh


def write_widths(fresh, new_kv):
    """B8's copies: (bytes per code copy, 16-byte scale loads?). 16 where D
    % 16 == 0 and the four code tensors start on 16-byte boundaries, else 4,
    else 1; the scales go as float4 where ks and vs start on 16 bytes and
    B * KV % 4 == 0."""
    kf, vf, _, _ = fresh
    kc, vc, ks, vs = new_kv
    D = kf.shape[-1]
    width = next(u for u in (16, 4, 1)
                 if D % u == 0 and all(a.data_ptr() % u == 0 for a in (kf, vf, kc, vc)))
    return width, (ks.numel() % 4 == 0 and ks.data_ptr() % 16 == 0
                   and vs.data_ptr() % 16 == 0)


def fresh_write(fresh, new_kv, layer: int, t: int):
    """Write one token into the side block at (layer, lane t), in place (B8).

    ``fresh`` = (kf, vf, ksf, vsf): codes (L, B, KV, W, D) int8, scales
    (L, B, KV, W) f32. ``new_kv`` = (kc, vc, ks, vs): codes (B, KV, D) int8,
    scales (B, KV) f32. Returns ``fresh``."""
    kf, vf, ksf, vsf = fresh
    if kf.dim() != 5:
        raise ValueError("the side block must be int8 (L, B, KV, W, D)")
    L, B, KV, W, D = kf.shape
    for a, name in ((kf, "kf"), (vf, "vf")):
        _expect(a, (L, B, KV, W, D), torch.int8, name)
    for a, name in ((ksf, "ksf"), (vsf, "vsf")):
        _expect(a, (L, B, KV, W), torch.float32, name)
    kc, vc, ks, vs = new_kv
    for a, name in ((kc, "kc"), (vc, "vc")):
        _expect(a, (B, KV, D), torch.int8, name)
    for a, name in ((ks, "ks"), (vs, "vs")):
        _expect(a, (B, KV), torch.float32, name)
    if not (0 <= layer < L and 0 <= t < W):
        raise ValueError(f"(layer {layer}, lane {t}) outside the side block ({L} layers, "
                         f"{W} lanes)")
    _same_device([*fresh, *new_kv])
    if not kf.is_cuda:
        return fresh_write_plain(fresh, new_kv, layer, t)
    width, svec = write_widths(fresh, new_kv)
    _launch_write(*(a.data_ptr() for a in (*fresh, *new_kv)), B, KV, D, W, int(layer), int(t),
                  width, int(svec))
    fresh_write.launches += 1
    return fresh


fresh_write.launches = 0
