"""The plain version of kernel B4 against the JAX fused-append decode
attention (``decode_attention_append``, Pallas in interpret mode), at a
short cache and at one longer than the kernels' chunk of keys (B4, and
B7 and B6 against their JAX kernels there too), and the kernels' shared
memory plan.

Equivalent inputs: JAX's main cache holds positions < mlen, its side block
holds decode steps 0..t-1 and ``new_kv`` is step t. The port's cache holds
the same codes in place at mlen..mlen+t-1, and the function writes step t
at pos = mlen + t.

Tolerances: the written K/V codes and scales are bitwise equal. The output
agrees to f32 ulps — rtol 1e-5 — because the JAX kernel sums the main and
side parts of the softmax denominator separately. Both sides scale by the
f32 reciprocal of 127 (the JAX kernel runs under jit, where XLA rewrites
its division by the constant; the port writes the multiplication out), so
the q codes are equal.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu.engine.kvcache import FreshKV, KVCache
from llm_compressor_tpu_torch.kernels import decode_attention as tda
from torch_port_util import one_torch_thread  # noqa: F401

jda = importlib.import_module("llm_compressor_tpu.kernels.decode_attention")

L, B, KV, r, D, S, W = 2, 2, 2, 4, 64, 128, 8


@pytest.mark.parametrize("window,softcap", [(0, None), (6, None), (0, 20.0), (4, 30.0)])
@pytest.mark.parametrize("t", [0, 3])
def test_plain_matches_jax(window, softcap, t):
    _append_against_jax(S, np.array([5, 9], np.int32), window, softcap, t, t + 10 * window)


# S = 1024: windows of 1 to 10 chunks of 64 keys, starting on and off a
# chunk (and a 4-key) boundary; slot 1's window ends at S - 1
@pytest.mark.parametrize("mlen,window,softcap,t", [
    ((100, 700), 0, None, 3), ((63, 1021), 131, None, 2), ((64, 1020), 0, 25.0, 3),
    ((900, 129), 67, None, 0), ((512, 1023), 1, None, 0), ((0, 1023), 0, None, 0)])
def test_plain_matches_jax_long(mlen, window, softcap, t):
    _append_against_jax(1024, np.array(mlen, np.int32) - t, window, softcap, t,
                        mlen[0] + window)


def _append_against_jax(S, mlen, window, softcap, t, seed):
    rng = np.random.default_rng(seed)
    layer = 1
    i8 = lambda *s: rng.integers(-127, 128, s).astype(np.int8)
    sc = lambda *s: (rng.random(s) * 0.05 + 0.001).astype(np.float32)
    q = rng.normal(size=(B, KV, r, D)).astype(np.float32)
    # JAX layout: main (L, B, KV, D, S), side block (L, B, KV, W, D)
    mk, mv, mks, mvs = i8(L, B, KV, D, S), i8(L, B, KV, D, S), sc(L, B, KV, 1, S), sc(L, B, KV, 1, S)
    fk, fv, fks, fvs = i8(L, B, KV, W, D), i8(L, B, KV, W, D), sc(L, B, KV, 1, W), sc(L, B, KV, 1, W)
    nk, nv, nks, nvs = i8(B, KV, D), i8(B, KV, D), sc(B, KV), sc(B, KV)
    for b in range(B):  # positions past each slot's main length hold nothing
        mk[:, b, ..., mlen[b]:] = 0
        mv[:, b, ..., mlen[b]:] = 0
        mks[:, b, ..., mlen[b]:] = 0
        mvs[:, b, ..., mlen[b]:] = 0
    pos = mlen + t

    cache = KVCache(k=jnp.asarray(mk), v=jnp.asarray(mv), k_scale=jnp.asarray(mks),
                    v_scale=jnp.asarray(mvs), lengths=jnp.asarray(mlen), quantized=True)
    fresh = FreshKV(k=jnp.asarray(fk), v=jnp.asarray(fv), k_scale=jnp.asarray(fks),
                    v_scale=jnp.asarray(fvs))
    new_kv = (jnp.asarray(nk[..., None]), jnp.asarray(nv[..., None]),
              jnp.asarray(nks[..., None, None]), jnp.asarray(nvs[..., None, None]))
    o_jax, (kf, vf, ksf, vsf) = jda.decode_attention_append(
        jnp.asarray(q), jnp.zeros((B, KV, r, 1), jnp.float32), cache, fresh, new_kv,
        layer, jnp.asarray(mlen), jnp.asarray(pos), window, t, scale=0.125,
        softcap=softcap, quant_q=True)

    # the port's layer cache (B, KV, S, D): main codes, then steps 0..t-1
    kc = np.swapaxes(mk[layer], -1, -2).copy()
    vc = np.swapaxes(mv[layer], -1, -2).copy()
    ks, vs = mks[layer, :, :, 0].copy(), mvs[layer, :, :, 0].copy()
    for b in range(B):
        kc[b, :, mlen[b]:mlen[b] + t] = fk[layer, b, :, :t]
        vc[b, :, mlen[b]:mlen[b] + t] = fv[layer, b, :, :t]
        ks[b, :, mlen[b]:mlen[b] + t] = fks[layer, b, :, 0, :t]
        vs[b, :, mlen[b]:mlen[b] + t] = fvs[layer, b, :, 0, :t]
    bufs = [torch.from_numpy(a) for a in (kc, vc, ks, vs)]
    o = tda.decode_attention_append(
        torch.from_numpy(q), torch.from_numpy(nk), torch.from_numpy(nv),
        torch.from_numpy(nks), torch.from_numpy(nvs), *bufs,
        torch.from_numpy(pos), window=window, scale=0.125, softcap=softcap)

    np.testing.assert_allclose(o.numpy(), np.asarray(o_jax), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(o_jax)).max())
    # the token written at pos equals JAX's side-block step t
    for b in range(B):
        p = pos[b]
        np.testing.assert_array_equal(bufs[0][b, :, p].numpy(), np.asarray(kf)[b, :, t])
        np.testing.assert_array_equal(bufs[1][b, :, p].numpy(), np.asarray(vf)[b, :, t])
        np.testing.assert_array_equal(bufs[2][b, :, p].numpy(), np.asarray(ksf)[b, :, 0, t])
        np.testing.assert_array_equal(bufs[3][b, :, p].numpy(), np.asarray(vsf)[b, :, 0, t])


def _long_layer(seed, S=1024):
    """A layer-1 main cache of S rows and a side block of W lanes, in the
    JAX layout and as the port's (B, KV, S, D) / (B, KV, W, D) tensors."""
    rng = np.random.default_rng(seed)
    i8 = lambda *s: rng.integers(-127, 128, s).astype(np.int8)
    sc = lambda *s: (rng.random(s) * 0.05 + 0.001).astype(np.float32)
    j = dict(q=rng.normal(size=(B, KV, r, D)).astype(np.float32),
             kc=i8(L, B, KV, D, S), vc=i8(L, B, KV, D, S), ks=sc(L, B, KV, 1, S),
             vs=sc(L, B, KV, 1, S), kf=i8(L, B, KV, W, D), vf=i8(L, B, KV, W, D),
             ksf=sc(L, B, KV, 1, W), vsf=sc(L, B, KV, 1, W))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    main = (t(np.swapaxes(j["kc"][1], -1, -2)), t(np.swapaxes(j["vc"][1], -1, -2)),
            t(j["ks"][1, :, :, 0]), t(j["vs"][1, :, :, 0]))
    side = (t(j["kf"][1]), t(j["vf"][1]), t(j["ksf"][1, :, :, 0]), t(j["vsf"][1, :, :, 0]))
    return j, main, side


# S = 1024, main windows of 0 to 16 chunks, on and off chunk boundaries
@pytest.mark.parametrize("len0,window,t,side", [
    ((1000, 64), 0, 5, True), ((1017, 300), 131, 7, True), ((1024, 0), 70, 3, True),
    ((1024, 129), 200, 0, False), ((1023, 1024), 0, 0, False)])
def test_two_part_plain_matches_jax_long(len0, window, t, side):
    """B7's plain version against the JAX kernel ``_call`` at S = 1024
    (rtol 1e-5, atol 1e-6, as ``tests/test_torch_side_block.py``)."""
    j, main, fresh = _long_layer(sum(len0) + window)
    len0 = np.array(len0, np.int32)
    pos = len0 + t if side else len0 - 1
    want = jda.decode_attention(
        jnp.asarray(j["q"]), jnp.asarray(j["kc"]), jnp.asarray(j["vc"]), jnp.asarray(j["ks"]),
        jnp.asarray(j["vs"]), 1, jnp.asarray(len0), jnp.asarray(pos), window, t,
        fresh=tuple(jnp.asarray(j[k]) for k in ("kf", "vf", "ksf", "vsf")) if side else None,
        scale=0.125)
    got = tda.decode_attention(torch.from_numpy(j["q"]), *main, torch.from_numpy(len0),
                               torch.from_numpy(pos), window, t, fresh if side else None,
                               scale=0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("len0,window,softcap", [((1000, 64), 0, None), ((1017, 300), 131, 30.0),
                                                 ((0, 1024), 0, None)])
def test_stats_plain_matches_jax_long(len0, window, softcap):
    """B6's plain version against the JAX kernel ``_call_stats`` at S =
    1024 on the same q codes and side statistics: o32 bitwise, m, a and
    sum_main to rtol 1e-6 (as ``tests/test_torch_side_block.py``), 1e-5
    under the softcap: XLA's tanh and PyTorch's round a score near the cap
    (30) an ulp apart, 30 * 2^-23 = 3.6e-6, which moves that key's
    exp(s - m), and so a or the sum, by as much relative (the card tests'
    tolerance for B6)."""
    j, main, _ = _long_layer(sum(len0) + window + 1)
    rng = np.random.default_rng(window)
    len0 = np.array(len0, np.int32)
    pos = len0 + 4
    qi, qs = jax.jit(jda._row_quant_i8)(jnp.asarray(j["q"]))
    m_f = rng.normal(size=(B, KV, r, 1)).astype(np.float32)
    wfm = (rng.random((B, KV, r, 1)) * 0.02).astype(np.float32)
    want = jda.decode_attention_stats(
        qi, qs, jnp.asarray(m_f), jnp.asarray(wfm), jnp.asarray(j["kc"]), jnp.asarray(j["vc"]),
        jnp.asarray(j["ks"]), jnp.asarray(j["vs"]), 1, jnp.asarray(len0), jnp.asarray(pos),
        window, scale=0.125, softcap=softcap)
    got = tda.decode_attention_stats(
        *(torch.from_numpy(np.array(a)) for a in (qi, qs, m_f, wfm)), *main,
        torch.from_numpy(len0), torch.from_numpy(pos), window, scale=0.125, softcap=softcap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6 if softcap is None
                                   else 1e-5, atol=0)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("r_", range(1, 9))
def test_plan(r_, D):
    """The kernels' shared memory depends on (r, D) alone and fits an SM
    (227 KB a block) at every cache length the JAX kernel serves (S % 128
    == 0 up to 128K); a score scratch is planned exactly when a window can
    outgrow the resident cap."""
    plans = {S: tda.plan(r_, D, S) for S in range(128, 131072 + 1, 128)}
    assert len({(p.chunk, p.cap, p.smem) for p in plans.values()}) == 1
    p = plans[128]
    assert p.smem <= 232448 and p.cap >= p.chunk == 64 and p.cap % p.chunk == 0
    assert all(p.scratch == (S > p.cap) for S, p in plans.items())
    assert tda.plan(r_, D, 128, 32) == tda.plan(r_, D, 128)._replace(scratch=160 > p.cap)


def test_plan_flagship():
    """Llama-3.2-1B's decode (r = 4, D = 64, a cache of 256 rows, a side
    block of 32): at most 28 KB a CTA, so 8 CTAs fit an SM's 228 KB with
    their 1 KB reserve each, and no scratch: 145 kept keys stay resident."""
    for W in (0, 32):
        p = tda.plan(4, 64, 256, W)
        assert p.smem <= 28 * 1024 and 8 * (p.smem + 1024) <= 228 * 1024
        assert not p.scratch and p.cap >= 256 + W


def test_row_quant_matches_jax():
    x = np.random.default_rng(0).normal(size=(3, 4, 64)).astype(np.float32)
    qa, sa = jax.jit(jda._row_quant_i8)(jnp.asarray(x))  # as inside the jitted kernel
    qb, sb = tda.row_quant_i8(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(qa), qb.numpy())
    np.testing.assert_array_equal(np.asarray(sa), sb.numpy())


def test_wrapper_checks_inputs():
    q = torch.zeros((B, KV, r, D))
    c = torch.zeros((B, KV, S, D), dtype=torch.int8)
    s = torch.zeros((B, KV, S))
    n = torch.zeros((B, KV, D), dtype=torch.int8)
    ns = torch.zeros((B, KV))
    with pytest.raises(ValueError, match="int32"):
        tda.decode_attention_append(q, n, n, ns, ns, c, c, s, s,
                                    torch.zeros((B,), dtype=torch.int64), scale=1.0)
    with pytest.raises(ValueError, match="caches"):
        tda.decode_attention_append(q, n, n, ns, ns, c.float(), c, s, s,
                                    torch.zeros((B,), dtype=torch.int32), scale=1.0)


@pytest.mark.parametrize("D,code_off,scale_off,BKV,want", [
    (64, 0, 0, (2, 2), (16, True)), (128, 0, 0, (2, 2), (16, True)),
    (64, 4, 0, (2, 2), (4, True)), (64, 1, 0, (2, 2), (1, True)),
    (38, 0, 0, (2, 2), (1, True)), (36, 0, 1, (2, 2), (4, False)),
    (64, 0, 0, (3, 2), (16, False))])
def test_fresh_write_widths(D, code_off, scale_off, BKV, want):
    """B8's copy widths from D and the tensors' alignment (views that start
    off a 16-byte boundary take narrower copies; float4 scale loads need
    B * KV % 4 == 0); the CPU write stays the plain version's."""
    def view(shape, dtype, off):
        n = int(np.prod(shape))
        buf = torch.zeros(n + off + 16, dtype=dtype)
        base = (-buf.data_ptr() % 16) // buf.element_size()   # a 16-byte boundary
        return buf[base + off:base + off + n].view(shape)

    L, (B, KV), W = 2, BKV, 4
    fresh = (view((L, B, KV, W, D), torch.int8, code_off), view((L, B, KV, W, D), torch.int8,
                                                                 code_off),
             view((L, B, KV, W), torch.float32, scale_off),
             view((L, B, KV, W), torch.float32, scale_off))
    new = (view((B, KV, D), torch.int8, code_off), view((B, KV, D), torch.int8, code_off),
           view((B, KV), torch.float32, scale_off), view((B, KV), torch.float32, scale_off))
    for a in new:
        a.copy_(torch.arange(a.numel()).reshape(a.shape).to(a.dtype) + 1)
    assert tda.write_widths(fresh, new) == want
    tda.fresh_write(fresh, new, 1, 3)
    for buf, a in zip(fresh, new):
        assert torch.equal(buf[1, :, :, 3], a) and not buf[0].any()
