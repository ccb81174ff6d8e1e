"""The plain version of kernel B4 against the JAX fused-append decode
attention (``decode_attention_append``, Pallas in interpret mode).

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
    rng = np.random.default_rng(t + 10 * window)
    layer = 1
    mlen = np.array([5, 9], np.int32)
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
