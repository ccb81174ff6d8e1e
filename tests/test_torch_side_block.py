"""The side-block decode of the port against the JAX package: kernels B6,
B7 and B8 (their plain versions against the Pallas kernels in interpret
mode), ``merge_fresh``, and ``decode_greedy_steps`` in its ``"two_part"``
and ``"hybrid"`` attention modes against the JAX package's FreshKV scan path
under the matching switches (``LLMC_ATTN_APPEND=0``, and
``LLMC_FUSED_ATTN=1`` for hybrid), all on numpy inputs from a seed.

Layouts: the JAX main cache is (L, B, KV, D, S) with (L, B, KV, 1, S)
scales, the port's one layer (B, KV, S, D) with (B, KV, S) scales; both
side blocks hold codes (L, B, KV, W, D), with scales (L, B, KV, 1, W) in
JAX and (L, B, KV, W) in the port.

Tolerances:
* B7, and B6 with the PyTorch side assembly: rtol 1e-5, atol 1e-6, the JAX
  test's own (``tests/test_decode_attention_kernel.py``). The q codes are
  equal (both scale by the f32 reciprocal of 127); the f32 sums run in
  another order.
* B6's outputs: o32 bitwise (integer dots of equal prob codes); m, a and
  sum_main to rtol 1e-6 (XLA's tanh and exp round apart from PyTorch's by
  an ulp, which moves a softcapped max).
* B8 and ``merge_fresh``: bitwise.
* decode: tokens and the merged cache codes bitwise, scales to rtol 1e-6,
  against the JAX path and against the port's in-place ``"append"`` mode.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import models as jm
from llm_compressor_tpu.engine import decode_greedy_steps as j_greedy, init_cache as j_init
from llm_compressor_tpu.engine import prefill as j_prefill
from llm_compressor_tpu.engine import kvcache as jkv
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu_torch import engine as te
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.engine import kvcache as tkv
from llm_compressor_tpu_torch.kernels import decode_attention as tda
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from torch_port_util import jax_to_numpy, one_torch_thread  # noqa: F401

jda = importlib.import_module("llm_compressor_tpu.kernels.decode_attention")
jgen = importlib.import_module("llm_compressor_tpu.engine.generate")
tgen = importlib.import_module("llm_compressor_tpu_torch.engine.generate")

L, B, KV, r, D, S, W = 3, 2, 2, 4, 64, 32, 8
SCALE = 0.125


def _data(seed):
    rng = np.random.default_rng(seed)
    i8 = lambda *s: rng.integers(-127, 128, s).astype(np.int8)
    sc = lambda *s: (rng.random(s) * 0.05 + 0.001).astype(np.float32)
    return dict(kc=i8(L, B, KV, D, S), vc=i8(L, B, KV, D, S),
                ks=sc(L, B, KV, 1, S), vs=sc(L, B, KV, 1, S),
                kf=i8(L, B, KV, W, D), vf=i8(L, B, KV, W, D),
                ksf=sc(L, B, KV, 1, W), vsf=sc(L, B, KV, 1, W),
                q=rng.normal(size=(B, KV, r, D)).astype(np.float32),
                len0=np.array([S - 7, S - 12], np.int32))


def _port_layer(d, li):
    """The port's layer-``li`` main cache and side block, as torch tensors."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    main = (t(np.swapaxes(d["kc"][li], -1, -2)), t(np.swapaxes(d["vc"][li], -1, -2)),
            t(d["ks"][li, :, :, 0]), t(d["vs"][li, :, :, 0]))
    side = (t(d["kf"][li]), t(d["vf"][li]), t(d["ksf"][li, :, :, 0]), t(d["vsf"][li, :, :, 0]))
    return main, side


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("li,t,window,softcap", [(0, 2, 0, None), (2, 5, 0, None),
                                                 (1, 1, 6, None), (1, 3, 0, 20.0),
                                                 (2, 7, 9, 30.0)])
def test_two_part_plain_matches_jax(li, t, window, softcap):
    """B7 with the side block against the JAX kernel ``_call``."""
    d = _data(li + 10 * t)
    pos = d["len0"] + t
    want = jda.decode_attention(
        jnp.asarray(d["q"]), jnp.asarray(d["kc"]), jnp.asarray(d["vc"]), jnp.asarray(d["ks"]),
        jnp.asarray(d["vs"]), li, jnp.asarray(d["len0"]), jnp.asarray(pos), window, t,
        fresh=tuple(jnp.asarray(d[k]) for k in ("kf", "vf", "ksf", "vsf")), scale=SCALE,
        softcap=softcap)
    main, side = _port_layer(d, li)
    got = tda.decode_attention(torch.from_numpy(d["q"]), *main, torch.from_numpy(d["len0"]),
                               torch.from_numpy(pos), window, t, side, scale=SCALE,
                               softcap=softcap)
    assert got.dtype == torch.float32 and got.shape == (B, KV, r, D)
    _close(got.numpy(), want)


@pytest.mark.parametrize("window,softcap", [(0, None), (5, 25.0)])
def test_single_window_plain_matches_jax(window, softcap):
    """B7 with ``fresh=None``: rows s < main_len (JAX test :91-109)."""
    d = _data(3)
    pos = d["len0"] - 1
    want = jda.decode_attention(
        jnp.asarray(d["q"]), jnp.asarray(d["kc"]), jnp.asarray(d["vc"]), jnp.asarray(d["ks"]),
        jnp.asarray(d["vs"]), 1, jnp.asarray(d["len0"]), jnp.asarray(pos), window, 0,
        fresh=None, scale=SCALE, softcap=softcap)
    main, _ = _port_layer(d, 1)
    got = tda.decode_attention(torch.from_numpy(d["q"]), *main, torch.from_numpy(d["len0"]),
                               torch.from_numpy(pos), window, scale=SCALE, softcap=softcap)
    _close(got.numpy(), want)


def _jax_side_stats(q, kf, ksf, vsf, len0, pos, t, window, softcap):
    """The JAX hybrid path's side part (``engine/generate.py:542-563``)."""
    qi, qs = jda._row_quant_i8(q)
    s_f = jax.lax.dot_general(qi, kf, (((3,), (3,)), ((0, 1), (0, 1))),
                              preferred_element_type=jnp.int32).astype(jnp.float32) \
        * qs * ksf * SCALE
    if softcap is not None:
        s_f = softcap * jnp.tanh(s_f / softcap)
    sf_ids = jnp.arange(kf.shape[-2])[None, :]
    keep = (sf_ids <= t) & ((window <= 0) | ((len0[:, None] + sf_ids) > (pos - window)[:, None]))
    s_f = jnp.where(keep[:, None, None, :], s_f, -1e9)
    m_f = s_f.max(-1, keepdims=True)
    e_f = jnp.exp(s_f - m_f)
    w_f = e_f * vsf
    return qi, qs, m_f, e_f.sum(-1, keepdims=True), w_f, w_f.max(-1, keepdims=True)


@pytest.mark.parametrize("li,t,window,softcap", [(1, 2, 0, None), (0, 4, 7, None),
                                                 (2, 6, 0, 30.0)])
def test_hybrid_plain_matches_jax(li, t, window, softcap):
    """B6 and the PyTorch side assembly against the JAX hybrid assembly
    (``decode_attention_stats`` + its XLA side, under jit)."""
    d = _data(20 + li + t)
    pos = d["len0"] + t

    @jax.jit
    def jax_hybrid(q, kc, vc, ks, vs, kf, vf, ksf, vsf, len0, pos):
        qi, qs, m_f, sum_f, w_f, wfm = _jax_side_stats(q, kf[li], ksf[li], vsf[li], len0, pos,
                                                       t, window, softcap)
        o32m, m, a, sum_m = jda.decode_attention_stats(
            qi, qs, m_f, wfm, kc, vc, ks, vs, li, len0, pos, window, scale=SCALE,
            softcap=softcap)
        r_f = jnp.exp(m_f - m)
        pi_f = jnp.clip(jnp.round(w_f * (r_f / a)), -127, 127).astype(jnp.int8)
        o32f = jax.lax.dot_general(pi_f, vf[li], (((3,), (2,)), ((0, 1), (0, 1))),
                                   preferred_element_type=jnp.int32)
        out = (o32m + o32f.astype(jnp.float32)) * (a / (sum_m + sum_f * r_f))
        return out, (qi, qs, m_f, wfm), (o32m, m, a, sum_m)

    names = ("q", "kc", "vc", "ks", "vs", "kf", "vf", "ksf", "vsf", "len0")
    want, jstats_in, jstats = jax_hybrid(*(jnp.asarray(d[k]) for k in names), jnp.asarray(pos))
    main, side = _port_layer(d, li)
    len0, tpos = torch.from_numpy(d["len0"]), torch.from_numpy(pos)
    got = tda.hybrid_decode_attention(torch.from_numpy(d["q"]), *main, len0, tpos, window, t,
                                      side, scale=SCALE, softcap=softcap)
    _close(got.numpy(), want)

    # B6 alone on the JAX side part's statistics
    qi, qs, m_f, wfm = (torch.from_numpy(np.array(a)) for a in jstats_in)
    o32, m, a, sum_m = tda.decode_attention_stats(qi, qs, m_f, wfm, *main, len0, tpos, window,
                                                  scale=SCALE, softcap=softcap)
    np.testing.assert_array_equal(o32.numpy(), np.asarray(jstats[0]))
    np.testing.assert_allclose(m.numpy(), np.asarray(jstats[1]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(a.numpy(), np.asarray(jstats[2]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(sum_m.numpy(), np.asarray(jstats[3]), rtol=1e-6, atol=0)


def test_fresh_write_matches_jax():
    """B8's plain version against ``write_fresh`` (the JAX side block's DUS
    write) and against the JAX kernel ``fresh_write``, whose side block
    keeps the sequence on the last axis (codes (L, B, KV, D, W))."""
    d = _data(5)
    rng = np.random.default_rng(6)
    nk, nv = (rng.integers(-127, 128, (B, KV, D)).astype(np.int8) for _ in range(2))
    nks, nvs = (rng.random((B, KV)).astype(np.float32) for _ in range(2))
    li, t = 2, 5
    tfresh = tkv.fresh_from_jax_layout(d["kf"], d["vf"], d["ksf"], d["vsf"], device="cpu")
    tkv.write_fresh(tfresh, li, t, *(torch.from_numpy(a) for a in (nk, nv, nks, nvs)))
    got = tkv.fresh_to_jax_layout(tfresh)

    jfresh = jkv.FreshKV(k=jnp.asarray(d["kf"]), v=jnp.asarray(d["vf"]),
                         k_scale=jnp.asarray(d["ksf"]), v_scale=jnp.asarray(d["vsf"]))
    want = jax.jit(jkv.write_fresh, static_argnums=(1, 2))(
        jfresh, li, t, jnp.asarray(nk[..., None]), jnp.asarray(nv[..., None]),
        jnp.asarray(nks[..., None, None]), jnp.asarray(nvs[..., None, None]))
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(want, name)))

    # the JAX kernel on its own (.., D, W) layout, transposed back
    lane = lambda a: jnp.asarray(np.swapaxes(a, -1, -2))
    kfo, vfo, ksfo, vsfo = jda.fresh_write(
        (lane(d["kf"]), lane(d["vf"]), jnp.asarray(d["ksf"]), jnp.asarray(d["vsf"])),
        (jnp.asarray(nk[..., None]), jnp.asarray(nv[..., None]),
         jnp.asarray(nks[..., None, None]), jnp.asarray(nvs[..., None, None])), li, t)
    np.testing.assert_array_equal(got["k"], np.swapaxes(np.asarray(kfo), -1, -2))
    np.testing.assert_array_equal(got["v"], np.swapaxes(np.asarray(vfo), -1, -2))
    np.testing.assert_array_equal(got["k_scale"], np.asarray(ksfo))
    np.testing.assert_array_equal(got["v_scale"], np.asarray(vsfo))


@pytest.mark.parametrize("lengths", [(9, 9), (4, 11)])
def test_merge_fresh_matches_jax(lengths):
    """Both branches of the JAX merge: one shared offset, and per-slot."""
    d = _data(7)
    n = 5
    len0 = np.asarray(lengths, np.int32)
    jcache = jkv.KVCache(k=jnp.asarray(d["kc"]), v=jnp.asarray(d["vc"]),
                         k_scale=jnp.asarray(d["ks"]), v_scale=jnp.asarray(d["vs"]),
                         lengths=jnp.asarray(len0), quantized=True)
    jfresh = jkv.FreshKV(k=jnp.asarray(d["kf"]), v=jnp.asarray(d["vf"]),
                         k_scale=jnp.asarray(d["ksf"]), v_scale=jnp.asarray(d["vsf"]))
    want = jax.jit(jkv.merge_fresh, static_argnums=(3,))(jcache, jfresh, jnp.asarray(len0), n)
    tcache = tkv.from_jax_layout(d["kc"], d["vc"], d["ks"], d["vs"], len0, device="cpu")
    tfresh = tkv.fresh_from_jax_layout(d["kf"], d["vf"], d["ksf"], d["vsf"], device="cpu")
    tkv.merge_fresh(tcache, tfresh, tcache.lengths.clone(), n)
    got = tkv.to_jax_layout(tcache)
    for name in ("k", "v", "k_scale", "v_scale", "lengths"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(want, name)))


def test_fresh_layout_round_trip():
    d = _data(8)
    f = tkv.fresh_from_jax_layout(d["kf"], d["vf"], d["ksf"], d["vsf"], device="cpu")
    assert f.window == W and f.k_scale.shape == (L, B, KV, W)
    back = tkv.fresh_to_jax_layout(f)
    for name, key in (("k", "kf"), ("v", "vf"), ("k_scale", "ksf"), ("v_scale", "vsf")):
        np.testing.assert_array_equal(back[name], d[key])
    z = tkv.init_fresh(L, B, W, KV, D, device="cpu")
    ref = jkv.init_fresh(L, B, W, KV, D, quantized=True)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert tkv.fresh_to_jax_layout(z)[name].shape == getattr(ref, name).shape


def test_wrappers_check_inputs():
    q = torch.zeros((B, KV, r, D))
    c = torch.zeros((B, KV, S, D), dtype=torch.int8)
    s = torch.zeros((B, KV, S))
    lens = torch.zeros((B,), dtype=torch.int32)
    side = (torch.zeros((B, KV, W, D), dtype=torch.int8),) * 2 + (torch.zeros((B, KV, W)),) * 2
    with pytest.raises(ValueError, match="main_len"):
        tda.decode_attention(q, c, c, s, s, lens.long(), lens, scale=1.0)
    with pytest.raises(ValueError, match="outside"):
        tda.decode_attention(q, c, c, s, s, lens, lens, 0, W, side, scale=1.0)
    with pytest.raises(ValueError, match="qi must be int8"):
        tda.decode_attention_stats(q, q[..., :1], q[..., :1], q[..., :1], c, c, s, s, lens,
                                   lens, scale=1.0)
    fresh = (torch.zeros((L, B, KV, W, D), dtype=torch.int8),) * 2 + \
        (torch.zeros((L, B, KV, W)),) * 2
    new = (torch.zeros((B, KV, D), dtype=torch.int8),) * 2 + (torch.zeros((B, KV)),) * 2
    with pytest.raises(ValueError, match="outside the side block"):
        tda.fresh_write(fresh, new, L, 0)
    with pytest.raises(ValueError, match="kc"):
        tda.fresh_write(fresh, (new[0].float(),) + new[1:], 0, 0)


# ---------------------------------------------------------------------------
# decode_greedy_steps in the side-block modes. Config: hidden 128, 4 heads /
# 2 KV heads, head_dim 32, intermediate 128, 2 layers, vocab 512, float32,
# int4-g128 weights (one group per row, so the JAX pair-planes path and the
# port sum the same single f32 product), int8 per-token acts, an int8-g128
# head with int8 acts, an int8 KV cache. "two_part" at max_len 16, "hybrid"
# at 128 (the JAX hybrid gate needs max_len % 128 == 0). Each JAX run gets
# its own n, so that no earlier trace under other switches is reused.
# ---------------------------------------------------------------------------

CFG = dict(hidden_size=128, intermediate_size=128, num_heads=4, num_kv_heads=2,
           head_dim=32, num_layers=2, vocab_size=512)
QARGS = ("int4-g[128]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw")
T_PROMPT = 6
MODES = {"two_part": (16, 5), "hybrid": (128, 6)}       # max_len, n


@pytest.fixture(scope="module")
def side_runs():
    jcfg, tcfg = jm.tiny_config("llama", **CFG), tm.tiny_config("llama", **CFG)
    jq = jbuild(*QARGS, head_act="int8-g[-1]-rw")
    tq = tbuild(*QARGS, head_act="int8-g[-1]-rw")
    p = jm.init_params(jcfg, jax.random.PRNGKey(7))
    jalg.rtn(p, jcfg, jq, verbose=False)
    jalg.pack_model(p, jcfg, jq)
    tp = tm.stack_model(tm.fuse_model(params_from_numpy(jax_to_numpy(p), "cpu"), tcfg, tq))
    p = jm.stack_model(jm.fuse_model(p, jcfg, jq))
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (B, T_PROMPT)).astype(np.int32)
    mp = pytest.MonkeyPatch()
    runs = {}
    try:
        mp.setattr(jgen, "_ATTN_APPEND_OPTIN", False)
        for mode, (max_len, n) in MODES.items():
            mp.setattr(jda, "_FUSED_ATTN_OPTIN", mode == "hybrid")
            cache = j_init(jcfg.num_layers, B, max_len, jcfg.num_kv_heads, jcfg.head_dim,
                           quantized=True)
            logits, cache = j_prefill(p, jnp.asarray(toks), cache, cfg=jcfg, qcfg=jq)
            assert jgen.fresh_path_ok(p, jcfg, cache, jq)
            assert jgen._attn_kernel_ok(jcfg, max_len) == (mode == "hybrid")
            tok0 = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            j_toks, j_cache = j_greedy(p, tok0, cache, n=n, cfg=jcfg, qcfg=jq)
            port = {}
            for tmode in (mode, "append"):
                tcache = te.init_cache(tcfg.num_layers, B, max_len, tcfg.num_kv_heads,
                                       tcfg.head_dim, quantized=True, device="cpu")
                tl, tcache = te.prefill(tp, torch.from_numpy(toks), tcache, cfg=tcfg, qcfg=tq)
                ttok0 = torch.argmax(tl, -1).to(torch.int32)[:, None]
                t_toks, tcache = te.decode_greedy_steps(tp, ttok0, tcache, n=n, cfg=tcfg,
                                                        qcfg=tq, attention=tmode)
                port[tmode] = (ttok0.numpy(), t_toks.numpy(), tkv.to_jax_layout(tcache))
            runs[mode] = dict(j_tok0=np.asarray(tok0), j_toks=np.asarray(j_toks),
                              j_cache={k: np.asarray(getattr(j_cache, k))
                                       for k in ("k", "v", "k_scale", "v_scale", "lengths")},
                              port=port, n=n)
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("ref", ["jax", "append"])
def test_side_block_decode(side_runs, mode, ref):
    run = side_runs[mode]
    tok0, toks, cache = run["port"][mode]
    if ref == "jax":
        w_tok0, w_toks, w_cache = run["j_tok0"], run["j_toks"], run["j_cache"]
    else:
        w_tok0, w_toks, w_cache = run["port"]["append"]
    np.testing.assert_array_equal(tok0, w_tok0)
    np.testing.assert_array_equal(toks, w_toks)
    np.testing.assert_array_equal(cache["lengths"], w_cache["lengths"])
    w = slice(0, T_PROMPT + run["n"])
    for name in ("k", "v"):
        np.testing.assert_array_equal(cache[name][..., w], w_cache[name][..., w],
                                      err_msg=f"merged cache.{name} codes")
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(cache[name][..., w], w_cache[name][..., w], rtol=1e-6, atol=0)


def test_side_block_modes_refuse():
    """A bf16 cache (or unstacked layers) has no side-block path; an unknown
    mode raises."""
    cfg = tm.tiny_config("llama", **CFG)
    qcfg = tbuild(*QARGS, head_act="int8-g[-1]-rw")
    params = tm.stack_model(tm.init_params(cfg, device="cpu"))
    tok = torch.zeros((B, 1), dtype=torch.int32)
    cache = te.init_cache(cfg.num_layers, B, 16, cfg.num_kv_heads, cfg.head_dim, device="cpu")
    assert not tgen.fresh_path_ok(params, cfg, cache, qcfg)
    with pytest.raises(ValueError, match="two_part"):
        te.decode_greedy_steps(params, tok, cache, n=2, cfg=cfg, qcfg=qcfg, attention="two_part")
    with pytest.raises(ValueError, match="one of"):
        te.decode_greedy_steps(params, tok, cache, n=2, cfg=cfg, qcfg=qcfg, attention="fresh")
