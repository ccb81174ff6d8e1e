"""The whole slice against the JAX package: RTN -> pack -> fuse -> stack,
prefill into an int8 KV cache, then greedy decode — the JAX side through
``prefill`` + ``decode_greedy_steps`` (its W4A8 and fused-append attention
kernels in interpret mode), the port through its kernels' plain versions.

Config: hidden 256, intermediate 512, 4 heads / 2 KV heads, head_dim 64,
2 layers, vocab 512, float32, int4-g128 weights with int8 per-token acts,
an int8-g128 lm_head with int8 acts, ``max_len`` 128. The port receives the
JAX package's packed params (``convert.py``) and fuses and stacks them
itself.

Tolerances:
* tokens: equal. The JAX logits' top-2 gap (from ``decode_step``, which
  decodes the same tokens) is asserted above 1e-3 at every step, so an
  ulp-level difference cannot decide a near-tie.
* prefill logits: atol 1e-4 * max|logit| (f32 summation order).
* cache codes in the written window: at most one code step on at most
  0.1 % of entries — the k/v projections sum their f32 group parts in
  another order, which can move a value across a .5 rounding boundary.
* cache scales: rtol 1e-5 (same cause).
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
from llm_compressor_tpu.engine.generate import _sample as j_sample
from llm_compressor_tpu.engine.generate import decode_step as j_step
from llm_compressor_tpu.engine.generate import generate as j_generate
from llm_compressor_tpu.engine.generate import generate_text as j_generate_text
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu_torch import engine as te
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.engine import kvcache as tkv
from llm_compressor_tpu_torch.engine.kvcache import to_jax_layout
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from torch_port_util import jax_to_numpy, one_torch_thread  # noqa: F401

# the engine package re-exports ``generate`` under the module's name
tgen = importlib.import_module("llm_compressor_tpu_torch.engine.generate")

CFG = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
           head_dim=64, num_layers=2, vocab_size=512)
QARGS = ("int4-g[128]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw")
B, T, N_STEPS, MAX_LEN = 2, 6, 4, 128


@pytest.fixture(scope="module")
def slice_runs():
    jcfg, tcfg = jm.tiny_config("llama", **CFG), tm.tiny_config("llama", **CFG)
    jq = jbuild(*QARGS, head_act="int8-g[-1]-rw")
    tq = tbuild(*QARGS, head_act="int8-g[-1]-rw")
    p = jm.init_params(jcfg, jax.random.PRNGKey(0))
    jalg.rtn(p, jcfg, jq, verbose=False)
    jalg.pack_model(p, jcfg, jq)
    tp = tm.stack_model(tm.fuse_model(params_from_numpy(jax_to_numpy(p), "cpu"), tcfg, tq))
    p = jm.stack_model(jm.fuse_model(p, jcfg, jq))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)

    def j_prefilled():
        cache = j_init(jcfg.num_layers, B, MAX_LEN, jcfg.num_kv_heads, jcfg.head_dim,
                       quantized=True)
        logits, cache = j_prefill(p, jnp.asarray(toks), cache, cfg=jcfg, qcfg=jq)
        return logits, cache

    j_logits, cache = j_prefilled()
    tok0 = jnp.argmax(j_logits, -1).astype(jnp.int32)[:, None]
    j_toks, j_cache = j_greedy(p, tok0, cache, n=N_STEPS, cfg=jcfg, qcfg=jq)
    # per-step logits for the top-2 gap (decode_step decodes the same tokens)
    gaps = [np.asarray(j_logits)]
    _, cache = j_prefilled()
    tok = tok0
    for _ in range(N_STEPS - 1):
        logits, cache = j_step(p, tok, cache, cfg=jcfg, qcfg=jq)
        gaps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]

    tcache = te.init_cache(tcfg.num_layers, B, MAX_LEN, tcfg.num_kv_heads, tcfg.head_dim,
                           quantized=True, device="cpu")
    t_logits, tcache = te.prefill(tp, torch.from_numpy(toks), tcache, cfg=tcfg, qcfg=tq)
    ttok0 = torch.argmax(t_logits, -1).to(torch.int32)[:, None]
    t_toks, tcache = te.decode_greedy_steps(tp, ttok0, tcache, n=N_STEPS, cfg=tcfg, qcfg=tq)
    return dict(j_logits=np.asarray(j_logits), t_logits=t_logits.numpy(),
                j_tok0=np.asarray(tok0), t_tok0=ttok0.numpy(), gaps=gaps,
                j_toks=np.asarray(j_toks), t_toks=t_toks.numpy(),
                j_cache={k: np.asarray(getattr(j_cache, k))
                         for k in ("k", "v", "k_scale", "v_scale", "lengths")},
                t_cache=to_jax_layout(tcache))


def test_reference_has_no_near_ties(slice_runs):
    for logits in slice_runs["gaps"]:
        top2 = np.sort(logits, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-3


def test_prefill_logits(slice_runs):
    j, t = slice_runs["j_logits"], slice_runs["t_logits"]
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * np.abs(j).max())


def test_greedy_tokens_equal(slice_runs):
    np.testing.assert_array_equal(slice_runs["t_tok0"], slice_runs["j_tok0"])
    np.testing.assert_array_equal(slice_runs["t_toks"], slice_runs["j_toks"])


@pytest.mark.parametrize("name", ["k", "v"])
def test_cache_codes(slice_runs, name):
    w = slice(0, T + N_STEPS)
    a = slice_runs["j_cache"][name][..., w].astype(np.int32)
    b = slice_runs["t_cache"][name][..., w].astype(np.int32)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_array_equal(slice_runs["t_cache"]["lengths"],
                                  slice_runs["j_cache"]["lengths"])


@pytest.mark.parametrize("name", ["k_scale", "v_scale"])
def test_cache_scales(slice_runs, name):
    w = slice(0, T + N_STEPS)
    np.testing.assert_allclose(slice_runs["t_cache"][name][..., w],
                               slice_runs["j_cache"][name][..., w], rtol=1e-5, atol=0)


def test_kv_row_quant_matches_jax():
    """The cache's row quantizer: codes and scales bitwise equal to the JAX
    one under jit, where the decode and prefill paths run it."""
    x = np.random.default_rng(4).normal(size=(2, 5, 2, 64)).astype(np.float32)
    jc, js = jax.jit(jkv._quant_i8)(jnp.asarray(x))          # (B, KV, D, T), (B, KV, 1, T)
    tc, ts = tkv._quant_i8(torch.from_numpy(x))             # (B, KV, T, D), (B, KV, T)
    np.testing.assert_array_equal(np.swapaxes(np.asarray(jc), -1, -2), tc.numpy())
    np.testing.assert_array_equal(np.asarray(js)[:, :, 0], ts.numpy())


def test_kv_layout_round_trip():
    """to_jax_layout gives the JAX cache's shapes, and from_jax_layout
    inverts it exactly."""
    rng = np.random.default_rng(5)
    L_, B_, KV_, S_, D_ = 2, 3, 2, 16, 64
    cache = tkv.KVCache(
        k=torch.from_numpy(rng.integers(-127, 128, (L_, B_, KV_, S_, D_)).astype(np.int8)),
        v=torch.from_numpy(rng.integers(-127, 128, (L_, B_, KV_, S_, D_)).astype(np.int8)),
        k_scale=torch.from_numpy(rng.random((L_, B_, KV_, S_)).astype(np.float32)),
        v_scale=torch.from_numpy(rng.random((L_, B_, KV_, S_)).astype(np.float32)),
        lengths=torch.tensor([3, 0, 16], dtype=torch.int32))
    j = to_jax_layout(cache)
    ref = j_init(L_, B_, S_, KV_, D_, quantized=True)
    for name in ("k", "v", "k_scale", "v_scale", "lengths"):
        assert j[name].shape == getattr(ref, name).shape
    back = tkv.from_jax_layout(**j, device="cpu")
    for name in ("k", "v", "k_scale", "v_scale", "lengths"):
        assert torch.equal(getattr(back, name), getattr(cache, name))


# ---------------------------------------------------------------------------
# The weight-only slice: zero-point int4 weights without act quantizers, an
# int8-g128 lm_head, a bf16 KV cache. Every projection of prefill (M = 12)
# and decode goes through B5 — on the JAX side the Pallas kernel in
# interpret mode, in the port its plain version — and the attention is
# exact float attention over the bf16 window.
#
# Tolerances:
# * tokens: equal, with the JAX logits' top-2 gap asserted above 1e-3.
# * prefill logits: one bf16 ulp of the largest logit, 2**-7 * max|logit|.
#   B5 rounds its f32 input to bf16, so an f32 summation-order difference
#   upstream can move an input element across a bf16 rounding boundary,
#   which moves the outputs by |w| times that element's bf16 ulp.
# * bf16 cache: equal after conversion, outside at most 0.1 % of entries
#   that may sit one bf16 ulp apart (a k/v value whose f32 sums differ in
#   order can cross a bf16 rounding boundary). The f32 model's B5 returns
#   f32 k/v, summed in another order by the interpret-mode kernel and by the
#   plain version; test_weight_only_bf16_cache_bitwise_in_one_sum_order
#   shows that with one summation order on both sides the cache is bitwise
#   equal.
# ---------------------------------------------------------------------------

WO_QARGS = ("int4-g[128]-zp-rw", None, None, "int8-g[128]-rw")


@pytest.fixture(scope="module")
def wo_runs():
    jcfg, tcfg = jm.tiny_config("llama", **CFG), tm.tiny_config("llama", **CFG)
    jq, tq = jbuild(*WO_QARGS), tbuild(*WO_QARGS)
    p = jm.init_params(jcfg, jax.random.PRNGKey(1))
    jalg.rtn(p, jcfg, jq, verbose=False)
    jalg.pack_model(p, jcfg, jq)
    tp = tm.stack_model(tm.fuse_model(params_from_numpy(jax_to_numpy(p), "cpu"), tcfg, tq))
    p = jm.stack_model(jm.fuse_model(p, jcfg, jq))
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)

    cache = j_init(jcfg.num_layers, B, MAX_LEN, jcfg.num_kv_heads, jcfg.head_dim)
    j_logits, cache = j_prefill(p, jnp.asarray(toks), cache, cfg=jcfg, qcfg=jq)
    tok0 = jnp.argmax(j_logits, -1).astype(jnp.int32)[:, None]
    gaps = [np.asarray(j_logits)]
    c2 = jax.tree_util.tree_map(jnp.copy, cache)
    tok = tok0
    for _ in range(N_STEPS - 1):
        logits, c2 = j_step(p, tok, c2, cfg=jcfg, qcfg=jq)
        gaps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    j_toks, j_cache = j_greedy(p, tok0, cache, n=N_STEPS, cfg=jcfg, qcfg=jq)
    j_gen = j_generate(p, jcfg, toks, max_new_tokens=N_STEPS, qcfg=jq)

    tcache = te.init_cache(tcfg.num_layers, B, MAX_LEN, tcfg.num_kv_heads, tcfg.head_dim,
                           device="cpu")
    t_logits, tcache = te.prefill(tp, torch.from_numpy(toks), tcache, cfg=tcfg, qcfg=tq)
    ttok0 = torch.argmax(t_logits, -1).to(torch.int32)[:, None]
    t_toks, tcache = te.decode_greedy_steps(tp, ttok0, tcache, n=N_STEPS, cfg=tcfg, qcfg=tq)
    t_gen = te.generate(tp, tcfg, toks, max_new_tokens=N_STEPS, qcfg=tq)
    return dict(j_logits=np.asarray(j_logits), t_logits=t_logits.numpy(), gaps=gaps,
                j_tok0=np.asarray(tok0), t_tok0=ttok0.numpy(),
                j_toks=np.asarray(j_toks), t_toks=t_toks.numpy(),
                j_cache={k: np.asarray(getattr(j_cache, k)) for k in ("k", "v", "lengths")},
                t_cache=to_jax_layout(tcache), j_gen=j_gen, t_gen=t_gen,
                tp=tp, tcfg=tcfg, tq=tq, toks=toks, t_dtype=tcache.k.dtype,
                jp=p, jcfg=jcfg, jq=jq)


def test_weight_only_reference_has_no_near_ties(wo_runs):
    for logits in wo_runs["gaps"]:
        top2 = np.sort(logits, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-3


def test_weight_only_prefill_logits(wo_runs):
    j, t = wo_runs["j_logits"], wo_runs["t_logits"]
    np.testing.assert_allclose(t, j, rtol=0, atol=2.0 ** -7 * np.abs(j).max())


def test_weight_only_greedy_tokens_equal(wo_runs):
    np.testing.assert_array_equal(wo_runs["t_tok0"], wo_runs["j_tok0"])
    np.testing.assert_array_equal(wo_runs["t_toks"], wo_runs["j_toks"])


@pytest.mark.parametrize("name", ["k", "v"])
def test_weight_only_bf16_cache(wo_runs, name):
    assert wo_runs["t_dtype"] == torch.bfloat16 and wo_runs["t_cache"]["k_scale"] is None
    a = wo_runs["j_cache"][name].astype(np.float32)
    b = wo_runs["t_cache"][name]
    assert a.shape == b.shape
    differ = a != b
    assert differ.mean() <= 1e-3, differ.sum()
    np.testing.assert_allclose(b[differ], a[differ], rtol=2.0 ** -7, atol=0)
    np.testing.assert_array_equal(wo_runs["t_cache"]["lengths"], wo_runs["j_cache"]["lengths"])


def _pairwise_b5(x, w, bias):
    """y = x @ w for bf16-valued f32 x (.., C) and w (C, N): the exact
    products summed pairwise in one fixed order (halves added elementwise),
    the same code for jax and torch arrays."""
    pr = x.reshape(-1, x.shape[-1])[:, None, :] * w.T[None]
    while pr.shape[-1] > 1:
        h = pr.shape[-1] // 2
        pr = pr[..., :h] + pr[..., h:]
    y = pr[..., 0]
    y = y if bias is None else y + bias
    return y.reshape(tuple(x.shape[:-1]) + (y.shape[-1],))


def test_weight_only_bf16_cache_bitwise_in_one_sum_order(wo_runs, monkeypatch):
    """The bf16 cache entries that differ from JAX's come from the order of
    B5's f32 sums: with both packages' B5 replaced by one pairwise sum of
    the same bf16 products (each side's weight read out of its own B5
    through x = I), the cache and the tokens are bitwise equal."""
    r = wo_runs
    jdm = importlib.import_module("llm_compressor_tpu.kernels.dequant_matmul")
    tdm = importlib.import_module("llm_compressor_tpu_torch.kernels.dequant_matmul")
    j_b5, t_b5 = jdm.dequant_matmul, tdm.dequant_matmul

    def j_pairwise(x, qt, bias=None):
        C = x.shape[-1]
        w = j_b5(jnp.eye(C, dtype=jnp.bfloat16), qt).astype(jnp.float32)
        xb = x.astype(jnp.bfloat16).astype(jnp.float32)
        return _pairwise_b5(xb, w, bias).astype(x.dtype)

    def t_pairwise(x, qt, bias=None):
        C = x.shape[-1]
        w = t_b5(torch.eye(C, dtype=torch.bfloat16), qt).float()
        xb = x.to(torch.bfloat16).float()
        return _pairwise_b5(xb, w, bias).to(x.dtype)

    monkeypatch.setattr(jdm, "dequant_matmul", j_pairwise)
    monkeypatch.setattr(tdm, "dequant_matmul", t_pairwise)
    jax.clear_caches()   # prefill and decode were traced with the kernel
    try:
        cache = j_init(2, B, MAX_LEN, 2, 64)
        logits, cache = j_prefill(r["jp"], jnp.asarray(r["toks"]), cache, cfg=r["jcfg"],
                                  qcfg=r["jq"])
        tok0 = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        j_toks, j_cache = j_greedy(r["jp"], tok0, cache, n=N_STEPS, cfg=r["jcfg"], qcfg=r["jq"])
        tcache = te.init_cache(2, B, MAX_LEN, 2, 64, device="cpu")
        tlogits, tcache = te.prefill(r["tp"], torch.from_numpy(r["toks"]), tcache,
                                     cfg=r["tcfg"], qcfg=r["tq"])
        ttok0 = torch.argmax(tlogits, -1).to(torch.int32)[:, None]
        t_toks, tcache = te.decode_greedy_steps(r["tp"], ttok0, tcache, n=N_STEPS,
                                                cfg=r["tcfg"], qcfg=r["tq"])
    finally:
        jax.clear_caches()
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    t = to_jax_layout(tcache)
    for name in ("k", "v"):
        np.testing.assert_array_equal(t[name], np.asarray(getattr(j_cache, name)).astype(np.float32))


def test_generate_greedy_equals_jax(wo_runs):
    assert wo_runs["t_gen"].dtype == np.int32
    np.testing.assert_array_equal(wo_runs["t_gen"], np.asarray(wo_runs["j_gen"]))


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_generate_eos_matches_jax(wo_runs, quantized_kv):
    """EOS on slot 0 ends both loops at the same step, over the bf16 cache
    and over an int8 cache (float attention on the dequantized window)."""
    r = wo_runs
    eos = int(np.asarray(r["j_gen"])[0, T + 1])
    kw = dict(max_new_tokens=N_STEPS, eos_id=eos, quantized_kv=quantized_kv)
    want = np.asarray(j_generate(r["jp"], r["jcfg"], r["toks"], qcfg=r["jq"], **kw))
    got = te.generate(r["tp"], r["tcfg"], r["toks"], qcfg=r["tq"], **kw)
    assert want.shape[1] < T + N_STEPS
    np.testing.assert_array_equal(got, want)


def test_generate_max_len(wo_runs, monkeypatch):
    """``max_len`` sizes the cache and changes no token."""
    r = wo_runs
    sizes = []

    def recording(*args, **kw):
        cache = tkv.init_cache(*args, **kw)
        sizes.append(cache.max_len)
        return cache

    monkeypatch.setattr(tgen, "init_cache", recording)
    got = te.generate(r["tp"], r["tcfg"], r["toks"], max_new_tokens=N_STEPS, qcfg=r["tq"],
                      max_len=MAX_LEN)
    np.testing.assert_array_equal(got, r["t_gen"])
    te.generate(r["tp"], r["tcfg"], r["toks"], max_new_tokens=N_STEPS, qcfg=r["tq"])
    assert sizes == [MAX_LEN, T + N_STEPS]


class ByteTokenizer:
    """A byte-level stand-in for a HF tokenizer: UTF-8 bytes in, one
    character per id out."""
    eos_token_id = 3

    def encode(self, text):
        return list(text.encode())

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids)


@pytest.mark.parametrize("template", [True, False])
def test_generate_text_equals_jax(wo_runs, template):
    r = wo_runs
    kw = dict(max_new_tokens=N_STEPS, use_chat_template=template)
    want = j_generate_text(r["jp"], r["jcfg"], ByteTokenizer(), "Name a colour.", qcfg=r["jq"],
                           **kw)
    got = te.generate_text(r["tp"], r["tcfg"], ByteTokenizer(), "Name a colour.", qcfg=r["tq"],
                           **kw)
    assert got == want and len(got) > 0


def test_generate_text_speculative_equals_jax(wo_runs, caplog):
    """``speculative=True`` routes greedy generation through
    ``generate_speculative`` in both packages: the same text, which is
    also the text of plain greedy generation, and one acceptance line on
    the port's logger."""
    r = wo_runs
    kw = dict(max_new_tokens=N_STEPS + 4, speculative=True, k_draft=3)
    want = j_generate_text(r["jp"], r["jcfg"], ByteTokenizer(), "Name a colour.", qcfg=r["jq"],
                           **kw)
    with caplog.at_level("INFO", logger="llm_compressor_tpu_torch"):
        got = te.generate_text(r["tp"], r["tcfg"], ByteTokenizer(), "Name a colour.",
                               qcfg=r["tq"], **kw)
    assert got == want and len(got) > 0
    assert got == te.generate_text(r["tp"], r["tcfg"], ByteTokenizer(), "Name a colour.",
                                   qcfg=r["tq"], max_new_tokens=N_STEPS + 4)
    assert [m for m in caplog.messages if m.startswith("speculative: mean_accepted=")]


def test_sampling_is_seeded(wo_runs):
    """The same seed gives the same samples; another seed may not. Every
    sampled token lies in its step's top-k."""
    r = wo_runs
    run = lambda seed: te.generate(r["tp"], r["tcfg"], r["toks"], max_new_tokens=3,
                                   temperature=1.0, top_k=5, qcfg=r["tq"], seed=seed)
    a, b = run(7), run(7)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (B, T + 3)
    np.testing.assert_array_equal(a[:, :T], r["toks"])


@pytest.mark.parametrize("top_k", [1, 5, 40])
def test_top_k_mask_matches_jax(top_k):
    """The port's top-k filter keeps the entries that the JAX ``_sample``
    can draw: with k = 1 both sample the argmax, and every JAX draw from
    the filtered logits lies in the port's kept set."""
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(4, 64)).astype(np.float32)
    logits[0, :3] = logits[0].max()                   # ties at the top
    kept = np.isfinite(tgen.top_k_filter(torch.from_numpy(logits), top_k).numpy())
    kth = np.sort(logits, axis=-1)[:, -top_k][:, None]
    np.testing.assert_array_equal(kept, logits >= kth)
    for i in range(20):
        s = np.asarray(j_sample(jnp.asarray(logits), 1.0, top_k, jax.random.PRNGKey(i)))
        assert kept[np.arange(4), s].all()
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        s = tgen._sample(torch.from_numpy(logits), 1.0, top_k, g).numpy()
        assert kept[np.arange(4), s].all()


def test_kv_layout_round_trip_bf16():
    """A bf16 cache crosses to the JAX layout as float32 (exact) and back."""
    rng = np.random.default_rng(9)
    L_, B_, KV_, S_, D_ = 2, 3, 2, 16, 64
    vals = lambda: torch.from_numpy(rng.normal(size=(L_, B_, KV_, S_, D_)).astype(np.float32))
    cache = tkv.KVCache(k=vals().to(torch.bfloat16), v=vals().to(torch.bfloat16),
                        k_scale=None, v_scale=None, lengths=torch.tensor([3, 0, 16],
                                                                         dtype=torch.int32))
    j = to_jax_layout(cache)
    ref = j_init(L_, B_, S_, KV_, D_)
    assert not cache.quantized and j["k_scale"] is None
    for name in ("k", "v", "lengths"):
        assert j[name].shape == getattr(ref, name).shape
    back = tkv.from_jax_layout(**j, device="cpu")
    for name in ("k", "v", "lengths"):
        assert torch.equal(getattr(back, name), getattr(cache, name))
    # and from the JAX cache's own bf16 arrays
    jk = np.asarray(jnp.asarray(j["k"], jnp.bfloat16))
    assert torch.equal(tkv.from_jax_layout(jk, jk, None, None, j["lengths"], device="cpu").k,
                       cache.k)


def test_full_f32_accumulation_sets_and_restores(monkeypatch):
    """The context turns off bf16 reduced-precision reduction inside its
    block and restores the previous value after, also on an exception;
    ``prefill`` runs its forward and head inside it."""
    from llm_compressor_tpu_torch.device import full_f32_accumulation

    cm = torch.backends.cuda.matmul
    prev = cm.allow_bf16_reduced_precision_reduction
    try:
        for before in (True, False):
            cm.allow_bf16_reduced_precision_reduction = before
            with full_f32_accumulation():
                assert cm.allow_bf16_reduced_precision_reduction is False
            assert cm.allow_bf16_reduced_precision_reduction is before
        cm.allow_bf16_reduced_precision_reduction = True
        with pytest.raises(RuntimeError, match="inside"):
            with full_f32_accumulation():
                raise RuntimeError("inside")
        assert cm.allow_bf16_reduced_precision_reduction is True

        gen_mod = importlib.import_module("llm_compressor_tpu_torch.engine.generate")
        seen = []

        def forward(*a, **k):
            seen.append(cm.allow_bf16_reduced_precision_reduction)
            raise RuntimeError("stop")

        monkeypatch.setattr(gen_mod, "_forward_cached", forward)
        with pytest.raises(RuntimeError, match="stop"):
            gen_mod.prefill({}, torch.zeros((1, 2), dtype=torch.int32), None, cfg=None)
        assert seen == [False] and cm.allow_bf16_reduced_precision_reduction is True
    finally:
        cm.allow_bf16_reduced_precision_reduction = prev
