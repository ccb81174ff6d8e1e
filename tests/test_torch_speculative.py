"""Speculative decoding against the JAX package (mirrors
``test_speculative.py``): the n-gram proposer, the device drafts, the
verify step over a bf16 and an int8 cache, the rounds on the device, and
``generate_speculative``, accepting and falling back.

Config: the tiny float32 Llama (2 layers, vocab 256), random weights from
``PRNGKey(seed)`` handed to the port as numpy; the quantized serving
config of the JAX test is int8 per-token acts over float weights.
Tolerances: ids, accept counts, lengths and int8 cache codes equal; the
int8 cache's scales and the bf16 cache's values to 1e-6 relative (the
k/v projections sum in another order); the acceptance statistics equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu.engine import init_cache as j_init_cache
from llm_compressor_tpu.engine import prefill as j_prefill
from llm_compressor_tpu.engine import speculative as jspec
from llm_compressor_tpu.models import init_params as j_init_params
from llm_compressor_tpu.models import tiny_config as j_tiny
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.engine import generate, init_cache, prefill
from llm_compressor_tpu_torch.engine import speculative as tspec
from llm_compressor_tpu_torch.engine.generate import decode_step
from llm_compressor_tpu_torch.engine.kvcache import to_jax_layout
from llm_compressor_tpu_torch.models import tiny_config
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from torch_port_util import jax_to_numpy, one_torch_thread  # noqa: F401

QSPEC = ("int4-g[16]-rw", "int8-g[-1]-rw", None, None)


def _model(seed):
    jcfg = j_tiny("llama", num_layers=2, dtype="float32")
    jp = j_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, tiny_config("llama", num_layers=2), params_from_numpy(jax_to_numpy(jp),
                                                                           "cpu")


def test_propose_ngram_finds_repeat():
    h = [5, 6, 7, 8, 5, 6]
    # the trailing bigram (5, 6) occurred at 0: continuation 7, 8
    assert tspec.propose_ngram(h, 2) == [7, 8] == jspec.propose_ngram(h, 2)
    # k longer than the continuation pads with the last token
    assert tspec.propose_ngram(h, 4) == [7, 8, 5, 6] == jspec.propose_ngram(h, 4)


def test_propose_ngram_fallback():
    assert tspec.propose_ngram([1, 2, 3], 3) == [3, 3, 3]      # short history
    h = [4, 9, 9, 9, 9, 2]
    assert tspec.propose_ngram(h, 2)[0] in (9, 2)
    assert tspec.propose_ngram(h, 2) == jspec.propose_ngram(h, 2)


def _same_cache(jc, tc, n):
    """Rows [0, n) of two caches: codes and lengths equal, scales or bf16
    values to 1e-6 relative."""
    t = to_jax_layout(tc)
    np.testing.assert_array_equal(t["lengths"], np.asarray(jc.lengths))
    for name in ("k", "v"):
        a = np.asarray(getattr(jc, name)).astype(np.float32)[..., :n]
        b = t[name].astype(np.float32)[..., :n]
        if tc.quantized:
            np.testing.assert_array_equal(b, a, err_msg=name)
            np.testing.assert_allclose(t[name + "_scale"][..., :n],
                                       np.asarray(getattr(jc, name + "_scale"))[..., :n],
                                       rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(b, a, rtol=2.0 ** -7, atol=0, err_msg=name)


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_verify_step_matches_sequential_decode_and_jax(quantized_kv):
    """One T = 3 verify forward gives the greedy tokens of 3 sequential
    decode steps, the JAX verify step's tokens, accept counts and lengths,
    and its cache."""
    jcfg, jp, tcfg, tp = _model(0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    steps = rng.integers(0, tcfg.vocab_size, (2, 3)).astype(np.int32)

    def t_cache():
        cache = init_cache(tcfg.num_layers, 2, 32, tcfg.num_kv_heads, tcfg.head_dim,
                           quantized=quantized_kv, device="cpu")
        return prefill(tp, torch.from_numpy(toks), cache, cfg=tcfg)[1]

    cache = t_cache()
    seq = []
    for j in range(3):
        logits, cache = decode_step(tp, torch.from_numpy(steps[:, j:j + 1]), cache, cfg=tcfg)
        seq.append(torch.argmax(logits, -1).numpy())
    cache_b = t_cache()
    got, accepted, cache_b = tspec.decode_verify_step(
        tp, torch.from_numpy(steps), cache_b, torch.ones(2, dtype=torch.bool), cfg=tcfg)
    np.testing.assert_array_equal(got.numpy(), np.stack(seq, axis=1))
    np.testing.assert_array_equal(cache_b.k[..., :9, :].float().numpy(),
                                  cache.k[..., :9, :].float().numpy())
    for b in range(2):
        a = 0
        while a < 2 and steps[b, a + 1] == got[b, a]:
            a += 1
        assert int(accepted[b]) == a
    np.testing.assert_array_equal(cache_b.lengths.numpy(), 6 + accepted.numpy() + 1)

    jc = j_init_cache(jcfg.num_layers, 2, 32, jcfg.num_kv_heads, jcfg.head_dim,
                      quantized=quantized_kv)
    _, jc = j_prefill(jp, jnp.asarray(toks), jc, cfg=jcfg)
    jgot, jacc, jc = jspec.decode_verify_step(jp, jnp.asarray(steps), jc,
                                              jnp.ones((2,), bool), cfg=jcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    np.testing.assert_array_equal(accepted.numpy(), np.asarray(jacc))
    _same_cache(jc, cache_b, 9)


@pytest.mark.parametrize("qspec", [None, QSPEC])
def test_speculative_matches_greedy_and_jax(qspec):
    """Greedy-exact: the token streams of plain argmax decoding, and the
    JAX package's streams and statistics, over an int8 cache, for float
    weights and for the quantized serving config."""
    jcfg, jp, tcfg, tp = _model(1)
    jq, tq = (jbuild(*qspec), tbuild(*qspec)) if qspec else (None, None)
    prompts = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 7)).astype(np.int32)
    ref = generate(tp, tcfg, prompts, max_new_tokens=10, qcfg=tq, quantized_kv=True)
    kw = dict(max_new_tokens=10, k_draft=3, quantized_kv=True)
    hist, stats = tspec.generate_speculative(tp, tcfg, prompts, qcfg=tq, **kw)
    jhist, jstats = jspec.generate_speculative(jp, jcfg, prompts, qcfg=jq, **kw)
    for b in range(2):
        np.testing.assert_array_equal(np.asarray(hist[b]), ref[b])
        assert hist[b] == [int(t) for t in jhist[b]]
    assert stats == jstats
    assert 0.0 <= stats["mean_accepted"] <= 3.0
    assert stats["live_rounds"] <= stats["rounds"]


def test_device_draft_matches_host_proposer():
    """draft_ngram_device == propose_ngram == the JAX device drafts, over
    seeded histories, lengths and gram sizes."""
    rng = np.random.default_rng(7)
    Hmax, B, k = 24, 6, 4
    for trial in range(32):
        lens = rng.integers(1, Hmax - 1, B)
        hist = rng.integers(0, 5, (B, Hmax)).astype(np.int32)         # a small vocab
        ngram = 1 + trial % 3
        want = np.stack([np.asarray(tspec.propose_ngram(list(map(int, hist[b, :lens[b]])), k,
                                                        ngram), np.int32) for b in range(B)])
        got = tspec.draft_ngram_device(torch.from_numpy(hist), torch.from_numpy(lens).int(), k,
                                       ngram).numpy()
        jgot = np.asarray(jspec.draft_ngram_device(jnp.asarray(hist),
                                                   jnp.asarray(lens, jnp.int32), k, ngram))
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial} lens={lens}")
        np.testing.assert_array_equal(got, jgot, err_msg=f"trial {trial}")


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_speculative_rounds_match_jax(quantized_kv):
    """Four rounds over a looping prompt from the same prefilled state: the
    history, its lengths, the accept counts and the cache of the JAX
    rounds; slot 1 inactive stays frozen."""
    jcfg, jp, tcfg, tp = _model(2)
    B, T, Hmax, R, k = 2, 20, 64, 4, 3
    prompt = np.tile(np.array([3, 1, 4, 1, 5], np.int32), (B, 4))
    active = np.array([True, False])
    jc = j_init_cache(jcfg.num_layers, B, 96, jcfg.num_kv_heads, jcfg.head_dim,
                      quantized=quantized_kv)
    jlogits, jc = j_prefill(jp, jnp.asarray(prompt), jc, cfg=jcfg)
    tc = init_cache(tcfg.num_layers, B, 96, tcfg.num_kv_heads, tcfg.head_dim,
                    quantized=quantized_kv, device="cpu")
    tlogits, tc = prefill(tp, torch.from_numpy(prompt), tc, cfg=tcfg)
    first = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    np.testing.assert_array_equal(torch.argmax(tlogits, -1).numpy(), first)
    hist = np.zeros((B, Hmax), np.int32)
    hist[:, :T], hist[:, T] = prompt, first
    hlen = np.full((B,), T + 1, np.int32)
    jh, jl, jc, jacc = jspec.speculative_rounds(jp, jnp.asarray(hist), jnp.asarray(hlen), jc,
                                                jnp.asarray(active), rounds=R, k=k, ngram=2,
                                                cfg=jcfg)
    th, tl, tc, tacc = tspec.speculative_rounds(tp, torch.from_numpy(hist.copy()),
                                                torch.from_numpy(hlen.copy()), tc,
                                                torch.from_numpy(active), rounds=R, k=k,
                                                ngram=2, cfg=tcfg)
    assert tacc.shape == (R, B) and int(tacc[:, 0].sum()) > 0
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tl[1]) == T + 1 and int(tc.lengths[1]) == T
    _same_cache(jc, tc, int(tl.max()))


def test_speculative_accepts_on_repetitive_text():
    """On a cyclic prompt the tiny random model loops, and prompt-lookup
    drafts are accepted; the port gives the JAX package's tokens and
    acceptance."""
    jcfg, jp, tcfg, tp = _model(2)
    base = np.array([3, 1, 4, 1, 5] * 4, np.int32)[None, :]
    kw = dict(max_new_tokens=12, k_draft=4, accept_floor=0)
    hist, stats = tspec.generate_speculative(tp, tcfg, base, **kw)
    jhist, jstats = jspec.generate_speculative(jp, jcfg, base, **kw)
    assert len(hist[0]) == base.shape[1] + 12
    assert hist[0] == [int(t) for t in jhist[0]] and stats == jstats
    assert stats["mean_accepted"] > 0.0


def test_speculative_fallback_is_greedy_exact():
    """With an accept floor no draft can meet, the loop falls back to
    greedy decoding mid-stream: the tokens still equal plain greedy
    decoding and the JAX package's."""
    jcfg, jp, tcfg, tp = _model(3)
    prompts = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 7)).astype(np.int32)
    ref = generate(tp, tcfg, prompts, max_new_tokens=24, quantized_kv=True)
    kw = dict(max_new_tokens=24, k_draft=3, quantized_kv=True, accept_floor=4.0,
              floor_window=2, rounds_per_dispatch=2)
    hist, stats = tspec.generate_speculative(tp, tcfg, prompts, **kw)
    jhist, jstats = jspec.generate_speculative(jp, jcfg, prompts, **kw)
    assert stats["fell_back"] and stats == jstats
    for b in range(2):
        np.testing.assert_array_equal(np.asarray(hist[b]), ref[b])
        assert hist[b] == [int(t) for t in jhist[b]]
