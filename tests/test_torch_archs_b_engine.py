"""The serving engine of OPT, OPT-350m, BLOOM and Phi against the JAX
package: RTN -> pack -> fuse -> stack, prefill into an int8 KV cache, then
greedy decode in the three ``attention=`` modes — the JAX side through
``prefill`` + ``decode_greedy_steps`` under the matching switches (its
Pallas kernels in interpret mode), the port through its kernels' plain
versions; the batcher and speculative decoding.

What the modes run here: OPT's query reaches the int8 attention (B4; B8 +
B7; B8 + B6) already scaled, with the kernels' scale 1.0; OPT-350m adds
``project_in`` / ``project_out`` and the post-norm; Phi is multi-head
(r = 1) with a partial rotary and the parallel residual; BLOOM's ALiBi
keeps its attention on the float path in all three modes, as the JAX
package keeps it on the carried cache under either switch.

Config: each architecture's ``tiny_config`` at hidden 256, intermediate
512, head_dim 64 (4 heads), vocab 512, 2 layers, float32 (OPT-350m with
``project_in_dim`` 128 and post-norm), int4-g128 weights with int8
per-token acts (on the attention matmuls too), an int8-g128 lm_head with
int8 acts, ``max_len`` 128. The norms' weights and every bias are drawn
from a seed.

Tolerances, as ``test_torch_archs_engine.py`` states and holds them:
tokens equal with the JAX logits' top-2 gap above 1e-3 at every step;
prefill logits within 1e-4 * max|logit| unless an int8 activation code
flips (then relative L2 2e-2 and the same argmax); int8 cache codes up to
each slot's first layer with a flipped code at most one step apart on at
most 0.1 % of the entries, scales rtol 1e-5 (BLOOM: see
``_check_codes_float_attention``). The batcher's and the speculative
rounds' tokens and stats: equal.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu.engine import ContinuousBatcher as JBatcher
from llm_compressor_tpu.engine import decode_greedy_steps as j_greedy
from llm_compressor_tpu.engine import prefill as j_prefill
from llm_compressor_tpu.engine.generate import decode_step as j_step
from llm_compressor_tpu.engine.speculative import generate_speculative as j_spec
from llm_compressor_tpu_torch import engine as te
from test_torch_archs_engine import (
    MAX_LEN,
    N_STEPS,
    T,
    WIDTHS,
    _cache_np,
    _check_codes,
    _j_cache,
    _prompt,
    _run_port,
    _t_cache,
    dense_pair,
    packed_pair,
)
from torch_port_util import one_torch_thread  # noqa: F401

jda = importlib.import_module("llm_compressor_tpu.kernels.decode_attention")
jgen = importlib.import_module("llm_compressor_tpu.engine.generate")

# name -> (arch, tiny_config overrides at WIDTHS)
VARIANTS = {"opt": ("opt", {}),
            "opt350m": ("opt", dict(project_in_dim=128, do_layer_norm_before=False)),
            "bloom": ("bloom", {}), "phi": ("phi", {})}
NAMES = list(VARIANTS)
MODES = ("append", "two_part", "hybrid")


# weights' seeds: the JAX reference decodes without a top-2 gap under 1e-3
# (OPT-350m's logits are small, about 0.25 at most: its post-norm and the
# 128-wide project_out; seeds 11 and 14 give gaps under 1e-4)
SEEDS = {"opt": 10, "opt350m": 16, "bloom": 12, "phi": 13}


def _packed(name):
    arch, over = VARIANTS[name]
    return packed_pair(arch, seed=SEEDS[name], **over)


def _run_jax(p, jcfg, jq, toks, mode):
    """JAX prefill + greedy steps under the switches of ``mode`` (the
    side-block path where ``fresh_path_ok``, which BLOOM's ALiBi turns
    off), and each step's logits from ``decode_step`` for the top-2 gaps."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jgen, "_ATTN_APPEND_OPTIN", mode == "append")
        mp.setattr(jda, "_FUSED_ATTN_OPTIN", mode == "hybrid")
        logits, cache = j_prefill(p, jnp.asarray(toks), _j_cache(jcfg), cfg=jcfg, qcfg=jq)
        assert jgen.fresh_path_ok(p, jcfg, cache, jq) == (jcfg.pos_embedding != "alibi")
        tok0 = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        j_toks, j_cache = j_greedy(p, tok0, cache, n=N_STEPS, cfg=jcfg, qcfg=jq)
    finally:
        mp.undo()
    gaps = [np.asarray(logits)]
    _, cache = j_prefill(p, jnp.asarray(toks), _j_cache(jcfg), cfg=jcfg, qcfg=jq)
    tok = tok0
    for _ in range(N_STEPS - 1):
        lg, cache = j_step(p, tok, cache, cfg=jcfg, qcfg=jq)
        gaps.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
    return dict(logits=np.asarray(logits), tok0=np.asarray(tok0), toks=np.asarray(j_toks),
                cache=_cache_np(j_cache), gaps=gaps)


@pytest.fixture(scope="module")
def models():
    return {}


@pytest.fixture(scope="module")
def runs():
    return {}


def _model(models, name):
    if name not in models:
        models[name] = _packed(name)
    return models[name]


def _get_run(models, runs, name, mode):
    if (name, mode) not in runs:
        jcfg, tcfg, jq, tq, p, tp = _model(models, name)
        toks = _prompt()
        runs[(name, mode)] = (_run_jax(p, jcfg, jq, toks, mode),
                              _run_port(tp, tcfg, tq, toks, mode))
    return runs[(name, mode)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_packed_decode_matches_jax(models, runs, name, mode):
    j, t = _get_run(models, runs, name, mode)
    for lg in j["gaps"]:
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-3
    tl, jl = t["logits"], j["logits"]
    if not np.allclose(tl, jl, rtol=0, atol=1e-4 * np.abs(jl).max()):
        assert np.linalg.norm(tl - jl) <= 2e-2 * np.linalg.norm(jl)
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    np.testing.assert_array_equal(t["tok0"], j["tok0"])
    np.testing.assert_array_equal(t["toks"], j["toks"])
    np.testing.assert_array_equal(t["cache"]["lengths"], j["cache"]["lengths"])
    if name == "bloom":
        _check_codes_float_attention(t["cache"], j["cache"], T + N_STEPS)
    else:
        _check_codes(t["cache"], j["cache"], T + N_STEPS)


def _check_codes_float_attention(got, want, n):
    """BLOOM's cache: every step's attention is the float path, with the
    W4A8 config's int8 fake quantization of q, of K and V per channel over
    the whole window, and of the probs per row, so an ulp of difference
    flips act codes there (not only in the cache) and a flipped act code
    moves the K/V rows of its token in the next layer (here: 3 tokens of
    slot 0 in layer 1). Held: layer 0 as ``_check_codes`` holds it; every
    code of the written window at most one step apart."""
    _check_codes({k: v[:1] for k, v in got.items() if k != "lengths"},
                 {k: v[:1] for k, v in want.items() if k != "lengths"}, n)
    for c in ("k", "v"):
        d = np.abs(got[c][..., :n].astype(np.int32) - want[c][..., :n].astype(np.int32))
        assert d.max() <= 1, c


@pytest.mark.parametrize("mode", ["two_part", "hybrid"])
@pytest.mark.parametrize("name", NAMES)
def test_side_block_matches_append(models, runs, name, mode):
    """The port's side-block decode gives its in-place decode's tokens and
    merged cache codes (BLOOM: the same float-path steps)."""
    _, side = _get_run(models, runs, name, mode)
    _, app = _get_run(models, runs, name, "append")
    np.testing.assert_array_equal(side["toks"], app["toks"])
    w = slice(0, T + N_STEPS)
    for c in ("k", "v"):
        np.testing.assert_array_equal(side["cache"][c][..., w], app["cache"][c][..., w])


@pytest.mark.parametrize("name", NAMES)
def test_greedy_steps_match_per_step_decode(models, name):
    """``decode_greedy_steps`` against ``decode_step`` one token at a time:
    the same tokens, bitwise equal cache codes and scales."""
    _, tcfg, _, tq, _, tp = _model(models, name)
    toks = torch.from_numpy(_prompt())

    def prefilled():
        lg, cache = te.prefill(tp, toks, _t_cache(tcfg), cfg=tcfg, qcfg=tq)
        return torch.argmax(lg, -1).to(torch.int32)[:, None], cache

    tok, cache = prefilled()
    fast, fast_cache = te.decode_greedy_steps(tp, tok, cache, n=N_STEPS, cfg=tcfg, qcfg=tq)
    tok, cache = prefilled()
    slow = []
    for _ in range(N_STEPS):
        lg, cache = te.decode_step(tp, tok, cache, cfg=tcfg, qcfg=tq)
        tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
        slow.append(tok)
    assert torch.equal(fast, torch.cat(slow, 1))
    for c in ("k", "v", "k_scale", "v_scale", "lengths"):
        assert torch.equal(getattr(fast_cache, c), getattr(cache, c)), c


# ---------------------------------------------------------------------------
# the batcher and speculative decoding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_batcher_matches_jax(models, name):
    """Two requests over 2 slots, chunks of 4 (a prompt of 7 is two chunks:
    OPT's learned positions and BLOOM's ALiBi past the first chunk), 8 new
    tokens each."""
    jcfg, tcfg, jq, tq, p, tp = _model(models, name)
    prompts = _prompt(5, (2, 7))
    jeng = JBatcher(p, jcfg, batch_slots=2, max_len=MAX_LEN, prefill_chunk=4, qcfg=jq,
                    quantized_kv=True)
    teng = te.ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=MAX_LEN, prefill_chunk=4,
                                qcfg=tq, quantized_kv=True)
    for q in prompts:
        jeng.submit(q, max_new_tokens=8)
        teng.submit(q, max_new_tokens=8)
    want, got = jeng.run(), teng.run()
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("quantized_kv", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_speculative_matches_jax(name, quantized_kv):
    """Prompt-lookup speculative decoding on a repetitive prompt, 12 new
    tokens: the verify steps' (k+1)-row forwards at each slot's positions
    (OPT's learned positions, BLOOM's ALiBi over the cache window)."""
    arch, over = VARIANTS[name]
    jcfg, tcfg, p, tp = dense_pair(arch, 20 + NAMES.index(name), **WIDTHS, **over)
    motif = np.random.default_rng(6).integers(0, WIDTHS["vocab_size"], 3)
    prompts = np.tile(motif, (2, 3)).astype(np.int32)
    j_out, j_stats = j_spec(p, jcfg, prompts, max_new_tokens=12, k_draft=3,
                            quantized_kv=quantized_kv)
    t_out, t_stats = te.generate_speculative(tp, tcfg, prompts, max_new_tokens=12, k_draft=3,
                                             quantized_kv=quantized_kv)
    for b in range(2):
        assert t_out[b] == [int(t) for t in j_out[b]]
    assert t_stats == j_stats
