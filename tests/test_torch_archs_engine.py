"""The serving engine and calibration of Qwen2, Qwen3, Gemma, Gemma2 and
Gemma3 against the JAX package: RTN -> pack -> fuse -> stack, prefill into
an int8 KV cache, then greedy decode — the JAX side through ``prefill`` +
``decode_greedy_steps`` (its Pallas kernels in interpret mode), the port
through its kernels' plain versions; the side-block decodes (``two_part``,
``hybrid``) of Gemma2 and Gemma3 under the JAX package's matching
switches; the batcher and speculative decoding on Gemma2; GPTQ on Gemma2
and Qwen3, teacher-forced.

Config: each architecture's ``tiny_config`` at hidden 256, intermediate
512, head_dim 64, vocab 512, 2 layers, float32, int4-g128 weights with
int8 per-token acts (on the attention matmuls too), an int8-g128 lm_head
with int8 acts, ``max_len`` 128. The norms' weights and Qwen2's q/k/v
biases are drawn from a seed (``init_params`` gives ones, zeros), so each
is exercised. Gemma2 and Gemma3 slide a window of 8 on layer 0: a prompt
of 6 tokens and 6 steps cross it.

Tolerances:
* tokens: equal, with the JAX logits' top-2 gap asserted above 1e-3 at
  every step, so an ulp-level difference cannot decide a near-tie.
* prefill logits: atol 1e-4 * max|logit| (f32 summation order), unless
  an int8 activation code flips. An ulp of difference (the f32 sums'
  order; XLA's gelu-tanh and tanh, the Gemma activations and softcaps,
  round an ulp apart from PyTorch's) can move a code across a .5
  boundary, and prefill's float attention fake-quantizes K per channel
  over the whole window, which spreads that step over the slot
  (``test_torch_models.py`` holds Llama's long prompts the same way).
  Then: a relative L2 of at most 2e-2 and the same argmax.
* int8 cache codes in the written window: at most one step apart on at
  most 0.1 % of a layer's entries (``test_torch_generate.py``'s bound, for
  the same cause), scales rtol 1e-5, layer by layer. A flipped code in a
  slot's layer is read back by prefill's float attention and moves that
  slot's later layers by more than a code (Qwen2 here: one V code of
  layer 0, then 213 K codes of layer 1, up to 3 steps, in that slot):
  a slot's layers after its first flip are held by the tokens alone. Here
  only Qwen2's second slot flips; the other architectures' caches are
  bitwise equal.
* GPTQ: ``torch_port_util.check_gptq_chain``'s bounds, on int4-g64
  weights without activation quantizers, over 16 x 64 calibration tokens
  (more tokens than the down projection's 512 columns: a Hessian of full
  rank; with 4 x 16 tokens GPTQ's error feedback carries an ulp of
  difference into codes two steps apart). With int8 acts, flipped act
  codes in layer 0's attention move layer 1's input by 6e-3 (Qwen3) and
  1.5e-2 (Gemma2) of its largest entry, over the chain's 1e-3.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import models as jm
from llm_compressor_tpu.capture import capture_layer0 as j_capture_layer0
from llm_compressor_tpu.engine import ContinuousBatcher as JBatcher
from llm_compressor_tpu.engine import decode_greedy_steps as j_greedy, init_cache as j_init
from llm_compressor_tpu.engine.speculative import generate_speculative as j_spec
from llm_compressor_tpu.engine import prefill as j_prefill
from llm_compressor_tpu.engine.generate import decode_step as j_step
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import engine as te
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.capture import capture_layer0 as t_capture_layer0
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.engine.kvcache import to_jax_layout
from llm_compressor_tpu_torch.qformats import QTensor
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from torch_port_util import (  # noqa: F401
    check_gptq_chain,
    jax_to_numpy,
    one_torch_thread,
    randomize,
    recording_gptq_chain,
)

jda = importlib.import_module("llm_compressor_tpu.kernels.decode_attention")
jgen = importlib.import_module("llm_compressor_tpu.engine.generate")

ARCHS = ["qwen2", "qwen3", "gemma", "gemma2", "gemma3"]
WIDTHS = dict(hidden_size=256, intermediate_size=512, head_dim=64, vocab_size=512)
QARGS = ("int4-g[128]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw")
B, T, N_STEPS, MAX_LEN = 2, 6, 6, 128


def _qcfgs():
    return (jbuild(*QARGS, head_act="int8-g[-1]-rw"),
            tbuild(*QARGS, head_act="int8-g[-1]-rw"))


def dense_pair(arch, seed=0, **over):
    """(jcfg, tcfg, JAX params, port params): the same float32 weights."""
    jcfg, tcfg = jm.tiny_config(arch, **over), tm.tiny_config(arch, **over)
    tree = randomize(jax_to_numpy(jm.init_params(jcfg, jax.random.PRNGKey(seed))), seed + 1)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def packed_pair(arch, seed=0, **over):
    """RTN'd and packed by the JAX package, handed over; then fused and
    stacked in each package."""
    jcfg, tcfg, p, _ = dense_pair(arch, seed, **WIDTHS, **over)
    jq, tq = _qcfgs()
    jalg.rtn(p, jcfg, jq, verbose=False)
    jalg.pack_model(p, jcfg, jq)
    tp = tm.stack_model(tm.fuse_model(params_from_numpy(jax_to_numpy(p), "cpu"), tcfg, tq))
    p = jm.stack_model(jm.fuse_model(p, jcfg, jq))
    return jcfg, tcfg, jq, tq, p, tp


def _prompt(seed=3, shape=(B, T)):
    return np.random.default_rng(seed).integers(0, WIDTHS["vocab_size"], shape).astype(np.int32)


def _j_cache(jcfg):
    return j_init(jcfg.num_layers, B, MAX_LEN, jcfg.num_kv_heads, jcfg.head_dim, quantized=True)


def _t_cache(tcfg):
    return te.init_cache(tcfg.num_layers, B, MAX_LEN, tcfg.num_kv_heads, tcfg.head_dim,
                         quantized=True, device="cpu")


def _cache_np(c):
    return {k: np.asarray(getattr(c, k)) for k in ("k", "v", "k_scale", "v_scale", "lengths")}


def _run_port(tp, tcfg, tq, toks, mode):
    tcache = _t_cache(tcfg)
    tl, tcache = te.prefill(tp, torch.from_numpy(toks), tcache, cfg=tcfg, qcfg=tq)
    tok0 = torch.argmax(tl, -1).to(torch.int32)[:, None]
    toks_out, tcache = te.decode_greedy_steps(tp, tok0, tcache, n=N_STEPS, cfg=tcfg, qcfg=tq,
                                              attention=mode)
    return dict(logits=tl.numpy(), tok0=tok0.numpy(), toks=toks_out.numpy(),
                cache=to_jax_layout(tcache))


def _run_jax(p, jcfg, jq, toks, mode):
    """JAX prefill + greedy steps under the switches of ``mode``, and the
    logits of each step from ``decode_step`` (which decodes the same
    tokens) for the top-2 gaps."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jgen, "_ATTN_APPEND_OPTIN", mode == "append")
        mp.setattr(jda, "_FUSED_ATTN_OPTIN", mode == "hybrid")
        logits, cache = j_prefill(p, jnp.asarray(toks), _j_cache(jcfg), cfg=jcfg, qcfg=jq)
        if mode != "append":
            assert jgen.fresh_path_ok(p, jcfg, cache, jq)
            assert jgen._attn_kernel_ok(jcfg, MAX_LEN) == (mode == "hybrid")
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


RUNS = [(a, "append") for a in ARCHS] + [(a, m) for a in ("gemma2", "gemma3")
                                           for m in ("two_part", "hybrid")]


@pytest.fixture(scope="module")
def models():
    return {}


@pytest.fixture(scope="module")
def runs():
    return {}


def _get_run(models, runs, arch, mode):
    if arch not in models:
        models[arch] = packed_pair(arch, seed=ARCHS.index(arch))
    if (arch, mode) not in runs:
        jcfg, tcfg, jq, tq, p, tp = models[arch]
        toks = _prompt()
        runs[(arch, mode)] = (_run_jax(p, jcfg, jq, toks, mode),
                              _run_port(tp, tcfg, tq, toks, mode))
    return runs[(arch, mode)]


@pytest.mark.parametrize("arch,mode", RUNS)
def test_packed_decode_matches_jax(models, runs, arch, mode):
    j, t = _get_run(models, runs, arch, mode)
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
    _check_codes(t["cache"], j["cache"], T + N_STEPS)


def _check_codes(got, want, n):
    """Codes and scales of rows [0, n), layer by layer, each slot up to and
    including its first layer with a flipped code (see the module doc)."""
    L, nb = got["k"].shape[:2]
    flipped = np.zeros(nb, bool)
    for layer in range(L):
        live = ~flipped
        diffs = [np.abs(got[c][layer, live, ..., :n].astype(np.int32)
                        - want[c][layer, live, ..., :n].astype(np.int32)) for c in ("k", "v")]
        for c, d in zip(("k", "v"), diffs):
            assert d.max(initial=0) <= 1 and (d > 0).mean() <= 1e-3, (layer, c)
        for c in ("k_scale", "v_scale"):
            np.testing.assert_allclose(got[c][layer, live, ..., :n], want[c][layer, live, ..., :n],
                                       rtol=1e-5, atol=0, err_msg=f"layer {layer} {c}")
        flip = sum((d > 0).reshape(d.shape[0], -1).any(-1) for d in diffs)
        flipped[np.flatnonzero(live)[flip > 0]] = True


@pytest.mark.parametrize("arch", ["gemma2", "gemma3"])
@pytest.mark.parametrize("mode", ["two_part", "hybrid"])
def test_side_block_matches_append(models, runs, arch, mode):
    """The port's side-block decode gives its in-place decode's tokens and
    merged cache codes."""
    _, side = _get_run(models, runs, arch, mode)
    _, app = _get_run(models, runs, arch, "append")
    np.testing.assert_array_equal(side["toks"], app["toks"])
    w = slice(0, T + N_STEPS)
    for name in ("k", "v"):
        np.testing.assert_array_equal(side["cache"][name][..., w], app["cache"][name][..., w])


@pytest.mark.parametrize("arch", ["gemma2", "gemma3"])
def test_greedy_steps_match_per_step_decode(models, arch):
    """``decode_greedy_steps`` against ``decode_step`` one token at a time
    (JAX ``tests/test_greedy_steps.py``): the same tokens, bitwise equal
    cache codes and scales, the window crossed."""
    if arch not in models:
        models[arch] = packed_pair(arch, seed=ARCHS.index(arch))
    _, tcfg, _, tq, _, tp = models[arch]
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
    for name in ("k", "v", "k_scale", "v_scale", "lengths"):
        assert torch.equal(getattr(fast_cache, name), getattr(cache, name)), name


def test_window_bites():
    """Gemma2's window changes the decode: without it the logits past
    position 8 differ."""
    jcfg, tcfg, jq, tq, p, tp = packed_pair("gemma2", seed=3)
    toks = _prompt()
    out = {}
    for w in (8, None):
        cfg = tm.tiny_config("gemma2", **WIDTHS, sliding_window=w)
        tcache = _t_cache(cfg)
        lg, tcache = te.prefill(tp, torch.from_numpy(toks), tcache, cfg=cfg, qcfg=tq)
        seq = [lg]
        tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
        for _ in range(N_STEPS):
            lg, tcache = te.decode_step(tp, tok, tcache, cfg=cfg, qcfg=tq)
            seq.append(lg)
        out[w] = torch.stack(seq)
    # positions 6, 7, 8 see at most 8 keys: the same; from position 9 on not
    assert torch.equal(out[8][:3], out[None][:3])
    assert not torch.allclose(out[8][4:], out[None][4:])


# ---------------------------------------------------------------------------
# the batcher and speculative decoding on Gemma2
# ---------------------------------------------------------------------------


def test_batcher_gemma2_matches_jax(models):
    """Two requests over 2 slots, chunks of 4 (a prompt of 7 is two chunks),
    8 new tokens each: positions cross the window of 8."""
    if "gemma2" not in models:
        models["gemma2"] = packed_pair("gemma2", seed=ARCHS.index("gemma2"))
    jcfg, tcfg, jq, tq, p, tp = models["gemma2"]
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
def test_speculative_gemma2_matches_jax(quantized_kv):
    """Prompt-lookup speculative decoding on a repetitive prompt, 12 new
    tokens (the verify steps' (k+1)-row forwards cross the window)."""
    jcfg, tcfg, p, tp = dense_pair("gemma2", 11, **WIDTHS)
    motif = np.random.default_rng(6).integers(0, WIDTHS["vocab_size"], 3)
    prompts = np.tile(motif, (2, 3)).astype(np.int32)
    j_out, j_stats = j_spec(p, jcfg, prompts, max_new_tokens=12, k_draft=3,
                            quantized_kv=quantized_kv)
    t_out, t_stats = te.generate_speculative(tp, tcfg, prompts, max_new_tokens=12, k_draft=3,
                                             quantized_kv=quantized_kv)
    for b in range(2):
        assert t_out[b] == [int(t) for t in j_out[b]]
    assert t_stats == j_stats


# ---------------------------------------------------------------------------
# calibration: RTN and packing of every architecture, GPTQ on Gemma2, Qwen3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_rtn_and_pack_match_jax(arch):
    jcfg, tcfg, p, tp = dense_pair(arch, 21, **WIDTHS)
    jq, tq = _qcfgs()
    jalg.rtn(p, jcfg, jq, verbose=False)
    jalg.pack_model(p, jcfg, jq)
    talg.rtn(tp, tcfg, tq)
    talg.pack_model(tp, tcfg, tq)
    want = params_from_numpy(jax_to_numpy(p), "cpu")
    for jl, tl in zip(want["layers"], tp["layers"]):
        for grp in ("attn", "mlp"):
            for slot, node in jl[grp].items():
                a, b = node["weight"], tl[grp][slot]["weight"]
                if not isinstance(a, QTensor):     # the q/k norms
                    assert torch.equal(a, b), (grp, slot)
                    continue
                assert torch.equal(a.codes, b.codes) and torch.equal(a.scales, b.scales)
                if "bias" in node:
                    assert torch.equal(node["bias"], tl[grp][slot]["bias"])


@pytest.mark.parametrize("arch", ["gemma2", "qwen3"])
def test_gptq_chain_matches_jax(arch):
    """The port's GPTQ over the capture pipeline (per-layer rope and mask,
    Gemma's pre-feed-forward norm before the ``mlp_in`` tap) held to the
    JAX package's functions layer by layer, teacher-forced."""
    jcfg, tcfg, p, tp = dense_pair(arch, 31, **WIDTHS)
    jq, tq = jbuild("int4-g[64]-rw", None, None, None), tbuild("int4-g[64]-rw", None, None, None)
    toks = np.random.default_rng(8).integers(0, WIDTHS["vocab_size"], (16, 64)).astype(np.int32)
    hidden0 = np.asarray(j_capture_layer0(p, jcfg, jnp.asarray(toks)).hidden)
    ctx = t_capture_layer0(tp, tcfg, toks)
    book = {}
    with recording_gptq_chain() as calls:
        talg.gptq(tp, tcfg, ctx, tq, scale_book=book)
    gptq_w = {(i, s): talg.common.get_weight(tp["layers"][i], s)
              for i in range(tcfg.num_layers) for s in tm.transformer.arch_slots(tcfg)}
    worst = check_gptq_chain(calls, jcfg, jq, gptq_w, book, hidden0)
    assert worst["hidden"] <= 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_spinquant_refuses_other_families(arch):
    """SpinQuant stays Llama-only, as in the JAX package (reference
    ``core.py:63-71``)."""
    cfg = tm.tiny_config(arch)
    params = tm.init_params(cfg, device="cpu")
    toks = np.zeros((2, 8), np.int32)
    with pytest.raises(NotImplementedError, match="llama family"):
        talg.spinquant(params, cfg, toks, _qcfgs()[1])
    with pytest.raises(NotImplementedError, match="llama-family"):
        jalg.spinquant(jm.init_params(jm.tiny_config(arch), jax.random.PRNGKey(0)),
                       jm.tiny_config(arch), jnp.asarray(toks), _qcfgs()[0])
