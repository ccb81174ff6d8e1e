"""The transformer core of Qwen2, Qwen3, Gemma, Gemma2 and Gemma3 against
the JAX package and ``transformers``: ``forward``, the HF configs, the
compressed checkpoint in both directions, ``fuse_model`` with biases,
``uniform_layers``, and the JAX model tests' checks (shapes, causality,
the softcap's bound, stacked against unstacked layers).

Configs: each architecture's ``tiny_config`` (hidden 64, 4 heads, head_dim
16, 2 layers, vocab 256, float32; Gemma2 and Gemma3 slide a window of 8 on
layer 0), Gemma3 with linear rope scaling on its global layers, as
``tests/test_hf_parity.py`` builds it. The norms' weights and Qwen2's
biases are drawn from a seed (``init_params`` gives ones and zeros).

Tolerances:
* ``forward`` against the JAX package, float32: atol 1e-5 * max|logit|
  (the same math in another summation order).
* against ``transformers``: ``test_hf_parity``'s rtol = atol = 2e-3.
* configs, checkpoints, fused weights and uniformity: equal.
* stacked against unstacked layers in the port: bitwise.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import transformers

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import models as jm
from llm_compressor_tpu.models.params import load_compressed as j_load_compressed
from llm_compressor_tpu.models.params import save_compressed as j_save_compressed
from llm_compressor_tpu.models.transformer import quant_uniform as j_quant_uniform
from llm_compressor_tpu.models.transformer import uniform_layers as j_uniform_layers
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import engine as te
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.qformats import QTensor
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from test_torch_checkpoint import _assert_same_files, _assert_same_qtensor
from torch_port_util import jax_to_numpy, one_torch_thread, randomize  # noqa: F401

ARCHS = ["qwen2", "qwen3", "gemma", "gemma2", "gemma3"]
LINEAR_ROPE = dict(kind="linear", factor=8.0)


def _cfgs(arch, **kw):
    jkw, tkw = dict(kw), dict(kw)
    if arch == "gemma3":
        jkw.setdefault("rope_scaling", jm.RopeScaling(**LINEAR_ROPE))
        tkw.setdefault("rope_scaling", tm.RopeScaling(**LINEAR_ROPE))
    return jm.tiny_config(arch, **jkw), tm.tiny_config(arch, **tkw)


def _pair(arch, seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    tree = randomize(jax_to_numpy(jm.init_params(jcfg, jax.random.PRNGKey(seed))), seed + 1)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _tokens(cfg, shape=(2, 12), seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """T = 12 > the window of 8: the local layers' masks bite."""
    jcfg, tcfg, p, tp = _pair(arch)
    toks = _tokens(jcfg)
    j = np.asarray(jm.forward(p, jcfg, jnp.asarray(toks)))
    t = tm.forward(tp, tcfg, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max())


# ---------------------------------------------------------------------------
# transformers
# ---------------------------------------------------------------------------

HF_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=64, attn_implementation="eager")


def _hf_tiny(arch):
    t = transformers
    if arch == "qwen2":
        return t.Qwen2Config(**HF_TINY, num_key_value_heads=2)
    if arch == "qwen3":
        return t.Qwen3Config(**HF_TINY, num_key_value_heads=2, head_dim=16)
    if arch == "gemma":
        return t.GemmaConfig(**HF_TINY, num_key_value_heads=4, head_dim=16)
    if arch == "gemma2":
        return t.Gemma2Config(**HF_TINY, num_key_value_heads=2, head_dim=16,
                              query_pre_attn_scalar=16, sliding_window=8,
                              attn_logit_softcapping=50.0, final_logit_softcapping=30.0)
    return t.Gemma3TextConfig(**HF_TINY, num_key_value_heads=2, head_dim=16,
                              query_pre_attn_scalar=16, sliding_window=8,
                              rope_theta=1000000.0, rope_local_base_freq=10000.0,
                              rope_scaling={"rope_type": "linear", "factor": 8.0})


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_transformers(arch):
    hf_cfg = _hf_tiny(arch)
    torch.manual_seed(0)
    model = transformers.AutoModelForCausalLM.from_config(hf_cfg).eval().to(torch.float32)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 16))
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.numpy()
    cfg = dataclasses.replace(tm.from_hf_config(hf_cfg), dtype="float32")
    params = tm.load_params_from_state_dict(cfg, model.state_dict(), device="cpu")
    ours = tm.forward(params, cfg, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-3)


def _same_fields(j, t):
    for f in dataclasses.fields(t):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if f.name == "rope_scaling" and a is not None:
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name


@pytest.mark.parametrize("arch", ARCHS)
def test_hf_config_round_trip(arch):
    """``to_hf_config`` -> ``from_hf_config`` gives the config back, and
    the JAX package reads the same dict field for field; a
    ``transformers`` config reads as the JAX package reads it."""
    _, cfg = _cfgs(arch, dtype="bfloat16")
    hf = tm.to_hf_config(cfg)
    assert tm.from_hf_config(hf) == cfg
    _same_fields(jm.from_hf_config(hf), cfg)
    hf_obj = _hf_tiny(arch)
    _same_fields(jm.from_hf_config(hf_obj), tm.from_hf_config(hf_obj))
    assert hf["architectures"][0] == type(
        transformers.AutoModelForCausalLM.from_config(hf_obj)).__name__


# ---------------------------------------------------------------------------
# the compressed checkpoint, both directions
# ---------------------------------------------------------------------------

W4A8 = ("int4-g[64]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw")
SLOTS = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
         ("mlp", "gate"), ("mlp", "up"), ("mlp", "down"))


def _float_leaves(tree, prefix=""):
    """(path, tensor) of every float leaf that is not a packed weight."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _float_leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _float_leaves(v, f"{prefix}.{i}")
    elif not isinstance(tree, QTensor):
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trip(tmp_path, arch):
    """RTN W4A8 in each package from the same weights; each package's
    files the same bytes; the port reads the JAX package's and the JAX
    package the port's, every QTensor, bias and norm bitwise."""
    jcfg, tcfg, jp, tp = _pair(arch, seed=2, hidden_size=128, intermediate_size=256,
                               head_dim=32)
    jq, tq = jbuild(*W4A8), tbuild(*W4A8)
    jalg.rtn(jp, jcfg, jq, verbose=False)
    jalg.pack_model(jp, jcfg, jq)
    talg.rtn(tp, tcfg, tq)
    talg.pack_model(tp, tcfg, tq)
    hf = tm.to_hf_config(tcfg)
    j_save_compressed(jp, jcfg, tmp_path / "jax", hf_config=hf)
    tm.save_compressed(tp, tcfg, tmp_path / "port", hf_config=hf)
    _assert_same_files(tmp_path / "jax", tmp_path / "port")
    t_loaded = tm.load_compressed(tmp_path / "jax", tcfg, tq, device="cpu")
    j_loaded = params_from_numpy(jax_to_numpy(j_load_compressed(tmp_path / "port", jcfg, jq)),
                                 "cpu")
    for i in range(jcfg.num_layers):
        for grp, slot in SLOTS:
            want = jp["layers"][i][grp][slot]["weight"]
            _assert_same_qtensor(want, t_loaded["layers"][i][grp][slot]["weight"], (i, slot))
            _assert_same_qtensor(want, j_loaded["layers"][i][grp][slot]["weight"], (i, slot))
    for loaded in (t_loaded, j_loaded):
        got = dict(_float_leaves(loaded))
        want = dict(_float_leaves(params_from_numpy(jax_to_numpy(jp), "cpu")))
        want.pop(".lm_head.weight", None)         # the tied packed head is not written
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    if arch == "qwen2":
        assert "bias" in t_loaded["layers"][0]["attn"]["q"]
    if arch in ("gemma2", "gemma3"):
        assert {"pre_ffw_norm", "post_ffw_norm", "post_attn_norm"} <= set(t_loaded["layers"][0])


# ---------------------------------------------------------------------------
# serving transforms, uniformity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_fuse_with_bias_matches_jax(packed):
    """Qwen2's q|k|v biases concatenate with the weights (a bias-less
    entry would get zeros), as in JAX; the fused forward is unchanged."""
    jcfg, tcfg, jp, tp = _pair("qwen2", seed=3, hidden_size=128, intermediate_size=256,
                               head_dim=32)
    jq, tq = (jbuild(*W4A8), tbuild(*W4A8)) if packed else (None, None)
    toks = _tokens(jcfg, (2, 5))
    if packed:
        jalg.rtn(jp, jcfg, jq, verbose=False)
        jalg.pack_model(jp, jcfg, jq)
        tp = params_from_numpy(jax_to_numpy(jp), "cpu")
    before = tm.forward(tp, tcfg, torch.from_numpy(toks), tq)
    want = params_from_numpy(jax_to_numpy(jm.fuse_model(jp, jcfg, jq)), "cpu")
    got = tm.fuse_model(tp, tcfg, tq)
    for jl, tl in zip(want["layers"], got["layers"]):
        assert torch.equal(jl["attn"]["qkv_cat"]["bias"], tl["attn"]["qkv_cat"]["bias"])
        a, b = jl["attn"]["qkv_cat"]["weight"], tl["attn"]["qkv_cat"]["weight"]
        if packed:
            _assert_same_qtensor(a, b, "qkv_cat")
        else:
            assert torch.equal(a, b)
        assert "bias" not in tl["mlp"]["gateup"]
    after = tm.forward(got, tcfg, torch.from_numpy(toks), tq)
    torch.testing.assert_close(after, before, rtol=0, atol=1e-5 * float(before.abs().max()))


@pytest.mark.parametrize("arch", ["llama"] + ARCHS)
def test_uniform_layers_matches_jax(arch):
    for kw in ({}, {"num_layers": 4}):
        jcfg, tcfg = _cfgs(arch, **kw)
        for jq, tq in ((None, None), (jbuild(*W4A8), tbuild(*W4A8))):
            assert tm.uniform_layers(tcfg, tq) == j_uniform_layers(jcfg, jq)
            assert tm.quant_uniform(tcfg, tq) == j_quant_uniform(jcfg, jq)
    assert tm.uniform_layers(tcfg, None) == (arch not in ("gemma2", "gemma3"))


# ---------------------------------------------------------------------------
# the JAX model tests' checks (tests/test_models.py, tests/test_scan_layers.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", tm.SUPPORTED_ARCHS)
def test_forward_shapes(arch):
    cfg = tm.tiny_config(arch)
    params = tm.init_params(cfg, device="cpu")
    logits = tm.forward(params, cfg, torch.from_numpy(_tokens(cfg)))
    assert logits.shape == (2, 12, cfg.vocab_size) and bool(torch.isfinite(logits).all())


def test_causal_dependence():
    """Changing a future token must not change past logits (Gemma2: the
    window and the softcaps)."""
    cfg = tm.tiny_config("gemma2")
    params = tm.init_params(cfg, seed=1, device="cpu")
    toks = _tokens(cfg, (1, 10), 1)
    toks2 = toks.copy()
    toks2[0, -1] = (toks2[0, -1] + 1) % cfg.vocab_size
    l1 = tm.forward(params, cfg, torch.from_numpy(toks))
    l2 = tm.forward(params, cfg, torch.from_numpy(toks2))
    assert torch.equal(l1[0, :-1], l2[0, :-1])
    assert not torch.allclose(l1[0, -1], l2[0, -1], atol=1e-5)


def test_sliding_window_masks_differ():
    """Gemma2 over 32 tokens: finite, the final softcap bounds the logits,
    and the window changes them past position 8."""
    cfg = tm.tiny_config("gemma2")
    params = tm.init_params(cfg, seed=3, scale=0.2, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, 32), 3))
    logits = tm.forward(params, cfg, toks)
    assert bool(torch.isfinite(logits).all())
    assert float(logits.abs().max()) <= cfg.final_logit_softcapping + 1e-3
    full = tm.forward(params, dataclasses.replace(cfg, sliding_window=None), toks)
    assert torch.equal(logits[:, :8], full[:, :8])
    assert not torch.allclose(logits[:, 9:], full[:, 9:])


@pytest.mark.parametrize("arch", ["gemma2", "gemma3", "qwen3"])
def test_stacked_forward_matches(arch):
    """Stacked layers (the serving form) give the unstacked forward's
    logits, windows and local rope included; T > the window."""
    cfg = tm.tiny_config(arch, num_layers=4)
    params = tm.init_params(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (2, 12)))
    ref = tm.forward(params, cfg, toks)
    assert torch.equal(tm.forward(tm.stack_model(params), cfg, toks), ref)


@pytest.mark.parametrize("arch", ["gemma2", "gemma3"])
def test_stacked_sliding_window_decode_matches(arch):
    """prefill + decode_step over a bf16 cache, stacked and unstacked,
    past the window: the same logits."""
    cfg = tm.tiny_config(arch, num_layers=4)
    params = tm.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, 12), 2))

    def run(p):
        cache = te.init_cache(cfg.num_layers, 1, 12, cfg.num_kv_heads, cfg.head_dim,
                              device="cpu")
        logits, cache = te.prefill(p, toks[:, :10], cache, cfg=cfg)
        out = [logits]
        for t in range(10, 12):
            logits, cache = te.decode_step(p, toks[:, t:t + 1], cache, cfg=cfg)
            out.append(logits)
        return torch.stack(out)

    assert torch.equal(run(tm.stack_model(params)), run(params))


# ---------------------------------------------------------------------------
# the attention output projection's bias (a Llama with attention_bias=True)
# ---------------------------------------------------------------------------

BIASED_LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                    max_position_embeddings=64, attention_bias=True,
                    attn_implementation="eager")


def _biased_llama(seed=0, **kw):
    """A ``transformers`` Llama with ``attention_bias=True`` (q, k, v and o
    biased) in float32, its biases drawn N(0, 0.5) and its norms N(1, 0.1)
    from ``seed``; (HF model, port cfg, port params, JAX cfg, JAX params)."""
    hf_cfg = transformers.LlamaConfig(**(BIASED_LLAMA | kw))
    torch.manual_seed(seed)
    model = transformers.AutoModelForCausalLM.from_config(hf_cfg).eval().to(torch.float32)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(".bias"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
            elif t.dim() == 1:
                t.add_(torch.randn(t.shape, generator=gen) * 0.1)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    assert "model.layers.0.self_attn.o_proj.bias" in sd
    tcfg = dataclasses.replace(tm.from_hf_config(hf_cfg), dtype="float32")
    jcfg = dataclasses.replace(jm.from_hf_config(hf_cfg), dtype="float32")
    return (model, tcfg, tm.load_params_from_state_dict(tcfg, sd, device="cpu"), jcfg,
            jm.load_params_from_state_dict(jcfg, sd))


def test_o_bias_forward_matches_jax_and_transformers():
    """The o projection's bias is added (it was dropped, off by 0.66 in the
    logits); ``forward`` within 1e-5 * max|logit| of JAX, within
    rtol = atol = 2e-3 of ``transformers``; stacked layers bitwise equal to
    unstacked ones."""
    model, tcfg, tp, jcfg, jp = _biased_llama()
    toks = _tokens(tcfg, (2, 16))
    with torch.no_grad():
        ref = model(torch.from_numpy(toks).long()).logits.numpy()
    t = tm.forward(tp, tcfg, torch.from_numpy(toks))
    j = np.asarray(jm.forward(jp, jcfg, jnp.asarray(toks)))
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5 * np.abs(j).max())
    np.testing.assert_allclose(t.numpy(), ref, rtol=2e-3, atol=2e-3)
    stacked = tm.stack_model(tm.fuse_model(tp, tcfg))
    assert stacked["layers_stacked"]["attn"]["o"]["bias"].shape == (2, 64)
    assert torch.equal(tm.forward(stacked, tcfg, torch.from_numpy(toks)), t)


def test_o_bias_greedy_decode_matches_jax():
    """prefill + 8 greedy steps over a bf16 cache, float32 weights: tokens
    bitwise equal to the JAX engine's (its top-2 gap above 1e-3 at every
    step)."""
    from llm_compressor_tpu.engine import decode_greedy_steps as j_greedy
    from llm_compressor_tpu.engine import init_cache as j_init
    from llm_compressor_tpu.engine import prefill as j_prefill

    _, tcfg, tp, jcfg, jp = _biased_llama(3)
    toks = _tokens(tcfg, (2, 8), 3)
    jl, jc = j_prefill(jp, jnp.asarray(toks), j_init(2, 2, 16, 2, 16), cfg=jcfg)
    gaps = np.diff(np.sort(np.asarray(jl), -1)[:, -2:], axis=-1)
    assert gaps.min() > 1e-3
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    jout, _ = j_greedy(jp, jtok, jc, n=8, cfg=jcfg)
    tl, tc = te.prefill(tp, torch.from_numpy(toks), te.init_cache(2, 2, 16, 2, 16, device="cpu"),
                        cfg=tcfg)
    ttok = torch.argmax(tl, -1).to(torch.int32)[:, None]
    tout, _ = te.decode_greedy_steps(tp, ttok, tc, n=8, cfg=tcfg)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("mode", ["append", "two_part", "hybrid"])
def test_o_bias_w4a8_decode_matches_jax(mode):
    """The same Llama at hidden 256, head_dim 64, vocab 512 (weights
    N(0, 0.1)), RTN W4A8 (int8
    acts on the attention matmuls too) by the JAX package, fused and
    stacked: prefill into an int8 cache and 6 greedy steps in each decode
    mode (B4; B8 + B7; B8 + B6), tokens equal to the JAX engine's (its
    top-2 gap above 1e-3 at every step). The biases of N(0, 0.5) flip act
    codes in layer 0 of both slots, so the cache codes, which
    ``test_torch_archs_engine`` holds up to a slot's first flip, are held
    by the tokens alone here."""
    from test_torch_archs_engine import T, _qcfgs, _run_jax, _run_port

    _, tcfg, _, jcfg, jp = _biased_llama(5, hidden_size=256, intermediate_size=512,
                                         vocab_size=512, initializer_range=0.1)
    jq, tq = _qcfgs()
    jalg.rtn(jp, jcfg, jq, verbose=False)
    jalg.pack_model(jp, jcfg, jq)
    tp = tm.stack_model(tm.fuse_model(params_from_numpy(jax_to_numpy(jp), "cpu"), tcfg, tq))
    jp = jm.stack_model(jm.fuse_model(jp, jcfg, jq))
    toks = np.random.default_rng(3).integers(0, 512, (2, T)).astype(np.int32)
    j, t = _run_jax(jp, jcfg, jq, toks, mode), _run_port(tp, tcfg, tq, toks, mode)
    for lg in j["gaps"]:
        assert np.diff(np.sort(lg, -1)[:, -2:], axis=-1).min() > 1e-3
    np.testing.assert_array_equal(t["tok0"], j["tok0"])
    np.testing.assert_array_equal(t["toks"], j["toks"])
    np.testing.assert_array_equal(t["cache"]["lengths"], j["cache"]["lengths"])
