"""The transformer core of OPT, OPT-350m, BLOOM and Phi against the JAX
package and ``transformers``: ``forward``, the HF configs, the compressed
checkpoint in both directions (BLOOM's fused q|k|v, Phi's untied head with
its bias), ``fuse_model`` / ``stack_model``, RTN and packing, GPTQ through
the capture pipeline, and BLOOM's ALiBi slopes.

Configs: each architecture's ``tiny_config`` (hidden 64, 4 heads, head_dim
16, 2 layers, vocab 256, float32); ``opt350m`` is OPT's with
``project_in_dim`` 32 and ``do_layer_norm_before=False``, as
``tests/test_hf_parity.py`` builds it for ``transformers``. The norms'
weights and every bias are drawn from a seed (``init_params`` gives ones
and zeros), in the ``transformers`` models too.

Tolerances:
* ``forward`` against the JAX package, float32: atol 1e-5 * max|logit|
  (the same math in another summation order).
* against ``transformers``: ``test_hf_parity``'s rtol = atol = 2e-3.
* configs, checkpoints, fused and stacked weights, RTN codes, ALiBi
  slopes: equal.
* stacked against unstacked layers in the port: bitwise.
* GPTQ: ``torch_port_util.check_gptq_chain``'s bounds (int4-g64 weights,
  no activation quantizers, 16 x 64 calibration tokens, as
  ``test_torch_archs_engine`` runs it), except that a code may be two steps
  from JAX's instead of one: the Hessian of fc2, over the relu or gelu of
  a biased fc1 (512 columns), lets one float32 ulp of the error feedback
  move a code two steps (BLOOM: 2 of 131072 codes in layer 0; at most
  0.09 % of any linear's codes differ at all, under the 0.1 % bound).
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
from llm_compressor_tpu.capture import capture_layer0 as j_capture_layer0
from llm_compressor_tpu.models.layers import alibi_slopes as j_alibi_slopes
from llm_compressor_tpu.models.params import load_compressed as j_load_compressed
from llm_compressor_tpu.models.params import save_compressed as j_save_compressed
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.capture import capture_layer0 as t_capture_layer0
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.models.layers import alibi_slopes as t_alibi_slopes
from llm_compressor_tpu_torch.qformats import QTensor
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from test_torch_archs import _float_leaves
from test_torch_checkpoint import _assert_same_files, _assert_same_qtensor
from torch_port_util import (  # noqa: F401
    check_gptq_chain,
    jax_to_numpy,
    one_torch_thread,
    randomize,
    recording_gptq_chain,
)

# name -> (arch, tiny_config overrides)
VARIANTS = {"opt": ("opt", {}),
            "opt350m": ("opt", dict(project_in_dim=32, do_layer_norm_before=False)),
            "bloom": ("bloom", {}), "phi": ("phi", {})}
NAMES = list(VARIANTS)
W4A8 = ("int4-g[64]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw")


def cfgs(name, **kw):
    arch, over = VARIANTS[name]
    over = over | kw
    if name == "opt350m" and "hidden_size" in kw:
        over["project_in_dim"] = kw["hidden_size"] // 2
    return jm.tiny_config(arch, **over), tm.tiny_config(arch, **over)


def pair(name, seed=0, **kw):
    """(jcfg, tcfg, JAX params, port params): the same float32 weights,
    norms and biases drawn from ``seed``."""
    jcfg, tcfg = cfgs(name, **kw)
    tree = randomize(jax_to_numpy(jm.init_params(jcfg, jax.random.PRNGKey(seed))), seed + 1)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _tokens(cfg, shape=(2, 12), seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    jcfg, tcfg, p, tp = pair(name)
    toks = _tokens(jcfg)
    j = np.asarray(jm.forward(p, jcfg, jnp.asarray(toks)))
    t = tm.forward(tp, tcfg, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max())


# ---------------------------------------------------------------------------
# transformers
# ---------------------------------------------------------------------------


def hf_tiny(name):
    """``tests/test_hf_parity.py``'s configs."""
    t = transformers
    if name in ("opt", "opt350m"):
        extra = (dict(do_layer_norm_before=False, word_embed_proj_dim=32)
                 if name == "opt350m" else dict(do_layer_norm_before=True))
        return t.OPTConfig(vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                           num_attention_heads=4, max_position_embeddings=64,
                           attn_implementation="eager", **extra)
    if name == "bloom":
        return t.BloomConfig(vocab_size=256, hidden_size=64, n_layer=2, n_head=4,
                             attn_implementation="eager")
    return t.PhiConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=64,
                       num_key_value_heads=4, partial_rotary_factor=0.5,
                       attn_implementation="eager")


def hf_model(name, seed=0):
    """The ``transformers`` model of ``hf_tiny(name)``, float32, its biases
    drawn N(0, 0.02) and its norms' weights N(1, 0.1) from ``seed``."""
    torch.manual_seed(seed)
    model = transformers.AutoModelForCausalLM.from_config(hf_tiny(name)).eval().to(torch.float32)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for key, t in model.state_dict().items():
            if key.endswith(".bias"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.02)
            elif t.dim() == 1:
                t.add_(torch.randn(t.shape, generator=gen) * 0.1)
    return model


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_transformers(name):
    model = hf_model(name)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 16))
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.numpy()
    cfg = dataclasses.replace(tm.from_hf_config(model.config), dtype="float32")
    params = tm.load_params_from_state_dict(cfg, model.state_dict(), device="cpu")
    if name == "phi":
        assert "bias" in params["lm_head"]
    ours = tm.forward(params, cfg, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-3)


def _same_fields(j, t):
    assert {f.name for f in dataclasses.fields(j)} == {f.name for f in dataclasses.fields(t)}
    for f in dataclasses.fields(t):
        assert getattr(j, f.name) == getattr(t, f.name), f.name


# what ``from_hf_config`` fixes per architecture, set so that the tiny
# config reads back: OPT's LayerNorm eps, BLOOM's positions
HF_FIXED = {"opt": dict(rms_norm_eps=1e-5), "opt350m": dict(rms_norm_eps=1e-5),
            "bloom": dict(max_position_embeddings=2048), "phi": {}}


@pytest.mark.parametrize("name", NAMES)
def test_hf_config_round_trip(name):
    """``to_hf_config`` -> ``from_hf_config`` gives the config back, and
    the JAX package reads the same dict field for field; a
    ``transformers`` config reads as the JAX package reads it, and its
    ``to_dict()`` too."""
    _, cfg = cfgs(name, dtype="bfloat16", **HF_FIXED[name])
    hf = tm.to_hf_config(cfg)
    assert tm.from_hf_config(hf) == cfg
    _same_fields(jm.from_hf_config(hf), cfg)
    hf_obj = hf_tiny(name)
    _same_fields(jm.from_hf_config(hf_obj), tm.from_hf_config(hf_obj))
    _same_fields(jm.from_hf_config(hf_obj.to_dict()), tm.from_hf_config(hf_obj.to_dict()))
    assert tm.from_hf_config(hf_obj.to_dict()) == tm.from_hf_config(hf_obj)
    assert hf["architectures"][0] == type(
        transformers.AutoModelForCausalLM.from_config(hf_obj)).__name__


# ---------------------------------------------------------------------------
# the compressed checkpoint, both directions
# ---------------------------------------------------------------------------


def _packed_pair(name, seed):
    """RTN W4A8 in each package from the same weights (hidden 128)."""
    jcfg, tcfg, jp, tp = pair(name, seed, hidden_size=128, intermediate_size=256, head_dim=32)
    jq, tq = jbuild(*W4A8), tbuild(*W4A8)
    jalg.rtn(jp, jcfg, jq, verbose=False)
    jalg.pack_model(jp, jcfg, jq)
    talg.rtn(tp, tcfg, tq)
    talg.pack_model(tp, tcfg, tq)
    return jcfg, tcfg, jq, tq, jp, tp


@pytest.mark.parametrize("name", NAMES)
def test_checkpoint_round_trip(tmp_path, name):
    """Each package's files the same bytes; the port reads the JAX
    package's and the JAX package the port's, every QTensor (BLOOM's fused
    q|k|v as one), bias and norm bitwise; Phi's untied head comes back
    dequantized with its bias."""
    jcfg, tcfg, jq, tq, jp, tp = _packed_pair(name, 2)
    hf = tm.to_hf_config(tcfg)
    j_save_compressed(jp, jcfg, tmp_path / "jax", hf_config=hf)
    tm.save_compressed(tp, tcfg, tmp_path / "port", hf_config=hf)
    _assert_same_files(tmp_path / "jax", tmp_path / "port")
    t_loaded = tm.load_compressed(tmp_path / "jax", tcfg, tq, device="cpu")
    j_loaded = params_from_numpy(jax_to_numpy(j_load_compressed(tmp_path / "port", jcfg, jq)),
                                 "cpu")
    slots = [talg.common.SLOT_PATH[s] for s in tm.transformer.arch_slots(tcfg)]
    for i in range(jcfg.num_layers):
        for grp, slot in slots:
            want = jp["layers"][i][grp][slot]["weight"]
            _assert_same_qtensor(want, t_loaded["layers"][i][grp][slot]["weight"], (i, slot))
            _assert_same_qtensor(want, j_loaded["layers"][i][grp][slot]["weight"], (i, slot))
    want = dict(_float_leaves(params_from_numpy(jax_to_numpy(jp), "cpu")))
    if tcfg.tie_word_embeddings:
        want.pop(".lm_head.weight", None)         # the tied packed head is not written
    else:
        want[".lm_head.weight"] = t_loaded["lm_head"]["weight"]
    for loaded in (t_loaded, j_loaded):
        got = dict(_float_leaves(loaded))
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    assert torch.equal(t_loaded["lm_head"]["weight"], j_loaded["lm_head"]["weight"]) \
        if name == "phi" else "lm_head" not in t_loaded
    expect = {"opt": {"pos_embed"}, "opt350m": {"pos_embed", "project_in", "project_out"},
              "bloom": {"embed_ln"}, "phi": {"lm_head"}}[name]
    assert expect <= set(t_loaded)
    if name == "bloom":
        assert set(t_loaded["layers"][0]["attn"]) == {"qkv", "o"}
    if name == "phi":
        assert "bias" in t_loaded["lm_head"]


# ---------------------------------------------------------------------------
# serving transforms, RTN, GPTQ
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_fuse_and_stack_match_jax(name):
    """Packed W4A8 by the JAX package, handed over: ``fuse_model`` (q|k|v
    with its biases for OPT and Phi; nothing for BLOOM's fused projection
    and the fc1/fc2 MLPs) and ``stack_model`` give the JAX package's
    weights, biases and norms bitwise; the stacked forward equals the
    unstacked one bitwise, and the fused one the unfused one to 1e-5 of
    its largest logit."""
    jcfg, tcfg, jq, tq, jp, _ = _packed_pair(name, 3)
    tp = params_from_numpy(jax_to_numpy(jp), "cpu")
    toks = torch.from_numpy(_tokens(tcfg, (2, 5)))
    before = tm.forward(tp, tcfg, toks, tq)
    want = params_from_numpy(jax_to_numpy(jm.stack_model(jm.fuse_model(jp, jcfg, jq))),
                             "cpu")["layers_stacked"]
    fused = tm.fuse_model(tp, tcfg, tq)
    after = tm.forward(fused, tcfg, toks, tq)
    got = tm.stack_model(fused)
    assert set(got["layers_stacked"]["attn"]) == set(want["attn"])
    assert set(got["layers_stacked"]["mlp"]) == set(want["mlp"]) == {"fc1", "fc2"}
    assert ("qkv" if name == "bloom" else "qkv_cat") in want["attn"]

    def walk(a, b, path=()):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif isinstance(a, QTensor):
            assert torch.equal(a.codes, b.codes) and torch.equal(a.scales, b.scales), path
        else:
            assert torch.equal(a, b), path

    walk(want, got["layers_stacked"])
    torch.testing.assert_close(after, before, rtol=0, atol=1e-5 * float(before.abs().max()))
    assert torch.equal(tm.forward(got, tcfg, toks, tq), after)


@pytest.mark.parametrize("name", NAMES)
def test_rtn_and_pack_match_jax(name):
    """RTN and packing of every linear (BLOOM's qkv, fc1, fc2) and the
    head: codes and scales bitwise, biases untouched."""
    jcfg, tcfg, jq, tq, jp, tp = _packed_pair(name, 21)
    want = params_from_numpy(jax_to_numpy(jp), "cpu")
    slots = tm.transformer.arch_slots(tcfg)
    for jl, tl in zip(want["layers"], tp["layers"]):
        for slot in slots:
            a = talg.common.get_weight(jl, slot)
            b = talg.common.get_weight(tl, slot)
            assert isinstance(b, QTensor), slot
            assert torch.equal(a.codes, b.codes) and torch.equal(a.scales, b.scales), slot
            assert torch.equal(talg.common.get_bias(jl, slot), talg.common.get_bias(tl, slot))
    a, b = want["lm_head"]["weight"], tp["lm_head"]["weight"]
    torch.testing.assert_close(b.scales, a.scales, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_gptq_chain_matches_jax(name):
    """The port's GPTQ over the capture pipeline (learned positions, ALiBi,
    the parallel residual and post-norm before the taps; BLOOM's groups
    qkv, o, fc1, fc2) held to the JAX package's functions layer by layer,
    teacher-forced, at hidden 256, intermediate 512, vocab 512."""
    jcfg, tcfg, p, tp = pair(name, 31, hidden_size=256, intermediate_size=512, head_dim=64,
                             vocab_size=512)
    jq, tq = jbuild("int4-g[64]-rw", None, None, None), tbuild("int4-g[64]-rw", None, None, None)
    toks = np.random.default_rng(8).integers(0, 512, (16, 64)).astype(np.int32)
    hidden0 = np.asarray(j_capture_layer0(p, jcfg, jnp.asarray(toks)).hidden)
    ctx = t_capture_layer0(tp, tcfg, toks)
    book = {}
    with recording_gptq_chain() as calls:
        talg.gptq(tp, tcfg, ctx, tq, scale_book=book)
    gptq_w = {(i, s): talg.common.get_weight(tp["layers"][i], s)
              for i in range(tcfg.num_layers) for s in tm.transformer.arch_slots(tcfg)}
    worst = check_gptq_chain(calls, jcfg, jq, gptq_w, book, hidden0, code_steps=2)
    assert worst["hidden"] <= 1e-3


@pytest.mark.parametrize("name", NAMES)
def test_spinquant_refuses(name):
    """SpinQuant stays Llama-only, as in the JAX package."""
    _, tcfg = cfgs(name)
    with pytest.raises(NotImplementedError, match="llama family"):
        talg.spinquant(tm.init_params(tcfg, device="cpu"), tcfg, np.zeros((2, 8), np.int32),
                       tbuild(*W4A8))


# ---------------------------------------------------------------------------
# ALiBi
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads", [16, 12])
def test_alibi_slopes_match_jax(heads):
    """BLOOM's slopes for a power-of-two head count and for 12 (the
    odd-head interleave): equal to the JAX package's."""
    want = np.asarray(j_alibi_slopes(heads))
    got = t_alibi_slopes(heads, "cpu")
    assert got.dtype == torch.float32 and got.shape == (heads,)
    np.testing.assert_array_equal(got.numpy(), want)
