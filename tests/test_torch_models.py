"""The port's Llama forward, RTN, packing and serving transforms against
the JAX package on tiny float32 configs, params handed over with
``convert.py``.

Tolerances:
* logits: atol 1e-4 * max|logit| where no int8 activation code flips —
  dense float32 math agrees to rounding order, and the packed path sums
  the W4A8 groups in another order (see test_torch_w4a8.py). With longer
  prompts the ulp-level differences (e.g. the RMS norm's reduction order)
  move some int8 activation codes across a .5 rounding boundary; the
  fake-quantized K/V and probabilities then spread that step over the
  slot. There the check is a relative L2 error <= 2e-2 and the same top-1
  token at >= 99 % of positions.
* RTN + packing of the decoder weights: bitwise (same eager f32 math).
  The lm_head's fake quantization runs under jit in JAX, so its packed
  copy is compared to f32 ulps (scales) and one code step on at most
  0.1 % of entries.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import models as jm
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from llm_compressor_tpu_torch.qformats.qtensor import QTensor
from torch_port_util import jax_to_numpy, one_torch_thread  # noqa: F401

W4A8 = ("int4-g[128]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw")
SMALL = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
             head_dim=64, vocab_size=512)


def _cfgs(**kw):
    jcfg = jm.tiny_config("llama", **kw)
    tcfg = tm.tiny_config("llama", **kw)
    return jcfg, tcfg


def _tokens(cfg, shape=(2, 7), seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _assert_logits(jl, tl):
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-4 * np.abs(jl).max())


def _assert_logits_flips(jl, tl):
    jl, tl = np.asarray(jl), tl.numpy()
    assert np.linalg.norm(tl - jl) <= 2e-2 * np.linalg.norm(jl)
    assert (tl.argmax(-1) == jl.argmax(-1)).mean() >= 0.99


@pytest.mark.parametrize("quant", [None, ("int4-g[-2]-rw", "int8-g[-1]-rw", None, None)])
def test_dense_forward(quant):
    jcfg, tcfg = _cfgs(rope_scaling=jm.RopeScaling(kind="llama3", factor=8.0,
                                                   original_max_position=64))
    p = jm.init_params(jcfg, jax.random.PRNGKey(0))
    jq = jbuild(*quant) if quant else None
    tq = tbuild(*quant) if quant else None
    if quant:
        jalg.rtn(p, jcfg, jq, verbose=False)
    tp = params_from_numpy(jax_to_numpy(p), "cpu")
    toks = _tokens(jcfg)
    _assert_logits(jm.forward(p, jcfg, jnp.asarray(toks), jq),
                   tm.forward(tp, tcfg, torch.from_numpy(toks), tq))


def _packed_pair(serving: bool):
    jcfg, tcfg = _cfgs(**SMALL)
    p = jm.init_params(jcfg, jax.random.PRNGKey(1))
    jq, tq = jbuild(*W4A8, head_act="int8-g[-1]-rw"), tbuild(*W4A8, head_act="int8-g[-1]-rw")
    jalg.rtn(p, jcfg, jq, verbose=False)
    jalg.pack_model(p, jcfg, jq)
    tp = params_from_numpy(jax_to_numpy(p), "cpu")
    if serving:
        p = jm.stack_model(jm.fuse_model(p, jcfg, jq))
        tp = tm.stack_model(tm.fuse_model(tp, tcfg, tq))
    return jcfg, tcfg, jq, tq, p, tp


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("T", [5, 130])
def test_packed_forward(serving, T):
    """T=130 with B=2 puts 260 rows through the projections: qkv/o/gateup
    take the flat integer kernel, down the dequantize + matmul path."""
    jcfg, tcfg, jq, tq, p, tp = _packed_pair(serving)
    toks = _tokens(jcfg, (2, T))
    check = _assert_logits if T < 10 else _assert_logits_flips
    # under jit, as serving runs the W4A8 act quantizer
    check(jax.jit(jm.forward, static_argnums=(1, 3))(p, jcfg, jnp.asarray(toks), jq),
          tm.forward(tp, tcfg, torch.from_numpy(toks), tq))


def test_rtn_and_pack_match_jax():
    jcfg, tcfg = _cfgs(**SMALL)
    p = jm.init_params(jcfg, jax.random.PRNGKey(2))
    tp = params_from_numpy(jax_to_numpy(p), "cpu")
    jq, tq = jbuild(*W4A8), tbuild(*W4A8)
    jalg.rtn(p, jcfg, jq, verbose=False)
    jalg.pack_model(p, jcfg, jq)
    talg.rtn(tp, tcfg, tq)
    talg.pack_model(tp, tcfg, tq)
    want = params_from_numpy(jax_to_numpy(p), "cpu")
    for jl, tl in zip(want["layers"], tp["layers"]):
        for grp in ("attn", "mlp"):
            for slot, node in jl[grp].items():
                a, b = node["weight"], tl[grp][slot]["weight"]
                assert isinstance(b, QTensor) and b.pair_planes == a.pair_planes
                assert torch.equal(a.codes, b.codes) and torch.equal(a.scales, b.scales)
    a, b = want["lm_head"]["weight"], tp["lm_head"]["weight"]
    torch.testing.assert_close(b.scales, a.scales, rtol=1e-6, atol=0)
    diff = (a.codes.int() - b.codes.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3


def test_fuse_and_stack_match_jax():
    jcfg, tcfg, jq, tq, p, tp = _packed_pair(serving=True)
    want = params_from_numpy(jax_to_numpy(p), "cpu")["layers_stacked"]
    got = tp["layers_stacked"]
    for grp, slot in (("attn", "qkv_cat"), ("attn", "o"), ("mlp", "gateup"), ("mlp", "down")):
        a, b = want[grp][slot]["weight"], got[grp][slot]["weight"]
        assert torch.equal(a.codes, b.codes) and torch.equal(a.scales, b.scales)
        assert a.shape == b.shape
    assert torch.equal(want["ln1"]["weight"], got["ln1"]["weight"])


@pytest.mark.parametrize("arch", ["opt", "bloom", "phi"])
def test_tiny_config_matches_jax(arch):
    """The architectures the port once refused: ``tiny_config`` field for
    field as the JAX package builds it."""
    j, t = jm.tiny_config(arch), tm.tiny_config(arch)
    assert {f.name for f in dataclasses.fields(j)} == {f.name for f in dataclasses.fields(t)}
    for f in dataclasses.fields(t):
        assert getattr(j, f.name) == getattr(t, f.name), f.name


# Weight-only configs: no activation quantizers, so every small-M packed
# projection runs B5 (its plain version here; the Pallas kernel in interpret
# mode in JAX) and long prompts take dequantize + matmul. B5 rounds its f32
# input to bf16, so an f32 rounding-order difference upstream can move an
# input element across a bf16 boundary: logits are held to one bf16 ulp of
# the largest logit, 2**-7 * max|logit|.
WEIGHT_ONLY = [("int4-g[128]-zp-rw", None, None, "int8-g[128]-rw"),
               ("int8-g[128]-rw", None, None, None),
               ("fp8_e4m3-g[128]-rw", None, None, "int8-g[128]-rw"),
               ("fp8_e5m2-g[128]-zp-rw", None, None, None)]


def _weight_only_pair(quant, serving: bool):
    jcfg, tcfg = _cfgs(**SMALL)
    p = jm.init_params(jcfg, jax.random.PRNGKey(4))
    jq, tq = jbuild(*quant), tbuild(*quant)
    jalg.rtn(p, jcfg, jq, verbose=False)
    jalg.pack_model(p, jcfg, jq)
    tp = params_from_numpy(jax_to_numpy(p), "cpu")
    if serving:
        p = jm.stack_model(jm.fuse_model(p, jcfg, jq))
        tp = tm.stack_model(tm.fuse_model(tp, tcfg, tq))
    return jcfg, tcfg, jq, tq, p, tp


@pytest.mark.parametrize("quant", WEIGHT_ONLY, ids=lambda q: q[0])
@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("T", [5, 130])
def test_weight_only_forward(quant, serving, T):
    jcfg, tcfg, jq, tq, p, tp = _weight_only_pair(quant, serving)
    if serving:  # fused and stacked with the zero points / fp8 codes
        for grp, slot in (("attn", "qkv_cat"), ("mlp", "gateup")):
            a = params_from_numpy(jax_to_numpy(p), "cpu")["layers_stacked"][grp][slot]["weight"]
            b = tp["layers_stacked"][grp][slot]["weight"]
            assert torch.equal(a.codes.view(torch.uint8), b.codes.view(torch.uint8))
            assert (a.zeros is None) == (b.zeros is None)
            if a.zeros is not None:
                assert torch.equal(a.zeros, b.zeros)
    toks = _tokens(jcfg, (2, T), seed=5)
    jl = np.asarray(jm.forward(p, jcfg, jnp.asarray(toks), jq))
    tl = tm.forward(tp, tcfg, torch.from_numpy(toks), tq).numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2.0 ** -7 * np.abs(jl).max())


@pytest.mark.parametrize("quant", WEIGHT_ONLY, ids=lambda q: q[0])
def test_rtn_and_pack_weight_only_match_jax(quant):
    """RTN + packing with zero points and fp8 codes: the decoder weights'
    codes, scales and zeros bitwise; the head as in the W4A8 test."""
    jcfg, tcfg = _cfgs(**SMALL)
    p = jm.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax_to_numpy(p), "cpu")
    jq, tq = jbuild(*quant), tbuild(*quant)
    jalg.rtn(p, jcfg, jq, verbose=False)
    jalg.pack_model(p, jcfg, jq)
    talg.rtn(tp, tcfg, tq)
    talg.pack_model(tp, tcfg, tq)
    want = params_from_numpy(jax_to_numpy(p), "cpu")
    for jl, tl in zip(want["layers"], tp["layers"]):
        for grp in ("attn", "mlp"):
            for slot, node in jl[grp].items():
                a, b = node["weight"], tl[grp][slot]["weight"]
                assert isinstance(b, QTensor) and b.pair_planes == a.pair_planes
                assert a.codes.dtype == b.codes.dtype
                assert torch.equal(a.codes.view(torch.uint8), b.codes.view(torch.uint8))
                assert torch.equal(a.scales, b.scales)
                assert (a.zeros is None) == (b.zeros is None)
                if a.zeros is not None:
                    assert torch.equal(a.zeros, b.zeros)
    if quant[3] is not None:
        a, b = want["lm_head"]["weight"], tp["lm_head"]["weight"]
        torch.testing.assert_close(b.scales, a.scales, rtol=1e-6, atol=0)
        diff = (a.codes.int() - b.codes.int()).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
