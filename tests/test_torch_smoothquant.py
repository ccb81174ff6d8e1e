"""The port's SmoothQuant against the JAX package's, on the architectures
JAX smooths (OPT, BLOOM, Llama, Qwen2, Qwen3; OPT-350m has no scale pair,
so only RTN runs), with the same float32 weights, norms and biases, W4A8
quantizers and 4 x 32 calibration tokens.

Held teacher-forced, layer by layer (the absmax pass and the params
before RTN recorded):

* a layer's inputs within 1e-3 of JAX's ``advance`` of the layer before
  through its UNSMOOTHED weights (1e-5 for layer 0 against JAX's
  capture; the int8 activation quantizers run: one-step flips);
* the per-channel activation absmax within 1e-5 (``attn_in``) or 5e-3
  (after an activation quantizer) of JAX's, relative to its largest
  entry (a max, so only the taps' own differences show);
* the scales from the port's absmax: within 1e-6 of JAX's formula on the
  same absmax (relative; both powers within an ulp of the float64 one,
  ``common.fpow``); JAX's fold with the port's scales gives the port's
  smoothed layer (norm weight and bias, the linears) bitwise;
* RTN after: the port's weights equal its RTN of its smoothed weights
  (``tests/test_torch_qformats.py`` holds RTN against JAX).

The fold alone (no quantizer anywhere): the smoothed float model's logits
within 1e-5 of the original's largest logit (measured at most 4.8e-7,
Qwen3: W * s against x / s rounds each product a little differently).
"""

import contextlib
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu.algorithms import common as jcommon
from llm_compressor_tpu.capture import pipeline as jpipe
from llm_compressor_tpu.models import layer_ops as j_layer_ops
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu.utils.dataset import synthetic_tokens
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.capture import pipeline as tpipe
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from llm_compressor_tpu_torch.qformats import quantize_dequant
from llm_compressor_tpu_torch.qformats.quantize import quantize_dequant_with_params
from torch_port_util import (  # noqa: F401
    assert_same_tree,
    clone_tree,
    one_torch_thread,
    rel_err,
    to_jax,
    variant_pair,
)

jsq = importlib.import_module("llm_compressor_tpu.algorithms.smoothquant")
tsq = importlib.import_module("llm_compressor_tpu_torch.algorithms.smoothquant")
W4A8 = ("int4-g[32]-rw", "int8-g[-1]-rw", None, "int8-g[32]-rw")
SMOOTHED = ["opt", "bloom", "llama", "qwen2", "qwen3"]






@contextlib.contextmanager
def recording_smoothquant():
    calls = {"absmax": [], "before_rtn": None}
    real_abs, real_rtn = tsq._act_absmax, tsq.rtn

    def absmax(ctx, lp, i, ops, keys):
        out = real_abs(ctx, lp, i, ops, keys)
        calls["absmax"].append(dict(layer=i, hidden=ctx.hidden.clone(), params=clone_tree(lp),
                                    positions=ctx.positions.clone(), chunk=ctx.chunk,
                                    out={k: v.clone() for k, v in out.items()}))
        return out

    def rtn(params, *a, **kw):
        calls["before_rtn"] = clone_tree(params["layers"])
        return real_rtn(params, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsq, "_act_absmax", absmax)
        mp.setattr(tsq, "rtn", rtn)
        yield calls


@pytest.mark.parametrize("alpha", [0.5, 0.8])
@pytest.mark.parametrize("name", SMOOTHED + ["opt350m"])
def test_smoothquant_matches_jax(name, alpha):
    jcfg, tcfg, jp, tp = variant_pair(name, 3)
    jq, tq = jbuild(*W4A8), tbuild(*W4A8)
    toks = synthetic_tokens(4, 32, jcfg.vocab_size, 4)
    hidden0 = np.asarray(jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks), chunk=2).hidden)
    with recording_smoothquant() as calls:
        talg.smoothquant(tp, tcfg, tpipe.capture_layer0(tp, tcfg, toks, chunk=2), tq, alpha=alpha)
    pairs = jsq._scale_pairs(jcfg)
    assert tsq._scale_pairs(tcfg) == pairs
    assert (name == "opt350m") == (pairs == [])
    for c in calls["absmax"]:
        i = c["layer"]
        if i == 0:
            assert rel_err(c["hidden"].numpy(), hidden0) <= 1e-5
        else:
            prev = calls["absmax"][i - 1]
            ctx = jpipe.CalibContext(cfg=jcfg, hidden=jnp.asarray(prev["hidden"].numpy()),
                                     positions=jnp.asarray(prev["positions"].numpy()),
                                     chunk=prev["chunk"])
            jpipe.advance(ctx, to_jax(prev["params"]), i - 1, j_layer_ops(jcfg, jq, i - 1))
            assert rel_err(c["hidden"].numpy(), ctx.hidden) <= 1e-3, i
        ctx = jpipe.CalibContext(cfg=jcfg, hidden=jnp.asarray(c["hidden"].numpy()),
                                 positions=jnp.asarray(c["positions"].numpy()), chunk=c["chunk"])
        jlp = to_jax(c["params"])
        want = jsq._act_absmax(ctx, jlp, i, j_layer_ops(jcfg, jq, i),
                               tuple(dict.fromkeys(t for _, _, t in pairs)))
        assert set(want) == set(c["out"])
        for k in want:
            assert rel_err(c["out"][k].numpy(), want[k]) <= (1e-5 if k == "attn_in" else 5e-3)
        for norm_key, slots, tap in pairs:   # JAX's fold with the port's scales
            a = c["out"][tap]
            w_max = torch.stack([torch.amax(torch.abs(talg.common.get_weight(c["params"], s)),
                                            0) for s in slots]).amax(0)
            s = tsq.smooth_scales(a, w_max, alpha)
            js = jnp.clip(jnp.asarray(a.numpy()) ** alpha
                          / jnp.maximum(jnp.asarray(w_max.numpy()), 1e-5) ** (1.0 - alpha),
                          1e-5, None)
            assert rel_err(s.numpy(), js) <= 1e-6
            s = jnp.asarray(s.numpy())
            norm = jlp[norm_key]
            norm["weight"] = (norm["weight"] / s).astype(norm["weight"].dtype)
            if norm.get("bias") is not None:
                norm["bias"] = (norm["bias"] / s).astype(norm["bias"].dtype)
            for slot in slots:
                jcommon.set_weight(jlp, slot, jcommon.get_weight(jlp, slot) * s[None, :])
        assert_same_tree(calls["before_rtn"][i], jlp)
        for slot in tm.transformer.arch_slots(tcfg):
            W = talg.common.get_weight(calls["before_rtn"][i], slot)
            q = talg.common.weight_quantizer_for(tcfg, tq, i, slot)
            want = quantize_dequant_with_params(q, W)[0] * (W != 0)
            assert torch.equal(talg.common.get_weight(tp["layers"][i], slot), want), (i, slot)


@pytest.mark.parametrize("name", SMOOTHED + ["opt350m"])
def test_fold_keeps_the_float_model(name):
    jcfg, tcfg, jp, tp = variant_pair(name, 5)
    none = tbuild(None, None, None, None)
    toks = synthetic_tokens(4, 32, jcfg.vocab_size, 6)
    ref = tm.forward(tp, tcfg, torch.from_numpy(toks))
    before = clone_tree(tp)
    talg.smoothquant(tp, tcfg, tpipe.capture_layer0(tp, tcfg, toks, chunk=2), none, alpha=0.8)
    out = tm.forward(tp, tcfg, torch.from_numpy(toks))
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    if name == "opt350m":   # no pair: nothing changes
        assert_same_tree(tp, before)
    else:
        ln1 = lambda p: p["layers"][0]["ln1"]["weight"]
        assert not torch.equal(ln1(tp), ln1(before))


@pytest.mark.parametrize("name", ["phi", "gemma", "gemma2", "gemma3"])
def test_smoothquant_unsupported_arch(name):
    jcfg, tcfg, jp, tp = variant_pair(name, 0)
    toks = synthetic_tokens(2, 16, jcfg.vocab_size, 1)
    with pytest.raises(NotImplementedError):
        jsq.smoothquant(jp, jcfg, jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks)),
                        jbuild(*W4A8))
    with pytest.raises(NotImplementedError):
        talg.smoothquant(tp, tcfg, tpipe.capture_layer0(tp, tcfg, toks), tbuild(*W4A8))


# mirrors of tests/test_algorithms.py::TestScaleFolding::test_smoothquant and
# tests/test_algorithms_archs.py::test_smoothquant_per_arch, on the port

def test_smoothquant():
    cfg = tm.tiny_config("llama", num_layers=2)
    p = tm.init_params(cfg, seed=0, device="cpu")
    w_only = tbuild("int4-g[32]-rw", None, None, None)
    calib = torch.from_numpy(synthetic_tokens(1, 16, cfg.vocab_size, seed=1))
    ref = tm.forward(p, cfg, calib)
    ctx = tpipe.capture_layer0(p, cfg, synthetic_tokens(4, 32, cfg.vocab_size, seed=1), chunk=2)
    talg.smoothquant(p, cfg, ctx, w_only, alpha=0.5)
    W = talg.common.get_weight(p["layers"][0], "q")
    assert torch.allclose(quantize_dequant(w_only.linear.weight, W), W, atol=1e-6)
    out = tm.forward(p, cfg, calib, qcfg=w_only)
    assert float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref)) < 0.5


@pytest.mark.parametrize("arch", ["opt", "bloom", "qwen2"])
def test_smoothquant_per_arch(arch):
    cfg = tm.tiny_config(arch)
    p = tm.init_params(cfg, seed=0, device="cpu")
    qcfg = tbuild("int4-g[32]-rw", "int8-g[-1]-rw", None, None)
    ctx = tpipe.capture_layer0(p, cfg, synthetic_tokens(4, 32, cfg.vocab_size, seed=1), chunk=2)
    talg.smoothquant(p, cfg, ctx, qcfg, alpha=0.8)
    toks = torch.from_numpy(synthetic_tokens(1, 64, cfg.vocab_size, seed=7))
    assert bool(torch.isfinite(tm.forward(p, cfg, toks, qcfg=qcfg)).all())
