"""The port's GPTAQ against the JAX package's, on the same numpy inputs.

* ``gptaq_update_with_params`` on one weight, against the jitted JAX core
  (``_gptq_core(use_p=True)``), with and without act order, per-group and
  per-channel, with dead columns: scales and zeros bitwise (solved with
  the jitted rounding), codes by ``torch_port_util.check_codes`` (at
  least 99.9 % equal, the rest one step apart: the Cholesky factors, the
  correction P and the error feedback differ in the last float32 bits),
  and the asymmetric layer error ||W X_fp - Q X|| within 1e-4 of JAX's.
  Without dXXT the core is GPTQ's, which ``tests/test_torch_gptq.py``
  holds unchanged.
* The whole GPTAQ, teacher-forced as GPTQ's chain is: its cross-Hessian
  pass recorded (both streams' inputs, the layer as it stands, the
  original layer, H and dXXT), then per layer and group against the JAX
  package's functions on those inputs: layer 0's two streams equal to
  each other and within 1e-5 of JAX's capture; layer i's quantized
  stream within 1e-3 of JAX's ``advance`` of layer i - 1's recorded
  inputs through the port's GPTAQ weights, its full-precision stream
  within 1e-3 of JAX's ``advance`` through the original layer i - 1 (the
  W4A8 activation quantizers run in both streams: one-step int8 flips);
  H and dXXT within 1e-5 of H's largest entry for ``attn_in`` and 1e-3
  for the other taps (``test_capture_and_hessians_w4a8``'s bounds; dXXT
  is a difference of the streams, so it is held against H's scale); each
  linear against JAX's core on the same weight, H and dXXT as above.
  A port whose two streams share storage (``advance`` writes in place)
  fails the inputs' check at layer 1.
"""

import contextlib
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu.algorithms import common as jcommon
from llm_compressor_tpu.algorithms import obs as jobs
from llm_compressor_tpu.capture import pipeline as jpipe
from llm_compressor_tpu.models import layer_ops as j_layer_ops
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu.qformats import parse_qspec as jparse
from llm_compressor_tpu.utils.dataset import synthetic_tokens
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.capture import pipeline as tpipe
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from llm_compressor_tpu_torch.qformats import parse_qspec as tparse
from torch_port_util import (  # noqa: F401
    check_codes,
    clone_tree,
    codes_of,
    one_torch_thread,
    to_jax,
    variant_pair,
)

jgptaq = importlib.import_module("llm_compressor_tpu.algorithms.gptaq")
tgptaq = importlib.import_module("llm_compressor_tpu_torch.algorithms.gptaq")
W4A8 = ("int4-g[32]-rw", "int8-g[-1]-rw", None, "int8-g[32]-rw")


def _whd(N, C, T, seed, dead=()):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(N, C)).astype(np.float32)
    X = (rng.normal(size=(C, T)) * rng.uniform(0.2, 3.0, (C, 1))).astype(np.float32)
    X[list(dead)] = 0.0
    Xf = (X + 0.1 * rng.normal(size=X.shape) * (X != 0)).astype(np.float32)
    H = (2.0 / T * (X @ X.T)).astype(np.float32)
    dXXT = (2.0 / T * ((Xf - X) @ X.T)).astype(np.float32)
    return W, H, dXXT, X, Xf


@pytest.mark.parametrize("spec,actorder,dead", [
    ("int4-g[32]-rw", True, ()), ("int4-g[32]-rw", False, ()), ("int4-g[32]-zp-rw", True, ()),
    ("int4-g[-1]-rw", True, ()), ("int4-g[-1]-rw", False, ()), ("int4-g[32]-rw", True, (5, 70))])
def test_gptaq_update_with_params(spec, actorder, dead):
    N, C = 48, 128
    W, H, dXXT, X, Xf = _whd(N, C, 512, seed=len(spec) + 3 * actorder, dead=dead)
    jQ, js, jz = map(np.asarray, jobs.gptaq_update_with_params(
        jnp.asarray(W), jnp.asarray(H), jnp.asarray(dXXT), jparse(spec), blocksize=64,
        actorder=actorder))
    tQ, ts, tz = talg.gptaq_update_with_params(torch.from_numpy(W), torch.from_numpy(H),
                                               torch.from_numpy(dXXT), tparse(spec),
                                               blocksize=64, actorder=actorder)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tz.numpy(), jz)
    g = C if js.shape[1] == 1 else C // js.shape[1]
    check_codes(codes_of(tQ.numpy(), ts.numpy(), tz.numpy(), g), codes_of(jQ, js, jz, g))
    err = lambda Q: np.linalg.norm(W @ Xf - Q @ X)
    assert abs(err(tQ.numpy()) - err(jQ)) <= 1e-4 * err(jQ)
    assert (tQ.numpy()[:, list(dead)] == 0).all()
    np.testing.assert_array_equal(
        talg.gptaq_update(torch.from_numpy(W), torch.from_numpy(H), torch.from_numpy(dXXT),
                          tparse(spec), blocksize=64, actorder=actorder).numpy(), tQ.numpy())


def test_gptaq_correction_moves_the_codes():
    """With dXXT = 0 GPTAQ is GPTQ bitwise; with the cross term it is not."""
    W, H, dXXT, _, _ = _whd(32, 64, 256, seed=9)
    args = (torch.from_numpy(W), torch.from_numpy(H))
    q = tparse("int4-g[32]-rw")
    gptq = talg.gptq_update(*args, q)
    assert torch.equal(talg.gptaq_update(*args, torch.zeros(64, 64), q), gptq)
    assert not torch.equal(talg.gptaq_update(*args, torch.from_numpy(dXXT), q), gptq)




@contextlib.contextmanager
def recording_cross_hessians():
    real = tgptaq.cross_hessians
    calls = []

    def rec(ctx, fp_ctx, lp, orig_lp, i, ops, tap):
        H, d = real(ctx, fp_ctx, lp, orig_lp, i, ops, tap)
        calls.append(dict(layer=i, tap=tap, hidden=ctx.hidden.clone(), fp=fp_ctx.hidden.clone(),
                          positions=ctx.positions.clone(), chunk=ctx.chunk, params=clone_tree(lp),
                          orig=clone_tree(orig_lp), H=H.clone(), dXXT=d.clone()))
        return H, d

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgptaq, "cross_hessians", rec)
        yield calls


def _rel(got, want, scale):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(scale).max())


@pytest.mark.parametrize("name", ["llama", "phi"])
def test_whole_gptaq_chain(name):
    jcfg, tcfg, jp, tp = variant_pair(name, 21)
    jq, tq = jbuild(*W4A8), tbuild(*W4A8)
    toks = synthetic_tokens(4, 32, jcfg.vocab_size, 22)
    hidden0 = np.asarray(jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks), chunk=2).hidden)
    book = {}
    with recording_cross_hessians() as calls:
        talg.gptaq(tp, tcfg, tpipe.capture_layer0(tp, tcfg, toks, chunk=2), tq, scale_book=book)
    groups = jcommon.sequential_groups(jcfg)
    final = {(i, s): talg.common.get_weight(tp["layers"][i], s)
             for i in range(jcfg.num_layers) for g in groups for s in g}

    def ctx_of(c, hidden):
        return jpipe.CalibContext(cfg=jcfg, hidden=jnp.asarray(hidden.numpy()),
                                  positions=jnp.asarray(c["positions"].numpy()), chunk=c["chunk"])

    def with_gptaq(lp, i, slots):
        for s in slots:
            jcommon.set_weight(lp, s, jnp.asarray(final[(i, s)].numpy()))
        return lp

    assert [(c["layer"], c["tap"]) for c in calls] == [
        (i, jpipe.SLOT_TAP[g[0]]) for i in range(jcfg.num_layers) for g in groups]
    for i in range(jcfg.num_layers):
        mine = [c for c in calls if c["layer"] == i]
        c0 = mine[0]
        ops = j_layer_ops(jcfg, jq, i)
        if i == 0:
            assert torch.equal(c0["hidden"], c0["fp"])
            assert _rel(c0["hidden"].numpy(), hidden0, hidden0) <= 1e-5
        else:
            prev = [c for c in calls if c["layer"] == i - 1][0]
            q = ctx_of(prev, prev["hidden"])
            every = [s for g in groups for s in g]
            jpipe.advance(q, with_gptaq(to_jax(prev["params"]), i - 1, every), i - 1,
                          j_layer_ops(jcfg, jq, i - 1))
            assert _rel(c0["hidden"].numpy(), q.hidden, q.hidden) <= 1e-3, i
            f = ctx_of(prev, prev["fp"])
            jpipe.advance(f, to_jax(prev["orig"]), i - 1, j_layer_ops(jcfg, jq, i - 1))
            assert _rel(c0["fp"].numpy(), f.hidden, f.hidden) <= 1e-3, i
        done = []
        for c, group in zip(mine, groups):
            assert torch.equal(c["hidden"], c0["hidden"]) and torch.equal(c["fp"], c0["fp"])
            tap = c["tap"]
            lp = with_gptaq(to_jax(c0["params"]), i, done)
            H = dXXT = None
            for (_, _, _, tq_), (_, _, _, tf_) in zip(
                    jpipe.run_layer(ctx_of(c0, c0["hidden"]), lp, i, ops, (tap,)),
                    jpipe.run_layer(ctx_of(c0, c0["fp"]), to_jax(c0["orig"]), i, ops, (tap,))):
                d, h = jgptaq._cross_chunk(tq_[tap], tf_[tap])
                H = h if H is None else H + h
                dXXT = d if dXXT is None else dXXT + d
            H, dXXT = np.asarray(2.0 * H / 4), np.asarray(2.0 * dXXT / 4)
            tol = 1e-5 if tap == "attn_in" else 1e-3
            assert _rel(c["H"].numpy(), H, H) <= tol, (i, tap)
            assert _rel(c["dXXT"].numpy(), dXXT, H) <= tol, (i, tap)
            for s in group:
                W = jcommon.get_weight(c0["params"], s)
                jQ, js, jz = map(np.asarray, jobs.gptaq_update_with_params(
                    jnp.asarray(W.numpy()), jnp.asarray(c["H"].numpy()),
                    jnp.asarray(c["dXXT"].numpy()), jcommon.weight_quantizer_for(jcfg, jq, i, s)))
                ts, tz = (v.numpy() for v in book[(i, s)])
                np.testing.assert_array_equal(ts, js)
                np.testing.assert_array_equal(tz, jz)
                g = W.shape[1] // ts.shape[1]
                check_codes(codes_of(final[(i, s)].numpy(), ts, tz, g), codes_of(jQ, js, jz, g))
            done += group


def test_gptaq_end_to_end():
    """Mirror of tests/test_algorithms.py::test_gptaq_end_to_end."""
    cfg = tm.tiny_config("llama", num_layers=2)
    p = tm.init_params(cfg, seed=0, device="cpu")
    ctx = tpipe.capture_layer0(p, cfg, synthetic_tokens(4, 32, cfg.vocab_size, seed=1), chunk=2)
    W0 = talg.common.get_weight(p["layers"][0], "q").clone()
    qcfg = tbuild(*W4A8)
    talg.gptaq(p, cfg, ctx, qcfg)
    assert not torch.allclose(W0, talg.common.get_weight(p["layers"][0], "q"))
    toks = torch.from_numpy(synthetic_tokens(1, 64, cfg.vocab_size, seed=7))
    assert bool(torch.isfinite(tm.forward(p, cfg, toks, qcfg=qcfg)).all())
