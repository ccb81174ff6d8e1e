"""The port's calibration capture, Hessians and GPTQ against the JAX
package's, on the same numpy inputs.

Config: the JAX ``tiny_config("llama")`` (float32, hidden 64, head_dim 16,
2 layers), W4A8 quantizers with ``int4-g[32]`` weights (a group size that
divides every width) and int8 per-token activations, 4 x 32 calibration
tokens from ``synthetic_tokens``.

Tolerances:
* layer inputs and Hessians: 1e-5 of the largest entry for the float
  forward (the forwards and the x x^T sums take float32 sums in other
  orders); with the W4A8 activation quantizers, 1e-3 after the first
  quantizer of a layer (one-step flips of int8 activation codes).
* GPTQ on identical W and H: scales and zeros bitwise (solved with the
  jitted rounding, as the jitted JAX core solves them); at least 99.9 % of
  the codes equal and the rest one step apart; the layer error
  ||(W - Q) X|| within 1e-4 of JAX's. The Cholesky factors and the
  error-feedback products may differ in the last float32 bits, which can
  move a value across a rounding boundary (one code step) that then feeds
  back into the later columns. Measured: every code equal, errors within
  1.2e-7.
* the whole GPTQ over the tiny model, packed with the scale book, held
  teacher-forced (``torch_port_util.check_gptq_chain``): each layer's
  recorded input against JAX's ``advance`` of the layer before through
  the port's GPTQ weights, within 1e-3 of the largest entry (layer 0's
  against JAX's capture within 1e-5); each Hessian pass against JAX's
  ``accumulate_hessian`` on the port's input, with the earlier groups set
  to the port's GPTQ weights, at ``test_capture_and_hessians_w4a8``'s
  bounds; each linear's codes as above, and its scale-book entry bitwise,
  against the JAX core's on the same weight and the port's Hessian.
  Measured: inputs and Hessians within 2.8e-7 of the largest entry.
  Against the JAX package's whole GPTQ: the packed scales (they depend on
  W only: act order moves whole groups) and the tied embedding bitwise,
  and layer 0's codes as above. The two packages' Hessians differ in the
  last float32 bits (sum order, the SiLU), and from layer 1 on a code
  that flips there moves the next layer's int8 activation codes, so the
  later layers' codes of the two whole runs are not compared.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import models as jm
from llm_compressor_tpu.algorithms import obs as jobs
from llm_compressor_tpu.capture import pipeline as jpipe
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu.qformats import parse_qspec as jparse
from llm_compressor_tpu.utils.dataset import synthetic_tokens as j_synth
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.algorithms import obs as tobs
from llm_compressor_tpu_torch.capture import pipeline as tpipe
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from llm_compressor_tpu_torch.qformats import parse_qspec as tparse
from llm_compressor_tpu_torch.qformats import quantize_dequant
from llm_compressor_tpu_torch.utils import synthetic_tokens as t_synth
from llm_compressor_tpu_torch.qformats.qtensor import unpack_int_codes
from torch_port_util import (  # noqa: F401
    check_codes,
    check_gptq_chain,
    codes_of,
    jax_to_numpy,
    one_torch_thread,
    recording_gptq_chain,
)

QARGS = ("int4-g[32]-rw", "int8-g[-1]-rw", None, "int8-g[32]-rw")
SLOTS = ("q", "k", "v", "o", "gate", "up", "down")


def _models(seed=0):
    jcfg, tcfg = jm.tiny_config("llama"), tm.tiny_config("llama")
    p = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, p, params_from_numpy(jax_to_numpy(p), "cpu")


def _close(got, want, frac):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=frac * np.abs(want).max())


def test_synthetic_tokens_equal():
    for args in ((4, 32, 256, 1), (3, 17, 1000, 5)):
        np.testing.assert_array_equal(t_synth(*args), j_synth(*args))
    np.testing.assert_array_equal(t_synth(1, 1, 64, 2, eval_len=300),
                                  j_synth(1, 1, 64, 2, eval_len=300))


@pytest.mark.parametrize("chunk", [2, 8])
def test_capture_and_hessians(chunk):
    """The unquantized calibration forward, chained through both layers:
    inputs, Hessians and the advanced outputs within 1e-5 of the largest
    entry."""
    jcfg, tcfg, jp, tp = _models()
    toks = j_synth(4, 32, jcfg.vocab_size, 1)
    jctx = jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks), chunk=chunk)
    tctx = tpipe.capture_layer0(tp, tcfg, toks, chunk=chunk)
    np.testing.assert_array_equal(tctx.hidden.numpy(), np.asarray(jctx.hidden))
    for i in range(jcfg.num_layers):
        jH, _ = jpipe.accumulate_hessian(jctx, jp["layers"][i], i, jpipe.TAP_KEYS)
        tH = tpipe.accumulate_hessian(tctx, tp["layers"][i], i, tpipe.TAP_KEYS)
        assert set(tH) == set(jH) == set(tpipe.TAP_KEYS)
        for k in jH:
            _close(tH[k].numpy(), jH[k], 1e-5)
        jpipe.advance(jctx, jp["layers"][i], i)
        tpipe.advance(tctx, tp["layers"][i], i)
        _close(tctx.hidden.numpy(), jctx.hidden, 1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_capture_and_hessians_w4a8(seed):
    """The calibration forward with the W4A8 activation quantizers, each
    layer fed the JAX package's inputs. The int8 per-token activation
    codes are a step function of float32 values that the two packages sum
    in other orders, so a code sitting on a rounding boundary can round
    either way, which moves whole rows of the later Hessians (measured: at
    most 2e-4 of the largest entry, in 2 of 4 layer cases). Hence: the
    Hessian of ``attn_in``, which no activation quantizer of the layer
    precedes, within 1e-5 of its largest entry, the others within 1e-3."""
    jcfg, tcfg, jp, tp = _models(seed)
    jq, tq = jbuild(*QARGS), tbuild(*QARGS)
    toks = j_synth(4, 32, jcfg.vocab_size, 1 + seed)
    jctx = jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks), chunk=2)
    tctx = tpipe.capture_layer0(tp, tcfg, toks, chunk=2)
    for i in range(jcfg.num_layers):
        jops, tops = jm.layer_ops(jcfg, jq, i), tm.layer_ops(tcfg, tq, i)
        tctx.hidden = torch.from_numpy(np.array(jctx.hidden))
        jH, _ = jpipe.accumulate_hessian(jctx, jp["layers"][i], i, jpipe.TAP_KEYS, jops)
        tH = tpipe.accumulate_hessian(tctx, tp["layers"][i], i, tpipe.TAP_KEYS, tops)
        for k in jH:
            want = np.asarray(jH[k])
            err = np.abs(tH[k].numpy() - want) / np.abs(want).max()
            assert err.max() <= (1e-5 if k == "attn_in" else 1e-3), (i, k, err.max())
        jpipe.advance(jctx, jp["layers"][i], i, jops)


def _wh(N, C, T, seed, dead=()):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(N, C)).astype(np.float32)
    X = rng.normal(size=(C, T)).astype(np.float32) * rng.uniform(0.2, 3.0, (C, 1)).astype(np.float32)
    X[list(dead)] = 0.0
    H = (2.0 / T * (X @ X.T)).astype(np.float32)
    return W, H, X


@pytest.mark.parametrize("spec,actorder", [
    ("int4-g[32]-rw", True), ("int4-g[32]-rw", False), ("int4-g[32]-zp-rw", True),
    ("int4-g[-1]-rw", True), ("int8-g[-1]-rw", True), ("int4-g[32]-rw", "dead")])
def test_gptq_update_with_params(spec, actorder):
    N, C = 48, 128
    W, H, X = _wh(N, C, 512, seed=len(spec), dead=(5, 70) if actorder == "dead" else ())
    actorder = bool(actorder)
    jQ, js, jz = jobs.gptq_update_with_params(jnp.asarray(W), jnp.asarray(H), jparse(spec),
                                              blocksize=64, actorder=actorder)
    tQ, ts, tz = tobs.gptq_update_with_params(torch.from_numpy(W), torch.from_numpy(H),
                                              tparse(spec), blocksize=64, actorder=actorder)
    jQ, js, jz = map(np.asarray, (jQ, js, jz))
    assert ts.shape == js.shape and tz.shape == jz.shape
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tz.numpy(), jz)
    g = C if js.shape[1] == 1 else C // js.shape[1]
    check_codes(codes_of(tQ.numpy(), ts.numpy(), tz.numpy(), g), codes_of(jQ, js, jz, g))
    err = lambda Q: np.linalg.norm((W - Q) @ X)
    assert abs(err(tQ.numpy()) - err(jQ)) <= 1e-4 * err(jQ)
    # GPTQ beats round-to-nearest on its own objective
    rtn = quantize_dequant(tparse(spec), torch.from_numpy(W) * torch.from_numpy(H).diagonal().ne(0))
    assert err(tQ.numpy()) < err(rtn.numpy())
    np.testing.assert_array_equal(tobs.gptq_update(torch.from_numpy(W), torch.from_numpy(H),
                                                   tparse(spec), blocksize=64,
                                                   actorder=actorder).numpy(), tQ.numpy())


def test_hessian_inverse_factor_and_damping_retry():
    rng = np.random.default_rng(3)
    Qm, _ = np.linalg.qr(rng.normal(size=(16, 16)))
    for lam_min in (0.5, -0.02):  # PD; then indefinite: 1 % damping fails, 10 % holds
        lam = np.array([1.0] * 15 + [lam_min])
        H = (Qm * lam) @ Qm.T
        H = ((H + H.T) / 2).astype(np.float32)
        U = tobs.hessian_inverse_factor(torch.from_numpy(H)).numpy()
        jU = np.asarray(jobs.hessian_inverse_factor_traced(jnp.asarray(H)))
        assert np.isfinite(jU).all()
        np.testing.assert_allclose(U, jU, rtol=0, atol=1e-5 * np.abs(jU).max())
        assert np.allclose(U, np.triu(U))
    with pytest.raises(ValueError, match="positive definite"):
        tobs.hessian_inverse_factor(-torch.eye(4))


@pytest.fixture(scope="module")
def whole_gptq():
    jcfg, tcfg, jp, tp = _models(seed=1)
    jq, tq = jbuild(*QARGS), tbuild(*QARGS)
    toks = j_synth(4, 32, jcfg.vocab_size, 2)
    jsb, tsb = {}, {}
    jctx = jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks))
    jhidden0 = np.asarray(jctx.hidden)
    jalg.gptq(jp, jcfg, jctx, jq, scale_book=jsb, verbose=False)
    jalg.pack_model(jp, jcfg, jq, scale_book=jsb)
    tctx = tpipe.capture_layer0(tp, tcfg, toks)
    timer = talg.PhaseTimer()
    with recording_gptq_chain() as calls:
        talg.gptq(tp, tcfg, tctx, tq, scale_book=tsb, timings=timer)
    gptq_w = {(i, s): talg.common.get_weight(lp, s)
              for i, lp in enumerate(tp["layers"]) for s in SLOTS}
    talg.pack_model(tp, tcfg, tq, scale_book=tsb)
    return dict(jcfg=jcfg, jq=jq, jp=jp, tp=tp, jsb=jsb, tsb=tsb, gptq_w=gptq_w, timer=timer,
                calls=calls, jhidden0=jhidden0)


def test_whole_gptq_codes(whole_gptq):
    r = whole_gptq
    assert set(r["tsb"]) == set(r["jsb"]) == {(i, s) for i in range(2) for s in SLOTS}
    check_gptq_chain(r["calls"], r["jcfg"], r["jq"], r["gptq_w"], r["tsb"], r["jhidden0"])
    for i in range(2):
        for s in SLOTS:
            jw = talg.common.get_weight(r["jp"]["layers"][i], s)
            tw = talg.common.get_weight(r["tp"]["layers"][i], s)
            np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))
            if i == 0:  # the two whole runs share layer 0's input: codes as on one W and H
                tc = unpack_int_codes(tw).numpy().astype(np.int32)
                jc = unpack_int_codes(params_from_numpy(jax_to_numpy(jw), "cpu")).numpy()
                check_codes(tc.reshape(-1), jc.astype(np.int32).reshape(-1))
    # the tied embedding is the RTN-quantized head, rounded as under jax.jit
    jh = params_from_numpy(jax_to_numpy(r["jp"]["embed"]), "cpu")["weight"]
    np.testing.assert_array_equal(r["tp"]["embed"]["weight"].numpy(), jh.numpy())


def test_whole_gptq_packs_losslessly(whole_gptq):
    from llm_compressor_tpu_torch.qformats import dequantize

    for (i, s), w in whole_gptq["gptq_w"].items():
        assert torch.equal(dequantize(talg.common.get_weight(whole_gptq["tp"]["layers"][i], s)), w)


def test_whole_gptq_timings(whole_gptq):
    sec = whole_gptq["timer"].seconds
    assert set(sec) == {"hessians", "updates"} and all(v > 0 for v in sec.values())


def test_mse_raises():
    """``mse=True`` used to raise; it now runs the MSE clip search, as the
    JAX package does: the slot's quantizer carries the flag, the whole GPTQ
    holds teacher-forced against JAX's functions with the MSE quantizers
    (``check_gptq_chain(mse=True)``), layer 0's scales equal JAX's whole
    run's bitwise, and the tied head is RTN'd with the search (jitted)
    bitwise as in JAX."""
    jcfg, tcfg, jp, tp = _models(seed=3)
    jq, tq = jbuild(*QARGS), tbuild(*QARGS)
    assert talg.common.weight_quantizer_for(tcfg, tq, 0, "q", mse=True).mse
    assert not talg.common.weight_quantizer_for(tcfg, tq, 0, "q").mse
    toks = j_synth(4, 32, jcfg.vocab_size, 4)
    jsb, tsb = {}, {}
    jctx = jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks))
    jhidden0 = np.asarray(jctx.hidden)
    jalg.gptq(jp, jcfg, jctx, jq, mse=True, scale_book=jsb, verbose=False)
    with recording_gptq_chain() as calls:
        talg.gptq(tp, tcfg, tpipe.capture_layer0(tp, tcfg, toks), tq, mse=True, scale_book=tsb)
    gptq_w = {(i, s): talg.common.get_weight(lp, s)
              for i, lp in enumerate(tp["layers"]) for s in SLOTS}
    check_gptq_chain(calls, jcfg, jq, gptq_w, tsb, jhidden0, mse=True)
    for s in SLOTS:
        np.testing.assert_array_equal(tsb[(0, s)][0].numpy(), np.asarray(jsb[(0, s)][0]))
    jh = params_from_numpy(jax_to_numpy(jp["embed"]), "cpu")["weight"]
    np.testing.assert_array_equal(tp["embed"]["weight"].numpy(), jh.numpy())


def test_full_f32_matmul_turns_tf32_off_and_restores():
    from llm_compressor_tpu_torch.device import full_f32_matmul

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with full_f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
