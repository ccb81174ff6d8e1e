"""The port's SpinQuant optimize mode (Cayley SGD on the Stiefel manifold
through the straight-through quantized forward) against the JAX package's,
on the same numpy inputs and the same starting rotations.

Configs: the JAX ``tiny_config("llama")`` (float32, hidden 64, head_dim 16;
2 layers, norms drawn from a seed by ``torch_port_util.variant_pair``;
1 layer where JAX's own test uses one), with two quantizer configs:
weight-only ``int4-g[32]-rw`` (JAX's test config) and W4A8 (int4-g32
weights, int8 per-token activations, an int8-g32 head with int8
activations). Starting rotations: JAX's ``optimize_rotations`` draws them
from ``jax.random.PRNGKey(seed)``, the port from its CPU generator through
B10, so the tests hand JAX's matrices to the port (``hadamard_rotations``
monkeypatched).

Tolerances:
* ``_cayley_step`` and ``_sgdg_stiefel_step`` (momentum 0 and 0.9, three
  chained steps, one matrix and a stack of four against ``jax.vmap``),
  against JAX under ``jax.jit``: 1e-6 absolute on R (entries of an
  orthonormal matrix) and 1e-6 of the largest entry on the momentum
  buffer, which grows past 1 (float32 matmuls sum in other orders;
  measured: one ulp).
* ``_qr_retract``: one float32 ulp (both take LAPACK's float64 QR).
* ``_ste_qdq``'s forward: bitwise against the jitted JAX function; its
  gradient is the identity.
* ``make_rotated_ste_loss`` at JAX's starting rotations, against
  ``jax.value_and_grad`` under ``jit``: the loss within 2e-6 relative,
  the gradients with respect to R1 and the R2s within 1e-5 of their
  largest entry. Measured on the norms of seeds 2-12: the loss within
  2.6e-7, the gradients within 1.3e-6, in both configs, except W4A8 on
  two seeds. On seed 4 the gradients are 3.3e-3 apart: an int8
  activation code flips between the two float32 forwards. On seed 7 they
  are 52 % apart: the Hadamard start puts two entries of one token's
  absmax in an exact tie in JAX's forward, where ``jnp.max`` splits the
  gradient (as ``torch.amax`` does at a tie the port sees); 1e-7 of
  noise on R1 moves JAX's own gradient by 24 %, and away from the tie
  the port is within 6e-7 again (``test_gradient_jumps_at_an_absmax_tie``).
* ``optimize_rotations``, 8 steps, batch 4, a QR every 4 steps: R1 and
  the R2s within 5e-5 of JAX's (measured on the norms of seeds 0-3:
  4.5e-8 to 1.7e-5, the steps carry the differences above along), the
  first step's loss within 1e-5 relative of JAX's loss at the same
  rotations, and JAX's own gates (``tests/test_spinquant.py::TestCayley``):
  the loss at the learned rotations at most the starting one's + 1e-4,
  R1 R1^T within 1e-3 of I.
* ``spinquant(mode="optimize")``: ``R.npz`` as the JAX package's
  ``load_rotations`` reads it, equal to the returned rotations; the GPTQ
  chain after it teacher-forced (``torch_port_util.check_gptq_chain``)
  against the JAX package's functions on the JAX model rotated by those
  rotations.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu.capture import pipeline as jpipe
from llm_compressor_tpu.kernels import hadamard as jh
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu.utils.dataset import synthetic_tokens
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.algorithms.common import get_weight
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from torch_port_util import (  # noqa: F401
    check_gptq_chain,
    one_torch_thread,
    recording_gptq_chain,
    variant_pair,
)

jsq = importlib.import_module("llm_compressor_tpu.algorithms.spinquant")
tsq = importlib.import_module("llm_compressor_tpu_torch.algorithms.spinquant")
SLOTS = ("q", "k", "v", "o", "gate", "up", "down")
CONFIGS = {"w4": (("int4-g[32]-rw", None, None, None), None),
           "w4a8": (("int4-g[32]-rw", "int8-g[-1]-rw", None, "int8-g[32]-rw"), "int8-g[-1]-rw")}


def _qcfgs(name):
    args, head_act = CONFIGS[name]
    return jbuild(*args, head_act=head_act), tbuild(*args, head_act=head_act)


def _jax_start(cfg, seed=0):
    """JAX's starting rotations of ``optimize_rotations(seed=...)``: R1
    (n, n) and the R2s (L, d, d), float32 numpy."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    R1 = np.array(jh.random_hadamard_matrix(cfg.hidden_size, k1), np.float32)
    R2s = np.stack([np.array(jh.random_hadamard_matrix(cfg.head_dim, k), np.float32)
                    for k in jax.random.split(k2, cfg.num_layers)])
    return R1, R2s


def _hand_over(mp, cfg, seed=0):
    """The port's ``hadamard_rotations`` returns JAX's starting matrices."""
    R1, R2s = _jax_start(cfg, seed)
    mp.setattr(tsq, "hadamard_rotations", lambda c, s, device: (
        torch.from_numpy(R1).double(), [torch.from_numpy(r).double() for r in R2s]))
    return R1, R2s


def _untied(seed=0, **kw):
    jcfg, tcfg, jp, tp = variant_pair("llama", seed, **kw)
    return jsq._untie(jp, jcfg), tsq._untie(tp, tcfg), jp, tp


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(got, want, tol=1e-6):
    """Within ``tol`` of the largest entry, at least ``tol`` absolute (the
    momentum buffer grows past 1)."""
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def test_cayley_step_matches_jax():
    R = np.array(jh.random_hadamard_matrix(32, jax.random.PRNGKey(0)), np.float32)
    G = _rand((32, 32), 1, 0.1)
    want = np.asarray(jax.jit(jsq._cayley_step, static_argnums=2)(
        jnp.asarray(R), jnp.asarray(G), 0.5))
    got = tsq._cayley_step(torch.from_numpy(R), torch.from_numpy(G), 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got @ got.T, np.eye(32), atol=1e-4)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgdg_step_chained_matches_jax(momentum):
    step = jax.jit(lambda R, G, V, lr: jsq._sgdg_stiefel_step(R, G, V, lr, momentum))
    R = np.array(jh.random_hadamard_matrix(32, jax.random.PRNGKey(0)), np.float32)
    jR, jV = jnp.asarray(R), jnp.zeros((32, 32), jnp.float32)
    tR, tV = torch.from_numpy(R), torch.zeros(32, 32)
    lr = np.float32(1.5)
    for i in range(3):
        G = _rand((32, 32), 10 + i)
        jR, jV = step(jR, jnp.asarray(G), jV, jnp.float32(lr))
        tR, tV = tsq._sgdg_stiefel_step(tR, torch.from_numpy(G), tV, torch.tensor(lr), momentum)
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), rtol=0, atol=1e-6)
        _close(tV.numpy(), np.asarray(jV))
        np.testing.assert_allclose(tR.numpy() @ tR.numpy().T, np.eye(32), atol=2e-3)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgdg_step_stacked_matches_vmap(momentum):
    """A stack of R2s steps as JAX's ``vmap`` steps them: each matrix with
    its own step size."""
    step = jax.jit(jax.vmap(lambda R, G, V, lr: jsq._sgdg_stiefel_step(R, G, V, lr, momentum),
                            in_axes=(0, 0, 0, None)))
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    R = np.stack([np.array(jh.random_hadamard_matrix(16, k), np.float32) for k in keys])
    scales = np.array([0.01, 0.3, 1.0, 5.0], np.float32)[:, None, None]   # alpha capped or not
    jR, jV = jnp.asarray(R), jnp.zeros_like(jnp.asarray(R))
    tR, tV = torch.from_numpy(R), torch.zeros(R.shape)
    for i in range(2):
        G = _rand(R.shape, 20 + i) * scales
        jR, jV = step(jR, jnp.asarray(G), jV, jnp.float32(1.2))
        tR, tV = tsq._sgdg_stiefel_step(tR, torch.from_numpy(G), tV, torch.tensor(1.2), momentum)
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), rtol=0, atol=1e-6)
        _close(tV.numpy(), np.asarray(jV))


@pytest.mark.parametrize("stacked", [False, True])
def test_qr_retract_within_one_ulp(stacked):
    R = np.array(jh.random_hadamard_matrix(32, jax.random.PRNGKey(5)), np.float32)
    R = np.stack([R + _rand(R.shape, 6 + i, 1e-3) for i in range(3)]) if stacked else \
        R + _rand(R.shape, 6, 1e-3)
    got = tsq._qr_retract(torch.from_numpy(R)).numpy()
    want = np.stack([jsq._qr_retract(r) for r in R]) if stacked else jsq._qr_retract(R)
    assert got.dtype == np.float32 and got.shape == R.shape
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("spec", ["int4-g[32]-rw", "int8-g[-1]-rw"])
def test_ste_qdq_forward_bitwise_gradient_identity(spec):
    jq, tq = jbuild(spec, None, None, None).linear.weight, tbuild(spec, None, None, None).linear.weight
    x = _rand((48, 64), 7, 0.05)
    want = np.asarray(jax.jit(lambda v: jsq._ste_qdq(jq, v))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = tsq._ste_qdq(tq, xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    w = torch.from_numpy(_rand((48, 64), 8))
    (g,) = torch.autograd.grad((got * w).sum(), xt)
    assert torch.equal(g, w)


def _loss_pair(jp, tp, jcfg, tcfg, jq, tq):
    jloss = jax.jit(jax.value_and_grad(jsq.make_rotated_ste_loss(jp, jcfg, jq), argnums=(0, 1)))
    tloss = tsq.make_rotated_ste_loss(tp, tcfg, tq)
    return jloss, tloss


def _loss_and_grads(jloss, tloss, R1, R2s, toks):
    jl, (jg1, jg2) = jloss(jnp.asarray(R1), jnp.asarray(R2s), jnp.asarray(toks))
    r1 = torch.from_numpy(R1).requires_grad_()
    r2 = torch.from_numpy(R2s).requires_grad_()
    tl = tloss(r1, r2, torch.from_numpy(toks))
    tg1, tg2 = torch.autograd.grad(tl, (r1, r2))
    return (float(jl), np.asarray(jg1), np.asarray(jg2)), (float(tl.detach()), tg1.numpy(),
                                                          tg2.numpy())


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_gradients_match_jax(name):
    jcfg, tcfg, jp, tp = _untied(seed=2)
    jq, tq = _qcfgs(name)
    R1, R2s = _jax_start(jcfg, seed=0)
    toks = synthetic_tokens(4, 16, jcfg.vocab_size, 1)
    (jl, jg1, jg2), (tl, tg1, tg2) = _loss_and_grads(*_loss_pair(jp, tp, jcfg, tcfg, jq, tq),
                                                     R1, R2s, toks)
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=2e-6)
    assert _rel(tg1, jg1) <= 1e-5 and _rel(tg2, jg2) <= 1e-5, (_rel(tg1, jg1), _rel(tg2, jg2))


def test_gradient_jumps_at_an_absmax_tie():
    """W4A8 on the norms of seed 7: the Hadamard start puts an activation
    absmax in an exact tie in JAX's forward, so the gradient is not
    continuous there: 1e-6 of noise on R1 moves JAX's own gradient by more
    than 10 % of its largest entry. At that nearby point, off the tie, the
    port's loss and gradients are JAX's within the bounds above."""
    jcfg, tcfg, jp, tp = _untied(seed=7)
    jq, tq = _qcfgs("w4a8")
    R1, R2s = _jax_start(jcfg, seed=0)
    toks = synthetic_tokens(4, 16, jcfg.vocab_size, 1)
    jloss, tloss = _loss_pair(jp, tp, jcfg, tcfg, jq, tq)
    (_, jg1, _), _ = _loss_and_grads(jloss, tloss, R1, R2s, toks)
    P = R1 + _rand(R1.shape, 0, 1e-6)
    (pl, pg1, pg2), (tl, tg1, tg2) = _loss_and_grads(jloss, tloss, P, R2s, toks)
    assert _rel(pg1, jg1) > 0.1
    np.testing.assert_allclose(tl, pl, rtol=2e-6)
    assert _rel(tg1, pg1) <= 1e-5 and _rel(tg2, pg2) <= 1e-5


@pytest.fixture(scope="module")
def optimized():
    """Both packages optimize 8 steps (batch 4, QR every 4) from JAX's
    starting rotations, 1 layer, weight-only int4-g32 (JAX's test)."""
    jcfg, tcfg, jp, tp = _untied(seed=0, num_layers=1)
    jq, tq = _qcfgs("w4")
    toks = synthetic_tokens(4, 16, jcfg.vocab_size, 1)
    jR1, jR2s = jsq.optimize_rotations(jp, jcfg, toks, jq, n_steps=8, batch=4, seed=0,
                                       qr_period=4)
    losses, timer = [], talg.PhaseTimer()
    with pytest.MonkeyPatch.context() as mp:
        R1h, R2h = _hand_over(mp, tcfg)
        tR1, tR2s = tsq.optimize_rotations(tp, tcfg, toks, tq, n_steps=8, batch=4, seed=0,
                                           qr_period=4, timings=timer, losses=losses)
    jloss = jax.jit(jsq.make_rotated_ste_loss(jp, jcfg, jq))
    return dict(jR1=jR1, jR2s=jR2s, tR1=tR1, tR2s=tR2s, losses=losses, timer=timer, R1h=R1h,
                R2h=R2h, jloss=jloss, tb=jnp.asarray(toks))


def test_optimize_rotations_track_jax(optimized):
    o = optimized
    assert o["tR1"].dtype == torch.float64 and len(o["tR2s"]) == 1
    np.testing.assert_allclose(o["tR1"].numpy(), o["jR1"], rtol=0, atol=5e-5)
    for t, j in zip(o["tR2s"], o["jR2s"]):
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=5e-5)
    assert len(o["losses"]) == 8 and all(np.isfinite(o["losses"]))
    first = float(o["jloss"](jnp.asarray(o["R1h"]), jnp.asarray(o["R2h"]), o["tb"]))
    np.testing.assert_allclose(o["losses"][0], first, rtol=1e-5)
    assert set(o["timer"].seconds) == {"draw", "optimize"}


def test_optimize_rotations_pass_jax_gates(optimized):
    """``tests/test_spinquant.py::test_optimized_reaches_hadamard_loss``'s
    gates on the port's rotations: the loss at the learned rotations at most
    the starting one's + 1e-4 on the calibration batch, R1 orthonormal
    within 1e-3."""
    o = optimized
    init = float(o["jloss"](jnp.asarray(o["R1h"]), jnp.asarray(o["R2h"]), o["tb"]))
    R1 = o["tR1"].numpy()
    opt = float(o["jloss"](jnp.asarray(R1, jnp.float32),
                           jnp.stack([jnp.asarray(r.numpy(), jnp.float32) for r in o["tR2s"]]),
                           o["tb"]))
    assert opt <= init + 1e-4, (opt, init)
    np.testing.assert_allclose(R1 @ R1.T, np.eye(R1.shape[0]), atol=1e-3)
    for r in o["tR2s"]:
        np.testing.assert_allclose(r.numpy() @ r.numpy().T, np.eye(r.shape[0]), atol=1e-3)


def test_spinquant_optimize_then_gptq(tmp_path):
    """``spinquant(mode="optimize")`` end to end: ``R.npz`` as JAX's
    ``load_rotations`` reads it, then the GPTQ chain over the model rotated
    by those rotations, teacher-forced against the JAX package's functions
    (capture and Hessians through the rotated weights, each linear's
    GPTQ), W4A8."""
    jcfg, tcfg, jp, tp = variant_pair("llama", seed=3)
    jq, tq = _qcfgs("w4a8")
    calib = synthetic_tokens(4, 32, jcfg.vocab_size, 2)
    book, losses, timer = {}, [], talg.PhaseTimer()
    with pytest.MonkeyPatch.context() as mp:
        _hand_over(mp, tcfg, seed=7)
        with recording_gptq_chain() as calls:
            tcfg2 = talg.spinquant(tp, tcfg, calib, tq, mode="optimize", n_steps=3, seed=7,
                                   rotation_path=str(tmp_path), scale_book=book,
                                   timings=timer, losses=losses)
    assert not tcfg2.tie_word_embeddings and len(losses) == 3 and np.isfinite(losses).all()
    assert set(timer.seconds) == {"draw", "optimize", "rotation", "hessians", "updates"}
    R1, R2s = jsq.load_rotations(tmp_path / "R.npz", jcfg)
    assert R1.dtype == np.float64 and len(R2s) == jcfg.num_layers
    np.testing.assert_allclose(R1 @ R1.T, np.eye(jcfg.hidden_size), atol=1e-5)
    jcfg2 = jsq._untie(jp, jcfg)
    jsq.fuse_layer_norms(jp, jcfg2)
    jsq._rotate_params(jp, jcfg2, R1, R2s)
    hidden0 = np.asarray(jpipe.capture_layer0(jp, jcfg2, jnp.asarray(calib)).hidden)
    gptq_w = {(i, s): get_weight(lp, s) for i, lp in enumerate(tp["layers"]) for s in SLOTS}
    check_gptq_chain(calls, jcfg2, jq, gptq_w, book, hidden0)


def test_optimize_refuses_other_families_before_a_step():
    """SpinQuant stays Llama-only in optimize mode too, and refuses before
    it draws a rotation or takes a step."""
    cfg = tm.tiny_config("opt")
    params = tm.init_params(cfg, device="cpu")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsq, "optimize_rotations", lambda *a, **k: calls.append(1))
        with pytest.raises(NotImplementedError, match="llama family"):
            talg.spinquant(params, cfg, synthetic_tokens(2, 8, cfg.vocab_size),
                           tbuild(*CONFIGS["w4"][0]), mode="optimize", n_steps=2)
    assert not calls and "lm_head" not in params
