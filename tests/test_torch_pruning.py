"""The port's pruning (magnitude, Wanda, RIA, SparseGPT) and
``check_sparsity`` against the JAX package's, on every architecture's
``tiny_config`` (and OPT-350m's post-norm variant), with the same float32
weights, norms and biases and the same 4 x 32 calibration tokens; then
mirrors of ``tests/test_algorithms.py``'s pruning cases and of
``tests/test_algorithms_archs.py::test_wanda_per_arch``.

Held teacher-forced, layer by layer: the port's function runs with its
statistics pass recorded (the layer's inputs, its params as they stand,
the statistic), and each record is checked against the JAX package's
functions on those same inputs:

* a layer's inputs: layer 0's within 1e-5 of the largest entry of JAX's
  capture; layer i's within 1e-5 of JAX's ``advance`` of layer i - 1's
  recorded inputs through the port's pruned layer i - 1 (float forwards,
  no activation quantizer: the same math summed in another order);
* Wanda's and RIA's channel statistic and SparseGPT's Hessians within
  1e-5 of their largest entry, as ``test_torch_capture.py`` holds them;
* Wanda's masks bitwise, from JAX's ``_prune_row_topk`` on the port's
  statistic (the metric |W| * sqrt(s) rounds the same in both);
* RIA's masks bitwise, except where the row and column sums, summed in
  another order, move an entry across JAX's threshold: each such entry's
  JAX metric within 1e-6 of the threshold (relative), at most 2 a linear;
  the RIA power sqrt(s)^alpha is taken as ``common.fpow``;
* SparseGPT against JAX's ``sparsegpt_update`` on the same weight and the
  port's Hessian: masks bitwise, except an entry whose JAX score
  W^2 / diag(Hinv)^2 lies within 1e-5 of its block threshold (relative):
  the two Cholesky factors differ in the last float32 bits; the kept
  weights within 1e-4 of the largest |W| (the error feedback through
  those factors).

Measured: every RIA and SparseGPT mask bitwise (neither tie rule taken),
SparseGPT's weights within 3.7e-5 of the largest |W| (BLOOM).

Magnitude (no data) and ``check_sparsity`` are bitwise. Every rule prunes
the entries at or below the threshold, so ties prune more than k: a
``torch.topk`` port would fail ``test_tie_rules``.
"""

import contextlib
import importlib
import logging

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu.algorithms import common as jcommon
from llm_compressor_tpu.algorithms import obs as jobs
from llm_compressor_tpu.capture import pipeline as jpipe
from llm_compressor_tpu.evalx import check_sparsity as j_check_sparsity
from llm_compressor_tpu.models.transformer import arch_slots
from llm_compressor_tpu.utils.dataset import synthetic_tokens
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.algorithms import obs as tobs
from llm_compressor_tpu_torch.capture import pipeline as tpipe
from llm_compressor_tpu_torch.evalx import check_sparsity
from torch_port_util import (  # noqa: F401
    ALL_VARIANTS,
    clone_tree,
    one_torch_thread,
    to_jax,
    variant_pair,
)

NAMES = list(ALL_VARIANTS)
jwanda = importlib.import_module("llm_compressor_tpu.algorithms.wanda")
jria = importlib.import_module("llm_compressor_tpu.algorithms.ria")
twanda = importlib.import_module("llm_compressor_tpu_torch.algorithms.wanda")
tria = importlib.import_module("llm_compressor_tpu_torch.algorithms.ria")
tsparsegpt = importlib.import_module("llm_compressor_tpu_torch.algorithms.sparsegpt")




@contextlib.contextmanager
def recording(module, name):
    """Record every call of ``module.name`` (a statistics pass): layer,
    inputs, params, positions, chunk and the result."""
    real = getattr(module, name)
    calls = []

    def rec(ctx, lp, i, taps, ops=None):
        out = real(ctx, lp, i, taps, ops)
        calls.append(dict(layer=i, hidden=ctx.hidden.clone(), params=clone_tree(lp),
                          positions=ctx.positions.clone(), chunk=ctx.chunk,
                          out={k: v.clone() for k, v in out.items()}))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, name, rec)
        yield calls


def _close(got, want, frac=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=frac * np.abs(want).max())


def _check_chain(calls, jcfg, tp, hidden0, jstat):
    """Inputs and statistics of each recorded layer against the JAX
    package's; ``jstat(ctx, lp, i, taps)`` is JAX's statistics pass."""
    assert [c["layer"] for c in calls] == list(range(jcfg.num_layers))
    taps = tuple(dict.fromkeys(jcommon.slot_tap(s) for s in arch_slots(jcfg)))
    for c in calls:
        i = c["layer"]
        if i == 0:
            _close(c["hidden"].numpy(), hidden0)
        else:
            prev = calls[i - 1]
            ctx = jpipe.CalibContext(cfg=jcfg, hidden=jnp.asarray(prev["hidden"].numpy()),
                                     positions=jnp.asarray(prev["positions"].numpy()),
                                     chunk=prev["chunk"])
            jpipe.advance(ctx, to_jax(tp["layers"][i - 1]), i - 1)
            _close(c["hidden"].numpy(), ctx.hidden)
        ctx = jpipe.CalibContext(cfg=jcfg, hidden=jnp.asarray(c["hidden"].numpy()),
                                 positions=jnp.asarray(c["positions"].numpy()),
                                 chunk=c["chunk"])
        want = jstat(ctx, to_jax(c["params"]), i, taps)
        assert set(want) == set(c["out"])
        for k in want:
            _close(c["out"][k].numpy(), want[k])


def _setup(name, seed):
    jcfg, tcfg, jp, tp = variant_pair(name, seed)
    toks = synthetic_tokens(4, 32, jcfg.vocab_size, seed + 2)
    hidden0 = np.asarray(jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks), chunk=2).hidden)
    return jcfg, tcfg, jp, tp, tpipe.capture_layer0(tp, tcfg, toks, chunk=2), hidden0


def _pruned(tp, c, slot):
    return talg.common.get_weight(tp["layers"][c["layer"]], slot).numpy()


@pytest.mark.parametrize("name", NAMES)
def test_magnitude_matches_jax(name):
    jcfg, tcfg, jp, tp = variant_pair(name, 11)
    jalg.magnitude(jp, jcfg, 0.5)
    talg.magnitude(tp, tcfg, 0.5)
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for s in arch_slots(jcfg):
            np.testing.assert_array_equal(talg.common.get_weight(tl, s).numpy(),
                                          np.asarray(jcommon.get_weight(jl, s)))


@pytest.mark.parametrize("name", NAMES)
def test_wanda_matches_jax(name):
    jcfg, tcfg, jp, tp, ctx, hidden0 = _setup(name, 12)
    with recording(twanda, "accumulate_scaler_rows") as calls:
        talg.wanda(tp, tcfg, ctx, 0.5)
    _check_chain(calls, jcfg, tp, hidden0, jpipe.accumulate_scaler_rows)
    for c in calls:
        for s in arch_slots(jcfg):
            W = c["params"]
            W = talg.common.get_weight(W, s).numpy()
            want = jwanda._prune_row_topk(jnp.asarray(W),
                                          jnp.asarray(c["out"][jcommon.slot_tap(s)].numpy()), 0.5)
            np.testing.assert_array_equal(_pruned(tp, c, s), np.asarray(want))


@pytest.mark.parametrize("name", NAMES)
def test_ria_matches_jax(name):
    jcfg, tcfg, jp, tp, ctx, hidden0 = _setup(name, 13)
    with recording(tria, "accumulate_scaler_rows") as calls:
        talg.ria(tp, tcfg, ctx, 0.5, alpha=0.5)
    _check_chain(calls, jcfg, tp, hidden0, jpipe.accumulate_scaler_rows)
    for c in calls:
        for s in arch_slots(jcfg):
            W = talg.common.get_weight(c["params"], s).numpy()
            sc = c["out"][jcommon.slot_tap(s)].numpy()
            want = np.asarray(jria._prune_ria(jnp.asarray(W), jnp.asarray(sc), 0.5, 0.5))
            got = _pruned(tp, c, s)
            differ = (got == 0) != (want == 0)
            np.testing.assert_array_equal(got[~differ], want[~differ])
            if differ.any():   # the tie rule
                aw = np.abs(W).astype(np.float32)
                metric = np.asarray((jnp.asarray(aw) / jnp.sum(aw, 0)[None]
                                     + jnp.asarray(aw) / jnp.sum(aw, 1)[:, None])
                                    * jnp.sqrt(jnp.asarray(sc))[None] ** 0.5)
                thresh = np.sort(metric.ravel())[int(W.size * 0.5)]
                assert differ.sum() <= 2, (s, differ.sum())
                assert np.all(np.abs(metric[differ] - thresh) <= 1e-6 * thresh), s


def _jax_scores(W, H):
    """JAX's SparseGPT score W^2 / diag(Hinv)^2 of a single-block weight."""
    Wp, Hp, _ = jobs._prep(jnp.asarray(W), jnp.asarray(H))
    d = jnp.diag(jobs.hessian_inverse_factor_traced(Hp))
    return np.asarray(Wp ** 2 / d[None, :] ** 2)


def _check_sparsegpt(got, want, W, H, ratio=0.5, blocksize=128):
    differ = (got == 0) != (want == 0)
    if differ.any():   # the tie rule (single-block weights only)
        assert W.shape[1] <= blocksize
        score = _jax_scores(W, H)
        thresh = np.sort(score.ravel())[int(score.size * ratio)]
        assert np.all(np.abs(score[differ] - thresh) <= 1e-5 * thresh)
    keep = ~differ
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=1e-4 * np.abs(W).max())


@pytest.mark.parametrize("name", NAMES)
def test_sparsegpt_matches_jax(name):
    jcfg, tcfg, jp, tp, ctx, hidden0 = _setup(name, 14)
    with recording(tsparsegpt, "accumulate_hessian") as calls:
        talg.sparsegpt(tp, tcfg, ctx, 0.5)
    _check_chain(calls, jcfg, tp, hidden0, lambda *a: jpipe.accumulate_hessian(*a)[0])
    for c in calls:
        for s in arch_slots(jcfg):
            W = talg.common.get_weight(c["params"], s).numpy()
            H = c["out"][jcommon.slot_tap(s)].numpy()
            want = np.asarray(jobs.sparsegpt_update(jnp.asarray(W), jnp.asarray(H), 0.5))
            _check_sparsegpt(_pruned(tp, c, s), want, W, H)


@pytest.mark.parametrize("ratio,blocksize,dead", [(0.5, 128, ()), (0.3, 64, (3, 40)),
                                                  (0.5, 32, ())])
def test_sparsegpt_update_matches_jax(ratio, blocksize, dead):
    """One (48, 128) weight: one block, and two or four blocks whose masks
    see the error feedback of the blocks before; dead columns."""
    rng = np.random.default_rng(int(ratio * 10) + blocksize)
    W = rng.normal(size=(48, 128)).astype(np.float32)
    X = rng.normal(size=(128, 512)).astype(np.float32) * rng.uniform(0.2, 3, (128, 1))
    X[list(dead)] = 0
    H = (2.0 / 512 * (X @ X.T)).astype(np.float32)
    want = np.asarray(jobs.sparsegpt_update(jnp.asarray(W), jnp.asarray(H), ratio,
                                            blocksize=blocksize))
    got = talg.sparsegpt_update(torch.from_numpy(W), torch.from_numpy(H), ratio,
                                blocksize=blocksize).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(W).max())
    for b in range(0, 128, blocksize):   # every block prunes at least k of its entries
        assert (got[:, b:b + blocksize] == 0).sum() >= int(48 * blocksize * ratio)
    assert (got[:, list(dead)] == 0).all()


def test_tie_rules():
    """Equal metrics at the threshold all go: more than k entries."""
    W = torch.tensor([[1.0, -1.0, 1.0, 2.0], [3.0, 1.0, 1.0, -1.0]])
    p = {"layers": [{"attn": {s: {"weight": W.clone()} for s in "qkvo"},
                     "mlp": {s: {"weight": W.clone()} for s in ("gate", "up", "down")}}]}
    cfg = tm.tiny_config("llama")
    talg.magnitude(p, cfg, 0.25)            # k = 2: sort(|W|)[2] = 1, six entries <= 1
    assert int((talg.common.get_weight(p["layers"][0], "q") == 0).sum()) == 6
    twnd = twanda._prune_row_topk(W, torch.ones(4), 0.25)   # k = 1 a row: all the 1s
    np.testing.assert_array_equal((twnd == 0).sum(1).numpy(), [3, 3])


@pytest.mark.parametrize("name", ["llama", "bloom", "gemma2"])
def test_check_sparsity_matches_jax(name, caplog):
    jcfg, tcfg, jp, tp = variant_pair(name, 15)
    jalg.magnitude(jp, jcfg, 0.4)
    talg.magnitude(tp, tcfg, 0.4)
    with caplog.at_level(logging.DEBUG, logger="llm_compressor_tpu_torch.evalx.sparsity"):
        got = check_sparsity(tp, tcfg)
    assert got == j_check_sparsity(jp, jcfg, verbose=False)
    assert f"Model sparsity : {got:.4f}" in caplog.text
    assert "Layer 1 sparsity" in caplog.text
    caplog.clear()
    assert check_sparsity(tp, tcfg, verbose=False) == got and caplog.text == ""


# mirrors of tests/test_algorithms.py (TestPruning) and
# tests/test_algorithms_archs.py::test_wanda_per_arch, on the port alone

def _mirror(arch, seed=0):
    cfg = tm.tiny_config(arch) if arch != "llama" else tm.tiny_config("llama", num_layers=2)
    p = tm.init_params(cfg, seed=seed, device="cpu")
    toks = synthetic_tokens(4, 32, cfg.vocab_size, seed=1)
    return cfg, p, tpipe.capture_layer0(p, cfg, toks, chunk=2)


def _logits_finite(p, cfg):
    toks = torch.from_numpy(synthetic_tokens(1, 64, cfg.vocab_size, seed=7))
    return bool(torch.isfinite(tm.forward(p, cfg, toks)).all())


@pytest.mark.parametrize("method", ["magnitude", "wanda", "ria", "sparsegpt"])
def test_sparsity_reached(method):
    cfg, p, ctx = _mirror("llama")
    if method == "magnitude":
        talg.magnitude(p, cfg, 0.3)
    elif method == "wanda":
        talg.wanda(p, cfg, ctx, 0.3)
    elif method == "ria":
        talg.ria(p, cfg, ctx, 0.3, alpha=0.5)
    else:
        talg.sparsegpt(p, cfg, ctx, 0.3)
    assert 0.25 < check_sparsity(p, cfg, verbose=False) < 0.35
    assert _logits_finite(p, cfg)


def test_wanda_per_row():
    cfg, p, ctx = _mirror("llama")
    talg.wanda(p, cfg, ctx, 0.25)
    W = talg.common.get_weight(p["layers"][0], "gate").numpy()
    assert np.all((W == 0).sum(axis=1) == int(W.shape[1] * 0.25))


@pytest.mark.parametrize("arch", ["opt", "bloom", "gemma3"])
def test_wanda_per_arch(arch):
    cfg, p, ctx = _mirror(arch)
    talg.wanda(p, cfg, ctx, 0.3)
    assert 0.25 < check_sparsity(p, cfg, verbose=False) < 0.35
    assert _logits_finite(p, cfg)
