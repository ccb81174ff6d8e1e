"""The port's SpinQuant (Hadamard mode) against the JAX package's, on the
same numpy inputs and the same rotations.

Config: the JAX ``tiny_config("llama")`` (float32, hidden 64, head_dim 16,
2 layers, tied embeddings), W4A8 quantizers with ``int4-g[32]`` weights
and int8 per-token activations, an int8-g32 head, 4 x 32 calibration
tokens from ``synthetic_tokens``.

Tolerances:
* norm fusion and rotation with identical R1 / R2s: one float32 ulp. Both
  sides form each product in float64 (numpy and torch sum in other
  orders) and round it once.
* rotation leaves the logits unchanged: 2e-3, as the JAX package's own
  test (float32 forwards through the rotated weights).
* the calibration chain after the rotation (Hessian capture and GPTQ over
  the rotated model): teacher-forced, as ``test_torch_gptq.py``'s whole
  run (``torch_port_util.check_gptq_chain``). Measured: Hessians after an
  activation quantizer within 5.5e-4 of the largest entry, layer inputs
  within 1.8e-4 (one-step int8 activation flips), ``attn_in`` within
  2.7e-7; layer 0's scales bitwise and codes equal to JAX's whole run.
* end to end (pack, fuse, stack, prefill, greedy decode on the W4A8 path,
  the port teacher-forced with JAX's tokens): the JAX package packs and
  serves the port's calibrated weights with the port's scale book; logits
  within 1e-3 of the largest, and the greedy token equal wherever JAX's
  top-2 logit gap exceeds 1e-3 of its largest logit. The two packages'
  own calibrations are not served against each other: their Hessians
  differ in the last float32 bits, and from layer 1 on a GPTQ code that
  flips there moves the next group's int8 activation codes (see
  ``test_torch_gptq.py``), on some seeds and not on others.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import models as jm
from llm_compressor_tpu.capture import pipeline as jpipe
from llm_compressor_tpu.engine import init_cache as j_init
from llm_compressor_tpu.engine import prefill as j_prefill
from llm_compressor_tpu.engine.generate import decode_step as j_step
from llm_compressor_tpu.kernels import hadamard as jh
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu.utils.dataset import synthetic_tokens
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import engine as te
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.algorithms.common import get_weight
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from llm_compressor_tpu_torch.qformats import dequantize
from torch_port_util import (  # noqa: F401
    check_codes,
    check_gptq_chain,
    codes_of,
    jax_to_numpy,
    one_torch_thread,
    recording_gptq_chain,
)

QARGS = ("int4-g[32]-rw", "int8-g[-1]-rw", None, "int8-g[32]-rw")
HEAD_ACT = "int8-g[-1]-rw"
# the algorithms packages re-export ``spinquant`` under the module's name
jsq = importlib.import_module("llm_compressor_tpu.algorithms.spinquant")
tsq = importlib.import_module("llm_compressor_tpu_torch.algorithms.spinquant")
SLOTS = ("q", "k", "v", "o", "gate", "up", "down")


def _models(seed=0, norms=False):
    jcfg, tcfg = jm.tiny_config("llama"), tm.tiny_config("llama")
    p = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    if norms:  # non-trivial norm weights, so that fusion has work to do
        rng = np.random.default_rng(seed)
        for lp in p["layers"]:
            for k in ("ln1", "ln2"):
                lp[k]["weight"] = jnp.asarray(rng.uniform(0.5, 1.5, (jcfg.hidden_size,)),
                                              jnp.float32)
        p["final_norm"]["weight"] = jnp.asarray(
            rng.uniform(0.5, 1.5, (jcfg.hidden_size,)), jnp.float32)
    return jcfg, tcfg, p, params_from_numpy(jax_to_numpy(p), "cpu")


def _rotations(cfg, seed=1):
    """R1 and the R2s as float64 numpy arrays, drawn by the JAX package."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    R1 = np.asarray(jh.random_hadamard_matrix(cfg.hidden_size, k1), np.float64)
    R2s = [np.asarray(jh.random_hadamard_matrix(cfg.head_dim, k), np.float64)
           for k in jax.random.split(k2, cfg.num_layers)]
    return R1, R2s


def _leaves(params):
    out = {"embed": params["embed"]["weight"], "lm_head": params["lm_head"]["weight"],
           "final_norm": params["final_norm"]["weight"]}
    for i, lp in enumerate(params["layers"]):
        for s in SLOTS:
            out[f"{i}.{s}"] = get_weight(lp, s)
        for k in ("ln1", "ln2"):
            out[f"{i}.{k}"] = lp[k]["weight"]
    return {k: np.asarray(v) for k, v in out.items()}


def test_fuse_and_rotate_match_jax():
    jcfg, tcfg, jp, tp = _models(norms=True)
    R1, R2s = _rotations(jcfg)
    jcfg2, tcfg2 = jsq._untie(jp, jcfg), tsq._untie(tp, tcfg)
    assert not tcfg2.tie_word_embeddings and not jcfg2.tie_word_embeddings
    jsq.fuse_layer_norms(jp, jcfg2)
    tsq.fuse_layer_norms(tp, tcfg2)
    jsq._rotate_params(jp, jcfg2, R1, R2s)
    tsq._rotate_params(tp, tcfg2, R1, R2s)
    jl, tl = _leaves(jp), _leaves(tp)
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_array_max_ulp(tl[k], jl[k], maxulp=1)


def test_rotation_preserves_logits():
    """Norm fusion changes the function only by the embedding's
    recentering; the rotation after it leaves the logits unchanged."""
    _, tcfg, _, tp = _models(norms=True)
    R1, R2s = _rotations(tcfg)
    toks = torch.from_numpy(synthetic_tokens(2, 12, tcfg.vocab_size, 3))
    cfg2 = tsq._untie(tp, tcfg)
    tsq.fuse_layer_norms(tp, cfg2)
    mid = tm.forward(tp, cfg2, toks)
    tsq._rotate_params(tp, cfg2, R1, R2s)
    rot = tm.forward(tp, cfg2, toks)
    np.testing.assert_allclose(rot.numpy(), mid.numpy(), rtol=2e-3, atol=2e-3)


def test_rotations_round_trip_through_jax_format(tmp_path):
    cfg = tm.tiny_config("llama")
    R1, R2s = tsq.hadamard_rotations(cfg, seed=3, device="cpu")
    tsq.save_rotations(tmp_path / "R.npz", R1, R2s)
    jR1, jR2s = jsq.load_rotations(tmp_path / "R.npz", cfg)
    np.testing.assert_array_equal(jR1, R1.numpy())
    for a, b in zip(jR2s, R2s):
        np.testing.assert_array_equal(a, b.numpy())
    tR1, tR2s = tsq.load_rotations(tmp_path / "R.npz", cfg)
    np.testing.assert_array_equal(tR1, R1.numpy())
    assert len(tR2s) == cfg.num_layers


def test_hadamard_rotations_seeded_and_orthonormal():
    cfg = tm.tiny_config("llama")
    R1, R2s = tsq.hadamard_rotations(cfg, seed=0, device="cpu")
    assert R1.dtype == torch.float64 and R1.shape == (64, 64)
    np.testing.assert_allclose((R1 @ R1.t()).numpy(), np.eye(64), atol=1e-6)
    assert len(R2s) == 2 and all(r.shape == (16, 16) for r in R2s)
    again, _ = tsq.hadamard_rotations(cfg, seed=0, device="cpu")
    assert torch.equal(R1, again)
    assert not torch.equal(R1, tsq.hadamard_rotations(cfg, seed=1, device="cpu")[0])


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """Both packages calibrate: spinquant from one R.npz, the port's GPTQ
    chain recorded. Then the port's weights -> pack (scale book) -> fuse
    -> stack -> prefill 2 x 16 -> 4 greedy steps in both packages; the port
    fed JAX's tokens."""
    path = tmp_path_factory.mktemp("rot")
    jcfg, tcfg, jp, tp = _models(seed=2)
    R1, R2s = _rotations(jcfg, seed=4)
    jsq.save_rotations(path / "R.npz", R1, R2s)
    jq = jbuild(*QARGS, head_act=HEAD_ACT)
    tq = tbuild(*QARGS, head_act=HEAD_ACT)
    calib = synthetic_tokens(4, 32, jcfg.vocab_size, 1)
    jsb, tsb, jhidden0 = {}, {}, []

    def capture(*args, **kw):
        ctx = jpipe.capture_layer0(*args, **kw)
        jhidden0.append(np.asarray(ctx.hidden))
        return ctx

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsq, "capture_layer0", capture)
        jcfg2 = jalg.spinquant(jp, jcfg, calib, jq, rotation_path=str(path), verbose=False,
                               scale_book=jsb)
    j_layer0 = {s: np.asarray(get_weight(jp["layers"][0], s)) for s in SLOTS}
    timer = talg.PhaseTimer()
    with recording_gptq_chain() as calls:
        tcfg2 = talg.spinquant(tp, tcfg, calib, tq, rotation_path=str(path), scale_book=tsb,
                               timings=timer)
    gptq_w = {(i, s): get_weight(lp, s) for i, lp in enumerate(tp["layers"]) for s in SLOTS}
    # the JAX package serves the port's calibrated weights, packed with its scale book
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    jalg.pack_model(jp, jcfg2, jq, scale_book={
        k: tuple(jnp.asarray(v.numpy()) for v in sz) for k, sz in tsb.items()})
    talg.pack_model(tp, tcfg2, tq, scale_book=tsb)
    packed = {(i, s): get_weight(lp, s) for i, lp in enumerate(tp["layers"]) for s in SLOTS}
    jp = jm.stack_model(jm.fuse_model(jp, jcfg2, jq))
    tp = tm.stack_model(tm.fuse_model(tp, tcfg2, tq))

    B, T, steps, max_len = 2, 16, 4, 64
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    jc = j_init(jcfg2.num_layers, B, max_len, jcfg2.num_kv_heads, jcfg2.head_dim, quantized=True)
    tc = te.init_cache(tcfg2.num_layers, B, max_len, tcfg2.num_kv_heads, tcfg2.head_dim,
                       quantized=True, device="cpu")
    jl, jc = j_prefill(jp, jnp.asarray(toks), jc, cfg=jcfg2, qcfg=jq)
    tl, tc = te.prefill(tp, torch.from_numpy(toks), tc, cfg=tcfg2, qcfg=tq)
    j_logits, t_logits = [np.asarray(jl)], [tl.numpy()]
    for _ in range(steps):
        tok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        jl, jc = j_step(jp, tok, jc, cfg=jcfg2, qcfg=jq)
        tl, tc = te.decode_step(tp, torch.from_numpy(np.array(tok)), tc, cfg=tcfg2, qcfg=tq)
        j_logits.append(np.asarray(jl))
        t_logits.append(tl.numpy())
    return dict(jcfg2=jcfg2, jq=jq, tcfg2=tcfg2, tsb=tsb, jsb=jsb, gptq_w=gptq_w,
                packed=packed, timer=timer, calls=calls, jhidden0=jhidden0[0],
                j_layer0=j_layer0, j_logits=j_logits, t_logits=t_logits)


def test_e2e_untied_config(e2e):
    assert not e2e["tcfg2"].tie_word_embeddings
    assert set(e2e["tsb"]) == set(e2e["jsb"]) == {(i, s) for i in range(2) for s in SLOTS}


def test_e2e_calibration_chain_matches_jax(e2e):
    """The port's Hessian capture through the online rotations and its GPTQ
    over the rotated model, teacher-forced against the JAX package's
    functions (``check_gptq_chain``); layer 0, whose input both whole runs
    share, also against JAX's whole run."""
    r = e2e
    check_gptq_chain(r["calls"], r["jcfg2"], r["jq"], r["gptq_w"], r["tsb"], r["jhidden0"])
    for s in SLOTS:
        ts, tz = (v.numpy() for v in r["tsb"][(0, s)])
        js, jz = (np.asarray(v) for v in r["jsb"][(0, s)])
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tz, jz)
        g = r["gptq_w"][(0, s)].shape[1] // ts.shape[1]
        check_codes(codes_of(r["gptq_w"][(0, s)].numpy(), ts, tz, g),
                    codes_of(r["j_layer0"][s], js, jz, g))


def test_e2e_packs_losslessly(e2e):
    for k, w in e2e["gptq_w"].items():
        assert torch.equal(dequantize(e2e["packed"][k]), w), k


def test_e2e_timings(e2e):
    sec = e2e["timer"].seconds
    assert set(sec) == {"rotation", "hessians", "updates"} and all(v > 0 for v in sec.values())


def test_e2e_greedy_tokens_match_jax(e2e):
    checked = 0
    for j, t in zip(e2e["j_logits"], e2e["t_logits"]):
        assert np.isfinite(t).all() and t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-3 * np.abs(j).max())
        top2 = np.sort(j, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > 1e-3 * np.abs(j).max()
        checked += int(sure.sum())
        np.testing.assert_array_equal(np.argmax(t, -1)[sure], np.argmax(j, -1)[sure])
    assert checked == sum(len(j) for j in e2e["j_logits"])  # no near-ties here


def test_non_llama_and_optimize_raise():
    """An unknown mode raises; a model of another family raises in both
    modes: SpinQuant stays Llama-only, as in JAX (``mode="optimize"`` runs
    since its port; ``tests/test_torch_spinquant_opt.py``)."""
    _, tcfg, _, tp = _models()
    toks = synthetic_tokens(2, 8, tcfg.vocab_size)
    qcfg = tbuild(*QARGS)
    with pytest.raises(ValueError, match="unknown SpinQuant mode"):
        talg.spinquant(tp, tcfg, toks, qcfg, mode="learned")
    other = tm.tiny_config("opt")
    for mode in ("hadamard", "optimize"):
        with pytest.raises(NotImplementedError, match="llama family"):
            talg.spinquant(tm.init_params(other, device="cpu"), other, toks, qcfg, mode=mode)


def test_spinquant_mse_matches_jax(tmp_path):
    """``spinquant(mse=True)``, refused before, threads the MSE clip search
    into GPTQ and the head's RTN as the JAX package does: both packages
    from one R.npz, the port's GPTQ chain teacher-forced against JAX's
    functions with the MSE quantizers (``check_gptq_chain(mse=True)``),
    layer 0's scale book and the untied head (RTN with the search) equal to JAX's whole
    run bitwise."""
    jcfg, tcfg, jp, tp = _models(seed=5)
    R1, R2s = _rotations(jcfg, seed=6)
    jsq.save_rotations(tmp_path / "R.npz", R1, R2s)
    jq, tq = jbuild(*QARGS, head_act=HEAD_ACT), tbuild(*QARGS, head_act=HEAD_ACT)
    calib = synthetic_tokens(4, 32, jcfg.vocab_size, 2)
    jsb, tsb, jhidden0 = {}, {}, []

    def capture(*args, **kw):
        ctx = jpipe.capture_layer0(*args, **kw)
        jhidden0.append(np.asarray(ctx.hidden))
        return ctx

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsq, "capture_layer0", capture)
        jcfg2 = jalg.spinquant(jp, jcfg, calib, jq, rotation_path=str(tmp_path), mse=True,
                               verbose=False, scale_book=jsb)
    with recording_gptq_chain() as calls:
        talg.spinquant(tp, tcfg, calib, tq, rotation_path=str(tmp_path), mse=True,
                       scale_book=tsb)
    gptq_w = {(i, s): get_weight(lp, s) for i, lp in enumerate(tp["layers"]) for s in SLOTS}
    check_gptq_chain(calls, jcfg2, jq, gptq_w, tsb, jhidden0[0], mse=True)
    for s in SLOTS:
        np.testing.assert_array_equal(tsb[(0, s)][0].numpy(), np.asarray(jsb[(0, s)][0]))
    np.testing.assert_array_equal(tp["lm_head"]["weight"].numpy(),
                                  np.asarray(jp["lm_head"]["weight"]))
