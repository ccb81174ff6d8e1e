"""SpinQuant's optimize mode and the evaluation stack on the card against
the same functions on the CPU, at tiny width.

Run on a machine with an H100:
``python -m pytest -m gpu --noconftest tests/test_torch_evalx_gpu.py``.
Here, without a card, every test skips (the check runs inside a fixture).
This file imports no JAX: the card's machine has none; the CPU side is held
to the JAX package by ``tests/test_torch_{spinquant_opt,ppl,profiler}.py``.

Config: ``tiny_config("llama")`` (float32; hidden 64 for the rotations and
the profile, hidden 256 / intermediate 512 / head_dim 64 / vocab 512 for
perplexity, where the packed model's projections take B1-B3), the same
weights on both devices (drawn on the CPU and copied), the default
float32 matmul precision (no TF32). The card sums in other orders, so:

* the straight-through loss within 1e-5 relative; its gradients with
  respect to R1 and the R2s within 1e-4 of their largest entry,
  weight-only int4-g32 (in W4A8 an int8 activation code that flips, or
  an absmax tie that breaks otherwise, moves a gradient locally:
  ``tests/test_torch_spinquant_opt.py``; there only the loss is held, to
  1e-4); one SGDG step's R1 and R2s within 1e-5;
* ``compute_ppl``: float within 1e-5 relative, packed W4A8 within 2e-3
  (int8 activation codes, as against JAX);
* ``profile_model``'s CSV: the bounds of ``tests/test_torch_profiler.py``
  (weight rows 1e-4 relative, activation rows 1e-2, ClipError 1e-5 of the
  row's |Max|, Elem and BPV equal, the same rows in the same order).
"""

import importlib
from dataclasses import replace

import numpy as np
import pytest
import torch

from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import evalx as tev
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.qformats import QTensor, build_quant_config
from llm_compressor_tpu_torch.utils import synthetic_tokens

pytestmark = pytest.mark.gpu
tsq = importlib.import_module("llm_compressor_tpu_torch.algorithms.spinquant")

W_ONLY = ("int4-g[32]-rw", None, None, None)
W4A8 = ("int4-g[32]-rw", "int8-g[-1]-rw", None, "int8-g[32]-rw")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (H100); the CPU side is held to JAX by the CPU tests")
    return torch.device("cuda")


def _to(tree, dev):
    if isinstance(tree, QTensor):
        return replace(tree, codes=tree.codes.to(dev), scales=tree.scales.to(dev),
                       zeros=None if tree.zeros is None else tree.zeros.to(dev))
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


def _rel(got, want):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max())


def _untied(**kw):
    cfg = tm.tiny_config("llama", **kw)
    p = tm.init_params(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for lp in p["layers"]:
        for k in ("ln1", "ln2"):
            lp[k]["weight"] = 1.0 + 0.1 * torch.randn(cfg.hidden_size, generator=gen)
    cfg = tsq._untie(p, cfg)
    return cfg, p


def _loss_grads(p, cfg, qcfg, R1, R2s, toks, dev):
    loss_fn = tsq.make_rotated_ste_loss(_to(p, dev), cfg, qcfg)
    r1, r2 = R1.to(dev).requires_grad_(), R2s.to(dev).requires_grad_()
    loss = loss_fn(r1, r2, torch.as_tensor(toks, device=dev))
    g1, g2 = torch.autograd.grad(loss, (r1, r2))
    return float(loss.detach()), g1, g2


@pytest.mark.parametrize("spec", ["w4", "w4a8"])
def test_ste_loss_and_gradients_card_vs_cpu(cuda, spec):
    cfg, p = _untied()
    qcfg = build_quant_config(*(W_ONLY if spec == "w4" else W4A8),
                              head_act=None if spec == "w4" else "int8-g[-1]-rw")
    R1, R2s = tsq.hadamard_rotations(cfg, 0, "cpu")
    R1, R2s = R1.float(), torch.stack([r.float() for r in R2s])
    toks = synthetic_tokens(4, 16, cfg.vocab_size, 1)
    cl, c1, c2 = _loss_grads(p, cfg, qcfg, R1, R2s, toks, "cpu")
    gl, g1, g2 = _loss_grads(p, cfg, qcfg, R1, R2s, toks, cuda)
    assert np.isfinite(gl) and torch.isfinite(g1).all() and torch.isfinite(g2).all()
    if spec == "w4":
        np.testing.assert_allclose(gl, cl, rtol=1e-5)
        assert _rel(g1, c1) <= 1e-4 and _rel(g2, c2) <= 1e-4
    else:
        np.testing.assert_allclose(gl, cl, rtol=1e-4)


def test_one_optimize_step_card_vs_cpu(cuda):
    """One step of ``optimize_rotations`` (weight-only) from the same
    Hadamard draws (B10 on the card, its plain version on the CPU)."""
    cfg, p = _untied()
    qcfg = build_quant_config(*W_ONLY)
    toks = synthetic_tokens(4, 16, cfg.vocab_size, 1)
    cpu = tsq.optimize_rotations(p, cfg, toks, qcfg, n_steps=1, batch=4)
    card = tsq.optimize_rotations(_to(p, cuda), cfg, toks, qcfg, n_steps=1, batch=4)
    assert card[0].device.type == "cuda" and card[0].dtype == torch.float64
    assert _rel(card[0], cpu[0]) <= 1e-5
    for a, b in zip(card[1], cpu[1]):
        assert _rel(a, b) <= 1e-5


def _ppl_models(packed):
    cfg = tm.tiny_config("llama", hidden_size=256, intermediate_size=512, head_dim=64,
                         vocab_size=512)
    qcfg = build_quant_config("int4-g[128]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw",
                              head_act="int8-g[-1]-rw")
    p = tm.init_params(cfg, seed=5, device="cpu")
    if packed:
        talg.rtn(p, cfg, qcfg)
        talg.pack_model(p, cfg, qcfg)
        p = tm.stack_model(tm.fuse_model(p, cfg, qcfg))
    return cfg, (qcfg if packed else None), p


@pytest.mark.parametrize("packed", [False, True])
def test_compute_ppl_card_vs_cpu(cuda, packed):
    from llm_compressor_tpu_torch import kernels

    cfg, qcfg, p = _ppl_models(packed)
    stream = synthetic_tokens(1, 1, cfg.vocab_size, 2, eval_len=4 * 64 + 3)
    cpu = tev.compute_ppl(p, cfg, stream, seq_len=64, qcfg=qcfg, batch_size=3)
    kernels.reset_counts()
    card = tev.compute_ppl(_to(p, cuda), cfg, stream, seq_len=64, qcfg=qcfg, batch_size=3)
    counts = kernels.launch_counts()
    np.testing.assert_allclose(card, cpu, rtol=2e-3 if packed else 1e-5)
    if packed:   # the projections and the head through the W4A8 kernels
        assert counts["w4a8_stacked"] > 0 or counts["w4a8_flat"] > 0, counts


def _csv(path):
    lines = path.read_text().splitlines()
    return lines[0], [[c.strip() for c in ln.split(",")] for ln in lines[1:]]


def test_profile_csv_card_vs_cpu(cuda, tmp_path):
    cfg, p = _untied()
    qcfg = build_quant_config(*W4A8, head_act="int8-g[-1]-rw")
    toks = synthetic_tokens(1, 32, cfg.vocab_size, 5)
    (tmp_path / "cpu").mkdir()
    (tmp_path / "card").mkdir()
    want = tev.profile_model(p, cfg, qcfg, toks, save_path=str(tmp_path / "cpu"))
    got = tev.profile_model(_to(p, cuda), cfg, qcfg, toks, save_path=str(tmp_path / "card"))
    (gh, g), (wh, w) = _csv(got), _csv(want)
    assert gh == wh and [r[0] for r in g] == [r[0] for r in w]
    keys = [k.strip() for k in wh.split(",")]
    for a, b in zip(g, w):
        vals = {k: (float(x), float(y)) for k, x, y in zip(keys[1:], a[1:], b[1:])}
        tol = 1e-4 if a[0].endswith(".weight") else 1e-2
        for k, (x, y) in vals.items():
            if k in ("Elem", "BPV"):
                assert x == y, (a[0], k)
            elif k == "ClipError":
                assert abs(x - y) <= 1e-5 * abs(vals["Max"][1]), (a[0], k, x, y)
            else:
                assert abs(x - y) <= tol * max(abs(x), abs(y)), (a[0], k, x, y)
