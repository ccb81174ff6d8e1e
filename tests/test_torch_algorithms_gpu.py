"""The calibration and pruning algorithms on the card against the same
functions on the CPU, at tiny width.

Run on a machine with an H100:
``python -m pytest -m gpu --noconftest tests/test_torch_algorithms_gpu.py``.
Here, without a card, every test skips (the check runs inside a fixture).
This file imports no JAX: the card's machine has none; the CPU side is held
to the JAX package by ``tests/test_torch_{awq,smoothquant,gptaq,pruning}.py``.

Config: ``tiny_config`` Llama and BLOOM (hidden 64, 2 layers, float32),
the same weights on both devices (drawn on the CPU and copied), 4 x 32
calibration tokens, TF32 off (the algorithms run under
``full_f32_matmul``). The card sums in other orders (the layer forwards,
the statistics, the Cholesky factors), so:

* pruning masks (magnitude, Wanda, RIA, SparseGPT): equal; SparseGPT's
  kept weights within 1e-4 of the largest |W|;
* the quantizing algorithms (SmoothQuant, AWQ, AWQ+, GPTAQ), each with
  its scale book: scales within 1e-5 (relative), integer codes
  round(W / s) at most one step apart, at least 99.9 % equal on layer 0
  (a value on a rounding boundary, or GPTQ's error feedback, as
  ``torch_port_util.check_codes`` holds the port to JAX) and 99 % on
  layer 1, whose inputs went through layer 0's int8 activation
  quantizers on each device (a one-step act flip moves the Hessian; the
  CPU tests teacher-force each layer instead; measured 99.40 %, GPTAQ on
  BLOOM's fc2).
"""

import numpy as np
import pytest
import torch

from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.capture import capture_layer0
from llm_compressor_tpu_torch.models.transformer import arch_slots
from llm_compressor_tpu_torch.qformats import build_quant_config
from llm_compressor_tpu_torch.utils import synthetic_tokens

pytestmark = pytest.mark.gpu

W_ONLY = ("int4-g[32]-rw", None, None, None)
W4A8 = ("int4-g[32]-rw", "int8-g[-1]-rw", None, None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (H100); the CPU side is held to JAX by the CPU tests")
    return torch.device("cuda")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return None if tree is None else tree.to(dev)


def _run(arch, dev, fn, seed=0):
    """``fn(params, cfg, ctx, ctx2)`` on ``dev``; the params back on the CPU."""
    cfg = tm.tiny_config(arch)
    p = _to(tm.init_params(cfg, seed=seed, device="cpu"), dev)
    toks = synthetic_tokens(4, 32, cfg.vocab_size, seed + 1)
    toks2 = synthetic_tokens(4, 32, cfg.vocab_size, seed + 2)
    out = fn(p, cfg, capture_layer0(p, cfg, toks, chunk=2), capture_layer0(p, cfg, toks2))
    return cfg, _to(p, "cpu"), _to(out, "cpu")


PRUNE = {
    "magnitude": lambda p, cfg, ctx, _: talg.magnitude(p, cfg, 0.5),
    "wanda": lambda p, cfg, ctx, _: talg.wanda(p, cfg, ctx, 0.5),
    "ria": lambda p, cfg, ctx, _: talg.ria(p, cfg, ctx, 0.5),
    "sparsegpt": lambda p, cfg, ctx, _: talg.sparsegpt(p, cfg, ctx, 0.5),
}


@pytest.mark.parametrize("arch", ["llama", "bloom"])
@pytest.mark.parametrize("method", list(PRUNE))
def test_pruning_card_equals_cpu(cuda, method, arch):
    cfg, pc, _ = _run(arch, "cpu", PRUNE[method])
    _, pg, _ = _run(arch, cuda, PRUNE[method])
    for lc, lg in zip(pc["layers"], pg["layers"]):
        for s in arch_slots(cfg):
            wc, wg = talg.common.get_weight(lc, s), talg.common.get_weight(lg, s)
            assert torch.equal(wc == 0, wg == 0), s
            if method == "sparsegpt":
                assert float((wc - wg).abs().max()) <= 1e-4 * float(wc.abs().max()), s
            else:
                assert torch.equal(wc, wg), s


def _book(fn):
    def run(p, cfg, ctx, ctx2):
        book = {}
        fn(p, cfg, ctx, ctx2, book)
        return book
    return run


QUANT = {
    "smoothquant": lambda p, cfg, ctx, _, b: talg.smoothquant(
        p, cfg, ctx, build_quant_config(*W_ONLY), alpha=0.8, scale_book=b),
    "awq": lambda p, cfg, ctx, _, b: talg.awq(p, cfg, ctx, build_quant_config(*W4A8),
                                              scale_book=b),
    "awq_plus": lambda p, cfg, ctx, ctx2, b: talg.awq_plus(
        p, cfg, ctx, ctx2, build_quant_config(*W_ONLY), scale_book=b),
    "gptaq": lambda p, cfg, ctx, _, b: talg.gptaq(p, cfg, ctx, build_quant_config(*W4A8),
                                                  scale_book=b),
}


@pytest.mark.parametrize("arch", ["llama", "bloom"])
@pytest.mark.parametrize("method", list(QUANT))
def test_quantizing_card_equals_cpu(cuda, method, arch):
    cfg, pc, bc = _run(arch, "cpu", _book(QUANT[method]))
    _, pg, bg = _run(arch, cuda, _book(QUANT[method]))
    assert set(bc) == set(bg)
    for (i, s), (sc, zc) in bc.items():
        sg, zg = bg[(i, s)]
        torch.testing.assert_close(sg, sc, rtol=1e-5, atol=0)
        wc = talg.common.get_weight(pc["layers"][i], s)
        wg = talg.common.get_weight(pg["layers"][i], s)
        N, C = wc.shape
        g = C // sc.shape[1]
        code = lambda w, sv, zv: torch.round(w.reshape(N, C // g, g) / sv + zv)
        d = (code(wc, sc, zc) - code(wg, sg, zg)).abs()
        assert float(d.max()) <= 1, (i, s)
        assert float((d == 0).float().mean()) >= (0.999 if i == 0 else 0.99), (i, s)
