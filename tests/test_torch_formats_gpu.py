"""The quantizer formats on the card against the same functions on the CPU.

Run on a machine with an H100: ``python -m pytest -m gpu tests/test_torch_formats_gpu.py``.
Here, without a card, every test skips (the check runs inside a fixture).
This file imports no JAX: the card's machine has none; the CPU side is held
to the JAX package by ``tests/test_torch_formats.py``.

Tolerances: the solvers (the MX exponent from ``frexp`` and the f32 bits,
NVFP4's fp8 group scales), the codes, ``dequantize`` and the fake
quantization are elementwise float32 operations and exact reductions (max,
min): bitwise. The MSE clip search sums ``|d|**2.4`` per group, a sum the
card reduces in another order: its picks equal the CPU's on at least 99 %
of the groups, and where they part the CPU's objective at the card's pick
is within 1e-5 relative of its own best (a tie).
"""

import numpy as np
import pytest
import torch

from llm_compressor_tpu_torch import qformats as tq
from llm_compressor_tpu_torch.qformats import quantize as tquant

pytestmark = pytest.mark.gpu

SPECS = ["mxint4-g[32]-rw", "mxint8-g[32]-zp-rw", "mxfp8_e4m3-g[128]-rw", "mxfp4_e2m1-g[32]-rw",
         "nvfp4_e2m1-g[16]-rw", "nvfp4_e2m1-g[16]-zp-rw", "fp4_e2m1-g[32]-rw",
         "fp8_e4m3-g[128]-zp-rw"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (H100); the CPU side is tests/test_torch_formats.py")
    return torch.device("cuda")


def _x(shape, seed, std):
    return torch.from_numpy((np.random.default_rng(seed).normal(size=shape) * std)
                            .astype(np.float32))


@pytest.mark.parametrize("std", [1.0, 0.02])
@pytest.mark.parametrize("spec", SPECS)
def test_formats_card_equals_cpu(cuda, spec, std):
    q = tq.parse_qspec(spec)
    x = _x((256, 1024), 0, std)
    for dtype in (torch.float32, torch.bfloat16):
        xc, xg = x.to(dtype), x.to(dtype).to(cuda)
        for jitted in (False, True):
            sc, zc = tquant.find_params(q, xc, jitted=jitted)
            sg, zg = tquant.find_params(q, xg, jitted=jitted)
            assert torch.equal(sc, sg.cpu()) and torch.equal(zc, zg.cpu()), (dtype, jitted)
        a, b = tq.quantize_pack(q, xc), tq.quantize_pack(q, xg)
        codes = lambda t: t.view(torch.uint8) if t.dtype.is_floating_point else t
        assert torch.equal(codes(a.codes), codes(b.codes).cpu())
        assert torch.equal(tq.dequantize(a), tq.dequantize(b).cpu())
        assert torch.equal(tq.quantize_dequant(q, xc), tq.quantize_dequant(q, xg).cpu())


@pytest.mark.parametrize("spec", ["int4-g[128]-rw", "int4-g[128]-zp-rw", "mxfp8_e4m3-g[32]-rw",
                                  "nvfp4_e2m1-g[16]-rw", "mxint8-g[32]-zp-rw"])
def test_mse_card_picks_cpu(cuda, spec):
    q = tq.parse_qspec(spec, mse=True)
    x = _x((256, 1024), 1, 0.02)
    sc, zc = tquant.find_params(q, x)
    sg, zg = (t.cpu() for t in tquant.find_params(q, x.to(cuda)))
    same = (sc == sg) & (zc == zg)
    assert same.float().mean() >= 0.99, same.float().mean()
    if not bool(same.all()):
        xb, _, axes = tquant.block_for(q, x)

        def objective(s, z):
            dq = tquant.fake_quantize_blocked(q, xb, s, z, jitted=True)
            return (dq - xb).abs().pow(2.4).sum(axes, keepdim=True)

        best, mine = objective(sc, zc), objective(sg, zg)
        assert torch.allclose(mine[~same], best[~same], rtol=1e-5, atol=0)
