"""B5, the dequantize-in-kernel matmul: the port's ``dequant_matmul`` (its
plain version, on the CPU) against the JAX package's (the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it) on the same numpy
inputs.

Tolerance: one bf16 ulp of the output (one f32 ulp for an f32 output) plus
the f32 summation term 2 * C * 2**-24 * (|x| @ |W|^T). Both sides build the
same bf16 weight and multiply exact bf16 products; only the order of the
f32 sums differs, which moves a bf16 output across at most one rounding
boundary. Against ``dequant_matmul_xla`` (``dequantize`` then a matmul,
which rounds the weight differently) the JAX test's own 2e-2 holds.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu.qformats import parse_qspec as jparse, quantize_pack as jpack
from llm_compressor_tpu_torch.kernels import dequant_matmul as tdm
from llm_compressor_tpu_torch.qformats import parse_qspec as tparse, quantize_pack as tpack
from torch_port_util import one_torch_thread  # noqa: F401

# the JAX kernels package re-exports the function under the module's name
jdm = importlib.import_module("llm_compressor_tpu.kernels.dequant_matmul")

CASES = [
    # (spec, N, C, x shape lead, x dtype, bias, expected int4 pair planes)
    ("int4-g[128]-rw", 256, 512, (8,), "bfloat16", False, True),
    ("int4-g[128]-zp-rw", 256, 512, (8,), "bfloat16", False, True),
    ("int4-g[256]-rw", 128, 768, (8,), "bfloat16", False, False),     # 3 groups: halves
    ("int4-g[256]-zp-rw", 128, 768, (8,), "bfloat16", False, False),
    ("int8-g[128]-rw", 256, 512, (8,), "bfloat16", False, False),
    ("int8-g[128]-zp-rw", 128, 384, (8,), "bfloat16", False, False),
    ("fp8_e4m3-g[128]-rw", 256, 512, (8,), "bfloat16", False, False),
    ("fp8_e5m2-g[128]-rw", 256, 512, (8,), "bfloat16", False, False),
    ("fp8_e4m3-g[128]-zp-rw", 128, 512, (8,), "bfloat16", False, False),  # z added
    ("fp8_e5m2-g[128]-zp-rw", 128, 384, (8,), "bfloat16", False, False),
    ("int4-g[128]-rw", 256, 256, (2, 4), "bfloat16", True, True),     # 3-D x, bias
    ("int4-g[128]-zp-rw", 128, 512, (6,), "float32", False, True),    # f32 x -> f32 out
    ("fp8_e4m3-g[128]-rw", 128, 256, (2, 3), "float32", True, False),
    ("int8-g[160]-rw", 128, 640, (8,), "bfloat16", False, False),     # g not a multiple of 64
    ("int4-g[160]-zp-rw", 128, 1280, (8,), "bfloat16", False, True),
]


def _ulp(v: np.ndarray, dtype: str) -> np.ndarray:
    _, e = np.frexp(np.abs(v).astype(np.float64))
    return np.exp2(e - (8 if dtype == "bfloat16" else 24))


def _inputs(spec, N, C, lead, seed):
    rng = np.random.default_rng(seed)
    W = rng.normal(0, 0.1, size=(N, C)).astype(np.float32)
    x = rng.normal(size=lead + (C,)).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    return W, x, b


@pytest.mark.parametrize("spec,N,C,lead,xdt,bias,pairs", CASES)
def test_dequant_matmul_matches_jax(spec, N, C, lead, xdt, bias, pairs):
    W, x, b = _inputs(spec, N, C, lead, seed=N + C)
    jqt = jpack(jparse(spec), jnp.asarray(W))
    tqt = tpack(tparse(spec), torch.from_numpy(W))
    assert jdm._supported(jqt) and tdm.supported(tqt)
    assert bool(tqt.pair_planes) == pairs == bool(jqt.pair_planes)
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if xdt == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, xdt))
    jb, tb = (jnp.asarray(b), torch.from_numpy(b)) if bias else (None, None)

    got = tdm.dequant_matmul(tx, tqt, tb)
    want = np.asarray(jdm.dequant_matmul(jx, jqt, jb)).astype(np.float32)
    assert got.dtype == tx.dtype and tuple(got.shape) == lead + (N,)
    got = got.float().numpy()

    # summation term from the bf16 operands both sides multiply
    wb = tdm.dequant_weight_bf16(tqt.codes, tqt.scales, tqt.zeros, tdm.weight_format(tqt))
    xb = tx.reshape(-1, C).to(torch.bfloat16).float()
    mag = (xb.abs() @ wb.float().abs().t()).numpy().reshape(want.shape)
    if bias:
        mag = mag + np.abs(b)
    tol = _ulp(want, xdt) + 2 * C * 2.0 ** -24 * mag
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()

    ref = np.asarray(jdm.dequant_matmul_xla(jx, jqt, jb)).astype(np.float32)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())


@pytest.mark.parametrize("spec,N,C", [
    ("int4-g[32]-rw", 64, 64),        # group below 128
    ("int4-g[128]-rw", 96, 256),      # N not a multiple of 128
    ("int4-g[128]-rw", 128, 384),     # odd group count with g / 2 < 128
    ("int8-g[-1]-rw", 128, 256),      # per-token group (g = C) is fine ...
    ("fp8_e4m3-g[64]-rw", 128, 256),  # fp8 group below 128
    ("int4-g[128]-rw", 128, 200),     # logical C padded at pack time
])
def test_routing_matches_jax(spec, N, C):
    """Both packages send every shape the same way; a rejected shape takes
    the dequantize + matmul route in both."""
    W, x, _ = _inputs(spec, N, C, (4,), seed=7)
    jqt = jpack(jparse(spec), jnp.asarray(W))
    tqt = tpack(tparse(spec), torch.from_numpy(W))
    assert tdm.supported(tqt) == jdm._supported(jqt)
    got = tdm.dequant_matmul(torch.from_numpy(x), tqt).numpy()
    want = np.asarray(jdm.dequant_matmul(jnp.asarray(x), jqt))
    if tdm.supported(tqt):
        np.testing.assert_allclose(got, want, rtol=0, atol=C * 2.0 ** -9 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_plain_version_is_the_cpu_path():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; on a layer view of stacked codes it takes the view as is."""
    W, x, _ = _inputs("int4-g[128]-rw", 128, 256, (4,), seed=3)
    qt = tpack(tparse("int4-g[128]-rw"), torch.from_numpy(W))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    before = tdm.dequant_matmul_codes.launches
    stacked = torch.stack([qt.codes, qt.codes])
    got = tdm.dequant_matmul_codes(xb, stacked[1], qt.scales, None, tdm.F_INT4_PAIRS,
                                   torch.float32)
    want = tdm.dequant_matmul_plain(xb, qt.codes, qt.scales, None, tdm.F_INT4_PAIRS,
                                    torch.float32)
    assert torch.equal(got, want) and tdm.dequant_matmul_codes.launches == before
    with pytest.raises(ValueError, match="codes"):
        tdm.dequant_matmul_codes(xb, qt.codes, qt.scales, None, tdm.F_INT8, torch.float32)


@pytest.mark.parametrize("spec,N,C", [
    ("int4-g[128]-rw", 128, 256), ("int4-g[128]-zp-rw", 128, 256),
    ("int4-g[256]-rw", 128, 768), ("int4-g[256]-zp-rw", 128, 768),
    ("int8-g[128]-rw", 128, 256), ("int8-g[128]-zp-rw", 128, 256),
    ("fp8_e4m3-g[128]-rw", 128, 256), ("fp8_e5m2-g[128]-rw", 128, 256),
    ("fp8_e4m3-g[128]-zp-rw", 128, 256), ("fp8_e5m2-g[128]-zp-rw", 128, 256),
    ("int4-g[160]-zp-rw", 128, 1280),
])
def test_weight_rounding_bitwise(spec, N, C):
    """The bf16 weight each body builds, read out through x = I (every
    output is one exact product 1 * w): bitwise equal in both packages."""
    W, _, _ = _inputs(spec, N, C, (1,), seed=11)
    jqt = jpack(jparse(spec), jnp.asarray(W))
    tqt = tpack(tparse(spec), torch.from_numpy(W))
    eye = np.eye(C, dtype=np.float32)
    want = np.asarray(jdm.dequant_matmul(jnp.asarray(eye, jnp.bfloat16), jqt)).astype(np.float32)
    got = tdm.dequant_matmul(torch.from_numpy(eye).to(torch.bfloat16), tqt).float().numpy()
    wb = tdm.dequant_weight_bf16(tqt.codes, tqt.scales, tqt.zeros, tdm.weight_format(tqt))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(wb.float().numpy().T, want)


PLAN_CASES = [
    # (case, M, N, C, g, format, expected splits or None)
    ("down", 128, 2048, 8192, 128, tdm.F_INT4_PAIRS, 8),
    ("o", 128, 2048, 2048, 128, tdm.F_INT4_PAIRS, 8),
    ("qkv", 128, 3072, 2048, 128, tdm.F_INT4_PAIRS, 8),
    ("gate|up", 128, 16384, 2048, 128, tdm.F_INT4_PAIRS, 1),
    ("int8 head", 128, 128256, 2048, 128, tdm.F_INT8, 1),
    ("down M=8", 8, 2048, 8192, 128, tdm.F_INT4_PAIRS, 8),
    ("down M=130", 130, 2048, 8192, 128, tdm.F_INT4_PAIRS, 4),
    ("halves, G=3", 8, 192, 768, 256, tdm.F_INT4_HALVES, 2),
    ("halves, G=5", 130, 192, 1280, 256, tdm.F_INT4_HALVES, 4),
    ("int4-g[192] pairs", 8, 192, 768, 192, tdm.F_INT4_PAIRS, 2),
    ("int8 N=192, G=3", 130, 192, 384, 128, tdm.F_INT8, 2),
    ("fp8 N=192", 8, 192, 512, 128, tdm.F_FP8_E4M3, 4),
]


@pytest.mark.parametrize("case,M,N,C,g,fmt,want", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_split_plan(case, M, N, C, g, fmt, want):
    """The K-split plan on a 132-SM card: a power of two, at most 16 and at
    most the groups (pairs for pair planes), so every split takes at least
    one whole unit; none when the tiles already reach 1.5 x 132 CTAs, else
    the smallest power of two that does (or the most the groups allow).
    How the kernel cuts the units is checked on the card, against the
    plain version, by the uneven splits of tests/test_torch_kernels_gpu.py."""
    sms = 132
    s = tdm.split_plan(M, N, C, g, fmt, sms)
    assert s == want and 1 <= s <= tdm.MAX_SPLITS and s & (s - 1) == 0
    assert s <= tdm.split_units(C, g, fmt)
    tiles = -(-M // 128) * (N // 64)
    if tiles >= 1.5 * sms:
        assert s == 1
    elif s > 1:
        assert tiles * (s // 2) < 1.5 * sms
    if tiles * s < 1.5 * sms:   # short of the fill only where the groups ran out
        assert 2 * s > min(tdm.split_units(C, g, fmt), tdm.MAX_SPLITS)
