"""Split-K of the W4A8 core (B1, B3, B9) on the CPU: the plain version
summed in splits, the split plan, and B9's wrapper at wide rows, against
the JAX W4A8 kernels (Pallas in interpret mode) on the same numpy inputs.

Tolerances:
* splits against one split: the same f32 terms float(x_g . w_g) * s_g,
  added in another order, so they differ by at most
  2 G 2**-24 sum_g |term_g| before the act scale, plus one f32 rounding of
  the output;
* against JAX: ``_close`` of ``test_torch_w4a8.py`` (a few f32 ulps of the
  output's magnitude: the JAX pair-planes path folds a +8 bias into its
  dots and sums blocks in another order).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_compressor_tpu.qformats import parse_qspec as jparse, quantize_pack as jpack
from llm_compressor_tpu_torch.convert import qtensor_from_numpy
from llm_compressor_tpu_torch.kernels import w4a8_matmul as tw
from torch_port_util import jax_to_numpy, one_torch_thread  # noqa: F401

jw = importlib.import_module("llm_compressor_tpu.kernels.w4a8_matmul")
M, N = 8, 256
SMS = 132   # an H100 SXM
E, I, V = 2048, 8192, 128256   # Llama-3.2-1B widths


def _close(a, b):
    a, b = np.asarray(a), b.numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * np.abs(a).max())


@functools.lru_cache(maxsize=None)
def _case(spec, c):
    """JAX packed weight, the port's copy, x, and JAX's flat W4A8 output."""
    rng = np.random.default_rng(c)
    jqt = jpack(jparse(spec), jnp.asarray(rng.normal(size=(N, c)).astype(np.float32)))
    x = rng.normal(size=(M, c)).astype(np.float32)
    want = np.asarray(jax.jit(jw.w4a8_matmul)(jnp.asarray(x), jqt))
    return qtensor_from_numpy(jax_to_numpy(jqt), "cpu"), x, want


# units: int8 8 groups, pair planes 8 group pairs, group halves 9 groups
@pytest.mark.parametrize("spec,c,wfmt", [("int8-g[128]-rw", 1024, tw.W_INT8),
                                         ("int4-g[128]-rw", 2048, tw.W_PAIRS),
                                         ("int4-g[128]-rw", 1152, tw.W_HALVES)])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_plain_splits(spec, c, wfmt, splits):
    qt, x, want = _case(spec, c)
    assert tw._wfmt(qt) == wfmt
    x_i8, sx = tw.quantize_acts_per_token(torch.from_numpy(x))
    got = tw.w4a8_plain(x_i8, qt.codes, qt.scales, sx, wfmt, torch.float32, splits=splits)
    one = tw.w4a8_plain(x_i8, qt.codes, qt.scales, sx, wfmt, torch.float32)
    G = qt.scales.shape[1]
    g = c // G
    w = tw._int_weights(qt.codes, G, wfmt).double().abs()
    xa = x_i8.double().abs()
    mag = sum((xa[:, k * g:(k + 1) * g] @ w[:, k * g:(k + 1) * g].T) * qt.scales[:, k].double()
              for k in range(G))
    tol = (2 * G * 2.0 ** -24 * mag * sx.double() + 2.0 ** -23 * one.double().abs())
    assert bool(((got.double() - one.double()).abs() <= tol).all())
    if splits == 1:
        assert torch.equal(got, one)
    _close(want, got)
    # the wrappers on CPU tensors run the plain version at the split count asked for
    assert torch.equal(tw.matmul_flat(x_i8, qt.codes, qt.scales, sx, wfmt, torch.float32,
                                      splits=splits), got)
    assert torch.equal(tw.matmul_stacked(x_i8, qt.codes[None], qt.scales[None], sx, 0, wfmt,
                                         torch.float32, splits=splits), got)


def test_forced_splits_outside_the_units_raise():
    qt, x, _ = _case("int4-g[128]-rw", 2048)   # 8 group pairs
    x_i8, sx = tw.quantize_acts_per_token(torch.from_numpy(x))
    for bad in (0, 9, 16):
        with pytest.raises(ValueError, match="splits must lie"):
            tw.matmul_flat(x_i8, qt.codes, qt.scales, sx, tw.W_PAIRS, torch.float32, splits=bad)
        with pytest.raises(ValueError, match="splits must lie"):
            tw.matmul_actq(torch.from_numpy(x), qt.codes, qt.scales, tw.W_PAIRS, torch.float32,
                           splits=bad)


# (case, M, N, C, wfmt, splits on a 132-SM card)
@pytest.mark.parametrize("case,m,n,c,wfmt,want", [
    ("decode qkv", 128, 3072, E, tw.W_PAIRS, 8),
    ("decode o", 128, E, E, tw.W_PAIRS, 8),
    ("decode down", 128, E, I, tw.W_PAIRS, 8),
    ("decode int8 head", 128, V, E, tw.W_INT8, 1),
    ("prefill qkv", 16384, 3072, E, tw.W_PAIRS, 1),
    ("prefill o", 16384, E, E, tw.W_PAIRS, 1)])
def test_split_plan_flagship(case, m, n, c, wfmt, want):
    """B5's rule over the core's 128 x 64 tiles: split where the tiles
    leave SMs idle (B1 at decode), not where they fill the card."""
    s = tw.split_plan(m, n, c, 128, wfmt, SMS)
    assert s == want, case
    assert s <= tw.split_units(c, 128, wfmt)


@pytest.mark.parametrize("wfmt", [tw.W_INT8, tw.W_PAIRS, tw.W_HALVES])
@pytest.mark.parametrize("G", [1, 2, 5, 8, 9, 16, 64])
def test_split_units_and_bounds(wfmt, G):
    """A split takes whole groups (whole group pairs for pair planes); the
    splits cover the units in order and differ by at most one unit."""
    if wfmt == tw.W_PAIRS and G % 2:
        return
    g = 128
    units = tw.split_units(G * g, g, wfmt)
    assert units == (G // 2 if wfmt == tw.W_PAIRS else G)
    for s in (1, 2, 4, 8, 16):
        if s > units:
            continue
        bounds = tw.split_bounds(units, s)
        assert bounds[0][0] == 0 and bounds[-1][1] == units
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        sizes = [u1 - u0 for u0, u1 in bounds]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    for tiles in (1, 24, 48, 200):
        s = tw.split_plan(128, tiles * tw.TILE_N, G * g, g, wfmt, SMS)
        assert s & (s - 1) == 0 and s <= min(units, 16)


@pytest.mark.parametrize("c", [4096, 8192])
def test_actq_wide_rows_match_jax(c):
    """B9's wrapper takes the rows JAX takes (the card kernel quantizes each
    row once into scratch: no cap on C); on the CPU it runs the act
    quantizer and B3's plain version."""
    rng = np.random.default_rng(c + 1)
    jqt = jpack(jparse("int4-g[128]-rw"), jnp.asarray(rng.normal(size=(128, c)).astype(np.float32)))
    x = rng.normal(size=(M, c)).astype(np.float32)
    want = jax.jit(lambda a, q: jw.w4a8_matmul(a, q, act_inside=True))(jnp.asarray(x), jqt)
    tqt = qtensor_from_numpy(jax_to_numpy(jqt), "cpu")
    got = tw.w4a8_matmul(torch.from_numpy(x), tqt, act_inside=True)
    _close(want, got)
