"""Split-K of B2, the fused W4A8 gate|up + activation, on the CPU: the plain
version summed in splits, the split plan over B2's tiles, and the wrapper
at forced splits against the JAX kernel (Pallas in interpret mode) on the
same numpy inputs.

Tolerances:
* splits against one split, per half: the same f32 terms
  float(x_g . w_g) * s_g added in another order, so a half's sum times sx
  differs by at most t = 2 G 2**-24 sx sum_g |term_g| plus one f32
  rounding of the output (``test_torch_w4a8_split.py``'s bound);
* the output h = act(g) * u (f32 out): every activation here has a slope
  of at most 1.2 in magnitude, so |dh| <= 1.2 t_g (|u| + t_u) +
  (|act(g)| + 1.2 t_g) t_u, plus 2**-20 of |act(g)| |u| for the f32
  activation and product on both sides;
* against JAX: ``_close`` of ``test_torch_w4a8.py`` (a few f32 ulps of the
  output's magnitude).
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
from llm_compressor_tpu_torch.qformats import parse_qspec, quantize_pack
from torch_port_util import jax_to_numpy, one_torch_thread  # noqa: F401

jw = importlib.import_module("llm_compressor_tpu.kernels.w4a8_matmul")
M, I = 8, 256
SMS = 132   # an H100 SXM
E, INTER = 2048, 8192   # Llama-3.2-1B widths
ACTS = ["silu", "gelu", "gelu_pytorch_tanh"]
# units: int8 8 groups, pair planes 8 group pairs, group halves 9 groups
LAYOUTS = [("int8-g[128]-rw", 1024, tw.W_INT8), ("int4-g[128]-rw", 2048, tw.W_PAIRS),
           ("int4-g[128]-rw", 1152, tw.W_HALVES)]


def _close(a, b):
    a, b = np.asarray(a), b.numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * np.abs(a).max())


@functools.lru_cache(maxsize=None)
def _port_case(spec, c):
    """[gate | up] codes and scales of a (2I, c) weight packed by the port,
    and the per-token int8 acts of x (M, c)."""
    rng = np.random.default_rng(c)
    qt = quantize_pack(parse_qspec(spec),
                       torch.from_numpy(rng.normal(size=(2 * I, c)).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(M, c)).astype(np.float32))
    x_i8, sx = tw.quantize_acts_per_token(x)
    return qt, x_i8, sx


def _half_bound(x_i8, codes, scales, sx, wfmt, one):
    """The reordering bound of one half's f32 sum times sx (module doc)."""
    G = scales.shape[1]
    g = x_i8.shape[1] // G
    w = tw._int_weights(codes, G, wfmt).double().abs()
    xa = x_i8.double().abs()
    mag = sum((xa[:, k * g:(k + 1) * g] @ w[:, k * g:(k + 1) * g].T) * scales[:, k].double()
              for k in range(G))
    return 2 * G * 2.0 ** -24 * mag * sx.double() + 2.0 ** -23 * one.double().abs()


@pytest.mark.parametrize("spec,c,wfmt", LAYOUTS)
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("act", ACTS)
def test_gateup_plain_splits(spec, c, wfmt, splits, act):
    qt, x_i8, sx = _port_case(spec, c)
    assert tw._wfmt(qt) == wfmt
    codes, scales = qt.codes, qt.scales
    f32 = torch.float32
    got = tw.gateup_plain(x_i8, codes, scales, sx, wfmt, act, f32, splits=splits)
    one = tw.gateup_plain(x_i8, codes, scales, sx, wfmt, act, f32, splits=1)
    assert torch.equal(one, tw.gateup_plain(x_i8, codes, scales, sx, wfmt, act, f32))
    halves = []
    for rows in (slice(0, I), slice(I, 2 * I)):
        hs = tw._scaled_sum(x_i8, codes[rows], scales[rows], wfmt, splits) * sx
        h1 = tw._scaled_sum(x_i8, codes[rows], scales[rows], wfmt) * sx
        t = _half_bound(x_i8, codes[rows], scales[rows], sx, wfmt, h1)
        assert bool(((hs.double() - h1.double()).abs() <= t).all())
        halves.append((hs, h1, t))
    (gs, g1, tg), (us, u1, tu) = halves
    # the split sums go through B2's epilogue as they are
    assert torch.equal(got, tw._activation(act, gs) * us)
    a1 = tw._activation(act, g1).double().abs()
    ua = u1.double().abs()
    tol = 1.2 * tg * (ua + tu) + (a1 + 1.2 * tg) * tu + 2.0 ** -20 * a1 * ua
    assert bool(((got.double() - one.double()).abs() <= tol).all())
    if splits == 1:
        assert torch.equal(got, one)
    # the wrapper on CPU tensors runs the plain version at the split count asked for
    assert torch.equal(tw.gateup_silu(x_i8, codes[None], scales[None], sx, 0, wfmt, act, f32,
                                      splits=splits), got)


@functools.lru_cache(maxsize=None)
def _jax_case(spec, c, act):
    """Stacked JAX [gate | up] weights (2 layers), x, and JAX's fused
    gate|up output of layer 1 under ``jit``."""
    rng = np.random.default_rng(c + 3)
    qts = [jpack(jparse(spec), jnp.asarray(rng.normal(size=(2 * I, c)).astype(np.float32)))
           for _ in range(2)]
    jqt = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qts)
    x = rng.normal(size=(M, c)).astype(np.float32)
    want = jax.jit(lambda a, q: jw.gateup_silu_matmul(a, q, act, jnp.int32(1)))(jnp.asarray(x),
                                                                                jqt)
    return qtensor_from_numpy(jax_to_numpy(jqt), "cpu"), x, np.asarray(want)


# int8 4 groups, pair planes 4 group pairs, group halves 5 groups
@pytest.mark.parametrize("spec,c,wfmt", [("int8-g[128]-rw", 512, tw.W_INT8),
                                         ("int4-g[128]-rw", 1024, tw.W_PAIRS),
                                         ("int4-g[128]-rw", 640, tw.W_HALVES)])
@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("act", ACTS)
def test_gateup_splits_match_jax(spec, c, wfmt, splits, act):
    """B2 at a forced split count (its plain version on CPU tensors, as the
    card's kernel sums) against the JAX kernel."""
    tqt, x, want = _jax_case(spec, c, act)
    assert tw._wfmt(tqt) == wfmt
    x_i8, sx = tw.quantize_acts_per_token(torch.from_numpy(x))
    got = tw.gateup_silu(x_i8, tqt.codes, tqt.scales, sx, 1, wfmt, act, torch.float32,
                         splits=splits)
    _close(want, got)
    # and the entry point (one split on the CPU) agrees with JAX too
    _close(want, tw.gateup_silu_matmul(torch.from_numpy(x), tqt, act, 1))


# (case, M, I, C, wfmt, splits on a 132-SM card)
@pytest.mark.parametrize("case,m,i,c,wfmt,want", [
    ("decode gate|up", 128, INTER, E, tw.W_PAIRS, 1),
    ("prefill gate|up", 16384, INTER, E, tw.W_PAIRS, 1),
    ("decode, I = 384", 128, 384, E, tw.W_PAIRS, 8),
    ("decode, int8, I = 1024", 128, 1024, E, tw.W_INT8, 8),
    ("decode, group halves, I = 2048", 40, 2048, 1152, tw.W_HALVES, 4)])
def test_gateup_split_plan_flagship(case, m, i, c, wfmt, want):
    """B5's rule over B2's tiles, 128 x rows by 64 [gate | up] weight rows
    (128 x 32 outputs): 256 tiles at the flagship decode fill 1.5 x 132 SMs
    unsplit; small I splits."""
    s = tw.split_plan(m, 2 * i, c, 128, wfmt, SMS)
    assert s == want, case
    assert s <= tw.split_units(c, 128, wfmt)


def test_gateup_forced_splits_outside_the_units_raise():
    qt, x_i8, sx = _port_case("int4-g[128]-rw", 2048)   # 8 group pairs
    for bad in (0, 9, 16):
        with pytest.raises(ValueError, match="splits must lie"):
            tw.gateup_silu(x_i8, qt.codes[None], qt.scales[None], sx, 0, tw.W_PAIRS, "silu",
                           torch.float32, splits=bad)
