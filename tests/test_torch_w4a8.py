"""The plain versions of kernels B1/B2/B3/B9 against the JAX W4A8 kernels
(Pallas in interpret mode on the CPU), on the same numpy inputs.

Tolerance: the int32 per-group dots are exact on both sides; the f32 sums
differ. The JAX pair-planes path adds a +8 bias into the even groups' dots
and subtracts 8 * (rowsum @ scales) at the end of each K block, and sums
groups within a K block before adding blocks, so outputs agree to a few
f32 ulps of the output's magnitude: atol = 1e-5 * max|y|, rtol = 1e-5.
The JAX side runs under ``jax.jit``, as serving runs it, so the per-token
act codes are equal (XLA multiplies by the f32 reciprocal of 127 there, as
the port does).
"""

import importlib
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu.qformats import parse_qspec as jparse, quantize_pack as jpack
from llm_compressor_tpu_torch.convert import qtensor_from_numpy
from llm_compressor_tpu_torch.kernels import w4a8_matmul as tw
from llm_compressor_tpu_torch.models import layers as tl
from llm_compressor_tpu_torch.qformats import parse_qspec as tparse
from torch_port_util import jax_to_numpy, one_torch_thread  # noqa: F401

# the package re-exports a function under the module's name
jw = importlib.import_module("llm_compressor_tpu.kernels.w4a8_matmul")
jl = importlib.import_module("llm_compressor_tpu.models.layers")
C, N = 512, 256


def _weights(spec, n, c, seed, stack=1):
    rng = np.random.default_rng(seed)
    qts = [jpack(jparse(spec), jnp.asarray(rng.normal(size=(n, c)).astype(np.float32)))
           for _ in range(stack)]
    if stack == 1:
        return qts[0]
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qts)


def _x(m, c, seed=7):
    return np.random.default_rng(seed).normal(size=(m, c)).astype(np.float32)


def _close(a, b):
    a, b = np.asarray(a), b.numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * np.abs(a).max())


@pytest.mark.parametrize("M", [8, 40])
@pytest.mark.parametrize("spec,c", [("int4-g[128]-rw", C), ("int4-g[128]-rw", 384),
                                    ("int8-g[128]-rw", C)])
def test_flat_matches_jax(M, spec, c):
    jqt = _weights(spec, N, c, seed=M)
    x = _x(M, c)
    want = jax.jit(jw.w4a8_matmul)(jnp.asarray(x), jqt)
    tqt = qtensor_from_numpy(jax_to_numpy(jqt), "cpu")
    got = tw.w4a8_matmul(torch.from_numpy(x), tqt)
    _close(want, got)


@pytest.mark.parametrize("M", [8, 40])
@pytest.mark.parametrize("layer", [0, 1])
def test_stacked_matches_jax(M, layer):
    jqt = _weights("int4-g[128]-rw", N, C, seed=11, stack=2)
    x = _x(M, C)
    want = jax.jit(lambda a, q: jw.w4a8_matmul(a, q, layer=jnp.int32(layer)))(jnp.asarray(x), jqt)
    tqt = qtensor_from_numpy(jax_to_numpy(jqt), "cpu")
    got = tw.w4a8_matmul(torch.from_numpy(x), tqt, layer=layer)
    _close(want, got)


@pytest.mark.parametrize("M", [8, 40])
@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_pytorch_tanh"])
def test_gateup_matches_jax(M, act):
    jqt = _weights("int4-g[128]-rw", 2 * N, C, seed=5, stack=2)
    x = _x(M, C)
    want = jax.jit(lambda a, q: jw.gateup_silu_matmul(a, q, act, jnp.int32(1)))(jnp.asarray(x), jqt)
    tqt = qtensor_from_numpy(jax_to_numpy(jqt), "cpu")
    got = tw.gateup_silu_matmul(torch.from_numpy(x), tqt, act, 1)
    _close(want, got)


@pytest.mark.parametrize("M", [8, 40])
@pytest.mark.parametrize("spec,c", [("int4-g[128]-rw", C), ("int4-g[128]-rw", 384),
                                    ("int8-g[128]-rw", C)])
def test_act_inside_matches_jax(M, spec, c):
    """B9's plain version (the act quantizer, then B3's) against the JAX
    kernel with the quantizer inside, ``w4a8_matmul(act_inside=True)``;
    C = 512 packs int4 as pair planes, C = 384 (3 groups) as group halves."""
    jqt = _weights(spec, N, c, seed=M + 1)
    x = _x(M, c, seed=M)
    want = jax.jit(lambda a, q: jw.w4a8_matmul(a, q, act_inside=True))(jnp.asarray(x), jqt)
    tqt = qtensor_from_numpy(jax_to_numpy(jqt), "cpu")
    got = tw.w4a8_matmul(torch.from_numpy(x), tqt, act_inside=True)
    _close(want, got)
    # the entry point's plain route is the quantizer followed by B3's plain version
    assert torch.equal(got, tw.w4a8_matmul(torch.from_numpy(x), tqt))


def test_act_inside_bf16_matches_jax():
    """bf16 acts in, bf16 out: one bf16 ulp of the output (the f32 sums may
    round to neighbouring bf16 values)."""
    jqt = _weights("int4-g[128]-rw", N, C, seed=3)
    x = np.asarray(jnp.asarray(_x(40, C), jnp.bfloat16))
    want = jax.jit(lambda a, q: jw.w4a8_matmul(a, q, act_inside=True))(jnp.asarray(x), jqt)
    tqt = qtensor_from_numpy(jax_to_numpy(jqt), "cpu")
    got = tw.w4a8_matmul(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16), tqt,
                         act_inside=True)
    assert got.dtype == torch.bfloat16
    a = np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), a, rtol=2.0 ** -8, atol=1e-5 * np.abs(a).max())


@pytest.mark.parametrize("groups", [16, 48])
@pytest.mark.parametrize("M", [256, 257, 1024, 3072, 3073, 24576])
@pytest.mark.parametrize("stack", [1, 2], ids=["flat", "stacked"])
def test_w4a8_route(M, groups, stack):
    """qlinear's route to the W4A8 kernels (``w4a8_route``) over a weight of
    C/g = ``groups`` K groups of 128 (48: Qwen3's down). On the CPU it is
    the JAX package's rule, read from its own helpers, case for case: a
    QTensor with int8 per-token acts, ``supported``, then M <= 256 or C/g
    <= 16; a LayerSlice read in place (B1) at M <= 256 only. On the card M
    up to ``CARD_W4A8_ROWS`` takes the kernels at any C/g: a down-like
    weight at M = 1024 does, at 24576 rows (Qwen3's prefill group) it does
    not; above the limit a LayerSlice is never read in place. Other acts
    never take the kernels."""
    jqt = _weights("int4-g[128]-rw", 128, 128 * groups, seed=groups, stack=stack)
    tqt = qtensor_from_numpy(jax_to_numpy(jqt), "cpu")
    ai = tparse("int8-g[-1]-rw")
    jax_flat = jw.supported(jqt) and (M <= 256 or jl._w4a8_kgroups(jqt) <= 16)
    jax_in_place = jw.supported(jqt) and M <= 256
    assert tl.w4a8_route(ai, tqt, M, on_card=False) == jax_flat
    assert tl.w4a8_route(ai, tqt, M, on_card=False, in_place=True) == jax_in_place
    assert tl.w4a8_route(ai, tqt, M, on_card=True) == (M <= tl.CARD_W4A8_ROWS or groups <= 16)
    assert tl.w4a8_route(ai, tqt, M, on_card=True, in_place=True) == (M <= tl.CARD_W4A8_ROWS)
    assert 1024 <= tl.CARD_W4A8_ROWS < 9216
    for other in (None, tparse("int8-g[128]-rw"), tparse("int4-g[-1]-rw")):
        for on_card, in_place in itertools.product((False, True), repeat=2):
            assert not tl.w4a8_route(other, tqt, M, on_card=on_card, in_place=in_place)


@pytest.mark.parametrize("M,groups,want", [
    (256, 16, 1), (257, 16, None), (256, 48, 1), (257, 48, "dense")])
def test_qlinear_cpu_layer_slice_routes(monkeypatch, M, groups, want):
    """On the CPU ``qlinear`` sends a LayerSlice as the JAX package does:
    B1 on the layer in place at M <= 256; above, the layer's view on B3 at
    C/g <= 16 K groups, else dequantization + ``torch.matmul``."""
    from llm_compressor_tpu_torch.qformats import build_quant_config

    jqt = _weights("int4-g[128]-rw", 128, 128 * groups, seed=groups, stack=2)
    tqt = qtensor_from_numpy(jax_to_numpy(jqt), "cpu")
    op = build_quant_config("int4-g[128]-rw", "int8-g[-1]-rw", None, None).linear
    seen = []

    def spy(x, qt, bias=None, layer=None, **kw):
        seen.append(layer)
        return torch.zeros(*x.shape[:-1], tl.wm.weight_dims(qt)[0], dtype=x.dtype)

    monkeypatch.setattr(tl.wm, "w4a8_matmul", spy)
    x = torch.randn(M, 128 * groups, generator=torch.Generator().manual_seed(M))
    y = tl.qlinear(x.to(torch.bfloat16), tl.LayerSlice(tqt, 1), None, op, slot="down")
    assert seen == ([] if want == "dense" else [want]) and y.shape == (M, 128)


def test_act_quant_bitwise():
    """Against the jitted JAX quantizer, as serving runs it (XLA multiplies
    by the f32 reciprocal of 127 there): 1024 bf16 rows of width 2048."""
    x = np.asarray(jnp.asarray(_x(1024, 2048), jnp.bfloat16))
    qa, sa = jax.jit(jw.quantize_acts_per_token)(jnp.asarray(x))
    qb, sb = tw.quantize_acts_per_token(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))
    np.testing.assert_array_equal(np.asarray(sa), sb.numpy())
    np.testing.assert_array_equal(np.asarray(qa), qb.numpy())


def test_wrapper_checks_inputs():
    x_i8 = torch.zeros((4, C), dtype=torch.int8)
    codes = torch.zeros((N, C // 2), dtype=torch.uint8)
    scales = torch.ones((N, C // 128))
    sx = torch.ones((4, 1))
    with pytest.raises(ValueError, match="codes must be"):
        tw.matmul_flat(x_i8, codes, scales, sx, tw.W_INT8, torch.float32)
    with pytest.raises(ValueError, match="stacked"):
        tw.matmul_stacked(x_i8, codes, scales, sx, 0, tw.W_PAIRS, torch.float32)
    with pytest.raises(ValueError, match="multiple of 128"):
        tw.matmul_flat(x_i8, codes, torch.ones((N, 8)), sx, tw.W_PAIRS, torch.float32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tw.matmul_actq(x_i8, codes, scales, tw.W_PAIRS, torch.float32)
    with pytest.raises(ValueError, match="2-D codes"):
        tw.matmul_actq(x_i8.float(), codes[None], scales[None], tw.W_PAIRS, torch.float32)
