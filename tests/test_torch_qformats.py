"""The port's qformats against the JAX package on the same numpy inputs.

Tolerance: none. Packing, scales and fake quantization run the same f32
operations in the same order (true division by the group scale, round half
to even, clamp at +-qmax), so codes, scales and dequantized values are
bitwise equal to JAX. fp8 codes are compared as their uint8 bytes. The
scale solvers round as the JAX function they mirror runs: divided by the
constant where it runs eager (``quantize_dequant_with_params``,
``quantize_pack``), times its f32 reciprocal where it runs under
``jax.jit`` (``quantize_dequant``), as XLA rewrites that division.

One exception, a fault of the reference: on the CPU backend JAX's
``exp2`` is not exact at some integers (2**-13, 2**13, 2**15, ... come out
a few f32 ulps off), so its fp8 e5m2 fake quantization leaves the format's
grid for values whose exponent is -13, 13 or 15. The port scales by exact
powers of two. Those values are held to 2**-20 relative (and a tie there can
round the other way); every other format and exponent is bitwise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import qformats as jq
from llm_compressor_tpu.qformats import numerics as jnum
from llm_compressor_tpu.qformats.quantize import quantize_dequant_with_params as j_qdq
from llm_compressor_tpu_torch import qformats as tq
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.qformats import numerics as tnum
from llm_compressor_tpu_torch.qformats.quantize import quantize_dequant_with_params as t_qdq
from torch_port_util import jax_to_numpy, one_torch_thread  # noqa: F401

PACK_CASES = [
    # (spec, shape, expected pair-planes layout)
    ("int4-g[128]-rw", (256, 512), True),     # even group count: pair planes
    ("int4-g[128]-rw", (128, 384), False),    # odd group count: group halves
    ("int4-g[64]-rw", (64, 256), True),
    ("int8-g[128]-rw", (256, 512), False),
    ("int8-g[-1]-rw", (32, 96), False),
    ("int4-g[32]-rw", (64, 100), True),       # padded to 128: four groups
    ("int4-g[128]-zp-rw", (64, 256), True),   # asymmetric int4 with zeros
    ("int4-g[128]-zp-rw", (128, 384), False), # zeros, odd group count
    ("int8-g[128]-zp-rw", (128, 256), False),
    ("fp8_e4m3-g[128]-rw", (256, 512), False),
    ("fp8_e5m2-g[128]-rw", (256, 512), False),
    ("fp8_e4m3-g[128]-zp-rw", (64, 256), False),
    ("fp8_e4m3-g[-1]-rw", (64, 96), False),
    ("fp8_e5m2-g[32]-cw", (64, 48), False),
]


def _bytes(codes) -> np.ndarray:
    """Codes as numpy, fp8 (JAX ml_dtypes or torch) as their uint8 bytes."""
    if isinstance(codes, torch.Tensor):
        if codes.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            codes = codes.view(torch.uint8)
        return codes.numpy()
    a = np.asarray(codes)
    return a.view(np.uint8) if a.dtype.name.startswith("float8") else a


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("spec,shape,pairs", PACK_CASES)
def test_quantize_pack_bitwise(spec, shape, pairs):
    x = _x(shape)
    a = jq.quantize_pack(jq.parse_qspec(spec), jnp.asarray(x))
    b = tq.quantize_pack(tq.parse_qspec(spec), torch.from_numpy(x))
    assert a.pair_planes == b.pair_planes == pairs
    np.testing.assert_array_equal(_bytes(a.codes), _bytes(b.codes))
    np.testing.assert_array_equal(np.asarray(a.scales), b.scales.numpy())
    assert (a.zeros is None) == (b.zeros is None)
    if a.zeros is not None:
        np.testing.assert_array_equal(np.asarray(a.zeros), b.zeros.numpy())
    assert tuple(a.shape) == b.shape and tuple(a.blocked_shape) == b.blocked_shape
    np.testing.assert_array_equal(np.asarray(jq.dequantize(a)), tq.dequantize(b).numpy())
    if a.scales_t is not None:
        np.testing.assert_array_equal(np.asarray(a.scales_t), b.scales_t.numpy())


@pytest.mark.parametrize("spec,shape", [
    ("int8-g[-1]-rw", (3, 7, 64)), ("int8-g[-2]-rw", (2, 40, 16)),
    ("int4-g[128]-rw", (16, 256)), ("int8-g[16]-cw", (64, 8)),
    ("int8-g[0]-rw", (8, 8)), ("int4-g[-1]-zp-rw", (8, 32)),
    ("fp8_e4m3-g[128]-rw", (16, 256)), ("fp8_e4m3-g[0]-rw", (8, 64)),
    ("fp8_e4m3-g[32]-zp-rw", (16, 64)), ("fp4_e2m1-g[32]-rw", (16, 64)),
    ("fp4_e2m1-g[16]-zp-cw", (32, 8)),
])
def test_quantize_dequant_bitwise(spec, shape):
    x = _x(shape, seed=1)
    a, (sa, za) = j_qdq(jq.parse_qspec(spec), jnp.asarray(x))
    b, (sb, zb) = t_qdq(tq.parse_qspec(spec), torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(sa), sb.numpy())


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("spec", ["int8-g[-1]-rw", "int4-g[128]-rw", "int4-g[128]-zp-rw",
                                  "int8-g[128]-rw", "fp8_e4m3-g[128]-rw"])
def test_quantize_dequant_jit_bitwise(spec, dtype):
    """The port's ``quantize_dequant`` against the jitted JAX one
    (``@jax.jit``) on 512 x 2048 rows; eager rounding would put many group
    scales one f32 ulp off (ROADMAP C1)."""
    x = jnp.asarray(_x((512, 2048), seed=5)).astype(dtype)
    a = np.asarray(jq.quantize_dequant(jq.parse_qspec(spec), x).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.float32 if dtype == np.float32 else torch.bfloat16)
    b = tq.quantize_dequant(tq.parse_qspec(spec), xt)
    assert b.dtype == xt.dtype
    np.testing.assert_array_equal(a, b.float().numpy())


@pytest.mark.parametrize("spec", ["int4-g[128]-rw", "int8-g[-1]-rw", "int8-g[-2]-cw",
                                  "int4-g[32]-zp-rw", "mxint4-g[32]-rw",
                                  "fp8_e4m3-g[0]-rw", "nvfp4_e2m1-g[16]-rw", None])
def test_parse_qspec_matches(spec):
    a, b = jq.parse_qspec(spec), tq.parse_qspec(spec)
    assert (a.qtype, a.group_size, a.axes, a.zero_point, a.eff_axes) == \
        (b.qtype, b.group_size, b.axes, b.zero_point, b.eff_axes)
    assert (a.fmt is None and b.fmt is None) or a.fmt.value == b.fmt.value
    if spec is not None:
        assert tq.qspec_string(b) == spec


def test_build_quant_config_slots():
    args = ("int4-g[128]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw")
    a = jq.build_quant_config(*args, head_act="int8-g[-1]-rw")
    b = tq.build_quant_config(*args, head_act="int8-g[-1]-rw")
    for slot in ("linear", "matmul", "head"):
        for part in ("weight", "act_in", "act_out"):
            qa, qb = getattr(getattr(a, slot), part), getattr(getattr(b, slot), part)
            assert qa.qtype == qb.qtype and qa.group_size == qb.group_size
    assert b.for_op("layers.0.self_attn.q_proj") == b.linear
    assert b.for_op("lm_head", "head") == b.head


@pytest.mark.parametrize("spec", ["nvfp4_e2m1-g[16]-rw", "mxint4-g[32]-rw"])
def test_float_formats_not_ported_yet(spec):
    """Once refused, the MX and NVFP4 quantizers now run: the port's
    ``quantize_dequant`` equals the jitted JAX one bitwise (the formats'
    own tests are in test_torch_formats.py)."""
    x = _x((64, 256), seed=6)
    a = np.asarray(jq.quantize_dequant(jq.parse_qspec(spec), jnp.asarray(x)))
    b = tq.quantize_dequant(tq.parse_qspec(spec), torch.from_numpy(x))
    np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("spec", ["fp4_e2m1-g[32]-rw", "fp4_e2m1-g[16]-zp-cw"])
def test_fp4_codes_not_packed_yet(spec):
    """Once refused, fp4 codes now pack: the same bytes, scales and zeros as
    the JAX package, and ``dequantize`` gives its values bitwise."""
    x = _x((32, 64), seed=7)
    a = jq.quantize_pack(jq.parse_qspec(spec), jnp.asarray(x))
    b = tq.quantize_pack(tq.parse_qspec(spec), torch.from_numpy(x))
    assert b.codes.dtype == torch.uint8 and not b.pair_planes
    np.testing.assert_array_equal(np.asarray(a.codes), b.codes.numpy())
    np.testing.assert_array_equal(np.asarray(a.scales), b.scales.numpy())
    np.testing.assert_array_equal(np.asarray(a.zeros), b.zeros.numpy())
    np.testing.assert_array_equal(np.asarray(jq.dequantize(a)), tq.dequantize(b).numpy())


# powers of two and their f32 neighbours (the exponent's edge cases), ties
# of every format's grid, zeros, inf / nan and an f32 subnormal
_E = np.arange(-30, 30)
_P2 = (2.0 ** _E).astype(np.float32)
_EDGES = np.concatenate([_P2, np.nextafter(_P2, 0), np.nextafter(_P2, np.inf),
                         _P2 * 1.125, _P2 * 1.0625, _P2 * 1.5]).astype(np.float32)
_SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, 0.49999997, 2.5], np.float32)


def _elemwise_inputs():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(size=20000) * s for s in (1e-3, 0.1, 1.0, 30.0, 400.0)])
    return np.concatenate([x.astype(np.float32), _EDGES, -_EDGES, _SPECIAL])


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2", "fp4_e2m1"])
@pytest.mark.parametrize("rnd", ["nearest", "even"])
@pytest.mark.parametrize("saturate", [True, False])
def test_quantize_elemwise_bitwise(fmt, rnd, saturate):
    x = _elemwise_inputs()
    run = lambda v: jnum.quantize_elemwise(v, jq.format_params(fmt), round=rnd,
                                           saturate_normals=saturate)
    a = np.asarray(jax.jit(run)(jnp.asarray(x)))
    assert np.array_equal(a, np.asarray(run(jnp.asarray(x))), equal_nan=True)  # eager = jit
    b = tnum.quantize_elemwise(torch.from_numpy(x), tq.format_params(fmt), round=rnd,
                               saturate_normals=saturate).numpy()
    if fmt == "fp8_e5m2":
        # JAX's inexact exp2 at exponents -13, 13, 15 (see the module doc)
        fin = np.isfinite(x) & (x != 0)
        e = np.full(x.shape, -14.0)
        e[fin] = np.maximum(np.floor(np.log2(np.abs(x[fin].astype(np.float64)))), -14)
        off = np.isin(e, (-13, 13, 15))
        with np.errstate(invalid="ignore"):
            shifted = np.abs(x.astype(np.float64)) / 2.0 ** e * 4.0   # 2**(mbits - 2)
            tie = off & (shifted - np.floor(shifted) == 0.5)
        np.testing.assert_allclose(a[off & ~tie], b[off & ~tie], rtol=2.0 ** -20)
        # at a tie the port rounds exactly (the JAX value may sit a step away)
        exact = np.ceil(shifted[tie]) if rnd == "nearest" else np.round(shifted[tie])
        np.testing.assert_array_equal(np.abs(b[tie]), exact / 4.0 * 2.0 ** e[tie])
        a, b = a[~off], b[~off]
    np.testing.assert_array_equal(a, b)


def test_round_helpers_match_jax():
    x = np.concatenate([_elemwise_inputs()[np.isfinite(_elemwise_inputs())],
                        np.arange(-8, 8, 0.25, dtype=np.float32)]).astype(np.float32)
    x = x[np.abs(x) < 1e7]
    for name in ("round_half_away", "round_half_even", "round_floor"):
        a = np.asarray(getattr(jnum, name)(jnp.asarray(x)))
        b = getattr(tnum, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("spec", ["fp8_e4m3-g[128]-rw", "fp8_e5m2-g[128]-rw",
                                  "int4-g[128]-zp-rw", "int8-g[128]-zp-rw"])
def test_convert_carries_fp8_and_zeros(spec):
    """A JAX QTensor handed over as numpy arrives with the same bytes,
    scales and zeros, and dequantizes to the same values."""
    x = _x((128, 256), seed=4)
    a = jq.quantize_pack(jq.parse_qspec(spec), jnp.asarray(x))
    b = params_from_numpy({"w": jax_to_numpy(a)}, device="cpu")["w"]
    assert b.codes.dtype == tq.quantize_pack(tq.parse_qspec(spec), torch.from_numpy(x)).codes.dtype
    np.testing.assert_array_equal(_bytes(a.codes), _bytes(b.codes))
    np.testing.assert_array_equal(np.asarray(a.zeros), b.zeros.numpy())
    np.testing.assert_array_equal(np.asarray(jq.dequantize(a)), tq.dequantize(b).numpy())
