"""The port's qformats against the JAX package on the same numpy inputs.

Tolerance: none. Packing, scales and fake quantization run the same f32
operations in the same order (true division by the group scale, round half
to even, clamp at +-qmax), so codes, scales and dequantized values are
bitwise equal to eager JAX.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import qformats as jq
from llm_compressor_tpu.qformats.quantize import quantize_dequant_with_params as j_qdq
from llm_compressor_tpu_torch import qformats as tq
from llm_compressor_tpu_torch.qformats.quantize import quantize_dequant_with_params as t_qdq
from torch_port_util import one_torch_thread  # noqa: F401

PACK_CASES = [
    # (spec, shape, expected pair-planes layout)
    ("int4-g[128]-rw", (256, 512), True),     # even group count: pair planes
    ("int4-g[128]-rw", (128, 384), False),    # odd group count: group halves
    ("int4-g[64]-rw", (64, 256), True),
    ("int8-g[128]-rw", (256, 512), False),
    ("int8-g[-1]-rw", (32, 96), False),
    ("int4-g[32]-rw", (64, 100), True),       # padded to 128: four groups
    ("int4-g[128]-zp-rw", (64, 256), True),   # asymmetric int4 with zeros
]


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("spec,shape,pairs", PACK_CASES)
def test_quantize_pack_bitwise(spec, shape, pairs):
    x = _x(shape)
    a = jq.quantize_pack(jq.parse_qspec(spec), jnp.asarray(x))
    b = tq.quantize_pack(tq.parse_qspec(spec), torch.from_numpy(x))
    assert a.pair_planes == b.pair_planes == pairs
    np.testing.assert_array_equal(np.asarray(a.codes), b.codes.numpy())
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
])
def test_quantize_dequant_bitwise(spec, shape):
    x = _x(shape, seed=1)
    a, (sa, za) = j_qdq(jq.parse_qspec(spec), jnp.asarray(x))
    b, (sb, zb) = t_qdq(tq.parse_qspec(spec), torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(sa), sb.numpy())


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


@pytest.mark.parametrize("spec", ["fp8_e4m3-g[0]-rw", "mxint4-g[32]-rw"])
def test_float_formats_not_ported_yet(spec):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tq.quantize_dequant(tq.parse_qspec(spec), torch.ones(4, 32))
