"""qformats — numeric formats, quantizer specs, packed tensors (port of
``llm_compressor_tpu.qformats``)."""

from .blocking import BlockMeta, block, resolve_group, unblock
from .config import (
    OpQuantConfig,
    QuantConfig,
    build_quant_config,
    parse_qspec,
    qspec_string,
    register_4_to_8bit,
    register_8_to_4bit,
    register_org_config,
)
from .formats import ElemFormat, FormatParams, format_params
from .numerics import quantize_elemwise
from .quantize import (
    Quantizer,
    fake_quantize_blocked,
    find_params,
    find_params_blocked,
    quantize_dequant,
    quantize_dequant_with_params,
)
from .qtensor import QTensor, dequantize, pair_planes_for, quantize_pack, to_group_halves

__all__ = [
    "BlockMeta", "block", "unblock", "resolve_group",
    "ElemFormat", "FormatParams", "format_params", "quantize_elemwise",
    "Quantizer", "find_params", "find_params_blocked",
    "fake_quantize_blocked", "quantize_dequant", "quantize_dequant_with_params",
    "QTensor", "quantize_pack", "dequantize", "pair_planes_for", "to_group_halves",
    "OpQuantConfig", "QuantConfig", "build_quant_config", "parse_qspec",
    "qspec_string", "register_4_to_8bit", "register_8_to_4bit", "register_org_config",
]
