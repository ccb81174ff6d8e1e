"""qformats — numeric formats, quantizer specs, packed tensors (port of
``llm_compressor_tpu.qformats``)."""

from .blocking import BlockMeta, block, resolve_group, unblock
from .config import (
    OpQuantConfig,
    QuantConfig,
    build_quant_config,
    parse_qspec,
    qspec_string,
)
from .formats import ElemFormat, FormatParams, format_params
from .quantize import (
    Quantizer,
    fake_quantize_blocked,
    find_params,
    find_params_blocked,
    quantize_dequant,
    quantize_dequant_with_params,
)
from .qtensor import QTensor, dequantize, pair_planes_for, quantize_pack

__all__ = [
    "BlockMeta", "block", "unblock", "resolve_group",
    "ElemFormat", "FormatParams", "format_params",
    "Quantizer", "find_params", "find_params_blocked",
    "fake_quantize_blocked", "quantize_dequant", "quantize_dequant_with_params",
    "QTensor", "quantize_pack", "dequantize", "pair_planes_for",
    "OpQuantConfig", "QuantConfig", "build_quant_config", "parse_qspec",
    "qspec_string",
]
