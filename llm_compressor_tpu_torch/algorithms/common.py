"""Shared helpers for the weight-quantization algorithms (port of
``algorithms/common.py``): slot paths and quantizer resolution."""

from __future__ import annotations

from ..models.config import ModelConfig
from ..models.transformer import op_names
from ..qformats.config import QuantConfig
from ..qformats.quantize import Quantizer, quantize_dequant

SLOT_PATH = {
    "q": ("attn", "q"), "k": ("attn", "k"), "v": ("attn", "v"), "o": ("attn", "o"),
    "gate": ("mlp", "gate"), "up": ("mlp", "up"), "down": ("mlp", "down"),
}


def _node(layer_params, slot: str):
    node = layer_params
    for k in SLOT_PATH[slot]:
        node = node[k]
    return node


def get_weight(layer_params, slot: str):
    return _node(layer_params, slot)["weight"]


def set_weight(layer_params, slot: str, value) -> None:
    _node(layer_params, slot)["weight"] = value


def weight_quantizer_for(cfg: ModelConfig, qcfg: QuantConfig, layer_idx: int,
                         slot: str) -> Quantizer:
    """The weight quantizer of a slot."""
    return qcfg.for_op(op_names(cfg, layer_idx)[slot], "linear").weight


def quantize_head_weight(params, qcfg: QuantConfig) -> None:
    """RTN-quantize the lm_head weight in place. With tied embeddings the
    shared table is quantized, as the reference's in-place update does."""
    q = qcfg.head.weight
    if q.qtype == "dummy":
        return
    key = "lm_head" if "lm_head" in params else "embed"
    params[key]["weight"] = quantize_dequant(q, params[key]["weight"])
