"""Shared helpers for the calibration and pruning algorithms (port of
``algorithms/common.py``): slot paths, quantizer resolution (MPQ-aware,
with the algorithm's ``mse`` flag, the MSE clip search, applied as the JAX
package applies it), the sequential calibration groups and the lm_head's
RTN; a layer's params copied as the JAX version's ``tree_map(lambda x: x,
...)`` copies them, and the JAX package's float32 power.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import List

import torch

from ..capture.pipeline import SLOT_TAP
from ..models.config import ModelConfig
from ..models.transformer import op_names
from ..qformats.config import QuantConfig
from ..qformats.quantize import Quantizer, quantize_dequant

SLOT_PATH = {
    "q": ("attn", "q"), "k": ("attn", "k"), "v": ("attn", "v"), "o": ("attn", "o"),
    "qkv": ("attn", "qkv"),
    "gate": ("mlp", "gate"), "up": ("mlp", "up"), "down": ("mlp", "down"),
    "fc1": ("mlp", "fc1"), "fc2": ("mlp", "fc2"),
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


def get_bias(layer_params, slot: str):
    return _node(layer_params, slot).get("bias")


def set_bias(layer_params, slot: str, value) -> None:
    _node(layer_params, slot)["bias"] = value


def sequential_groups(cfg: ModelConfig) -> List[List[str]]:
    """The sequential calibration groups per family (reference
    ``get_sequential('true')``): each group's linears are calibrated on
    inputs that already see the earlier groups quantized."""
    if cfg.fused_qkv:
        return [["qkv"], ["o"], ["fc1"], ["fc2"]]
    if cfg.mlp_style == "gated":
        return [["k", "v", "q"], ["o"], ["up", "gate"], ["down"]]
    return [["k", "v", "q"], ["o"], ["fc1"], ["fc2"]]


def slot_tap(slot: str) -> str:
    return SLOT_TAP[slot]


def copy_tree(node):
    """The dicts and lists of a params tree copied, the tensors shared:
    ``set_weight`` on the copy leaves the original's entries as they were."""
    if isinstance(node, dict):
        return {k: copy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [copy_tree(v) for v in node]
    return node


def fpow(x: torch.Tensor, e: float) -> torch.Tensor:
    """``x ** e`` for a float32 ``x`` and a Python exponent, as the JAX
    package computes it: the exponent rounded to float32 (a weak-typed
    scalar), the power taken in float64 and rounded once. XLA's CPU power
    is within an ulp of that (it differs from it in 0.05 % of values where
    PyTorch's float32 ``pow`` differs in 1 %, measured on 10^5 values)."""
    e32 = float(torch.tensor(e, dtype=torch.float32))
    return (x.double() ** e32).float()


def _with_mse(q: Quantizer, mse: bool) -> Quantizer:
    """``q`` with its MSE flag set to the algorithm's (the reference's
    ``w_clip``), which overrides the config's."""
    if q.qtype != "dummy" and q.mse != mse:
        q = replace(q, mse=mse)
    return q


def weight_quantizer_for(cfg: ModelConfig, qcfg: QuantConfig, layer_idx: int,
                         slot: str, mse: bool = False) -> Quantizer:
    """The weight quantizer of a slot (MPQ overrides resolved by op name)."""
    return _with_mse(qcfg.for_op(op_names(cfg, layer_idx)[slot], "linear").weight, mse)


def head_quantizer(qcfg: QuantConfig, mse: bool = False) -> Quantizer:
    return _with_mse(qcfg.head.weight, mse)


def quantize_head_weight(params, qcfg: QuantConfig, mse: bool = False) -> None:
    """RTN-quantize the lm_head weight in place. With tied embeddings the
    shared table is quantized, as the reference's in-place update does."""
    q = head_quantizer(qcfg, mse)
    if q.qtype == "dummy":
        return
    key = "lm_head" if "lm_head" in params else "embed"
    params[key]["weight"] = quantize_dequant(q, params[key]["weight"])


class PhaseTimer:
    """Seconds per named phase, each ended by a device synchronize (the
    card runs ahead of the host). The calibration entry points take one as
    ``timings`` and add to it; pass none and nothing is synchronized."""

    def __init__(self):
        self.seconds: dict = {}

    def add(self, name: str, since: float, device: torch.device) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - since
        return now
