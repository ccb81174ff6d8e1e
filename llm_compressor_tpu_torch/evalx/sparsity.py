"""Model sparsity check (port of ``evalx/sparsity.py``; reference
utils/module.py:67-100): the share of exact zeros over every linear of the
layers, logged per layer at DEBUG and for the model at INFO."""

from __future__ import annotations

import logging

import torch

from ..algorithms.common import get_weight
from ..models.config import ModelConfig
from ..models.transformer import arch_slots

LOGGER = logging.getLogger(__name__)


def check_sparsity(params, cfg: ModelConfig, verbose: bool = True) -> float:
    count = 0
    total = 0
    for i, lp in enumerate(params["layers"]):
        sub_count, sub_total = 0, 0
        for slot in arch_slots(cfg):
            W = get_weight(lp, slot)
            sub_count += int(torch.sum(W == 0))
            sub_total += W.numel()
        if verbose:
            LOGGER.debug(f"Layer {i} sparsity : {sub_count / sub_total:.4f}")
        count += sub_count
        total += sub_total
    sparsity = count / total
    if verbose:
        LOGGER.info(f"Model sparsity : {sparsity:.4f}")
    return sparsity
