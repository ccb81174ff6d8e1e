"""Magnitude pruning: data-free unstructured sparsity (port of
``algorithms/magnitude.py``).

Reference: pruning/magnitude/core.py:17-52. Per linear: the threshold is
the k-th smallest |W| over the whole matrix, k = int(size * ratio), and
every entry at or below it is zeroed (ties prune more than k).
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.transformer import arch_slots
from .common import get_weight, set_weight


@torch.no_grad()
def magnitude(params, cfg: ModelConfig, sparsity_ratio: float, verbose: bool = True) -> None:
    """Prune every linear in place. ``verbose`` is the JAX signature's and
    logs nothing here."""
    for lp in params["layers"]:
        for slot in arch_slots(cfg):
            W = get_weight(lp, slot)
            metric = torch.abs(W)
            k = int(W.numel() * sparsity_ratio)
            thresh = torch.sort(metric.reshape(-1)).values[k]
            set_weight(lp, slot, torch.where(metric <= thresh, torch.zeros_like(W), W))
