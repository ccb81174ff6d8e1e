"""RIA pruning: relative importance with activation scaling (port of
``algorithms/ria.py``).

Reference: pruning/ria/core.py:22-145. Metric (|W| / colsum + |W| / rowsum)
* sqrt(scaler_row) ** alpha, thresholded over the whole linear: entries at
or below the k-th smallest, k = int(size * ratio), are zeroed (ties prune
more than k). The pruned layer's outputs are the next layer's inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..capture.pipeline import CalibContext, accumulate_scaler_rows, advance
from ..device import full_f32_matmul
from ..models.config import ModelConfig
from ..models.transformer import arch_slots, layer_ops
from ..qformats.config import QuantConfig
from .common import fpow, get_weight, set_weight, slot_tap


def _prune_ria(W, scaler_row, sparsity_ratio: float, alpha: float):
    aw = torch.abs(W).float()
    metric = (aw / torch.sum(aw, dim=0)[None, :] + aw / torch.sum(aw, dim=1)[:, None]) * (
        fpow(torch.sqrt(scaler_row), alpha)[None, :])
    k = int(W.numel() * sparsity_ratio)
    thresh = torch.sort(metric.reshape(-1)).values[k]
    return torch.where(metric <= thresh, torch.zeros_like(W), W)


@full_f32_matmul()
@torch.no_grad()
def ria(params, cfg: ModelConfig, ctx: CalibContext, sparsity_ratio: float,
        alpha: float = 0.5, qcfg: Optional[QuantConfig] = None, verbose: bool = True) -> None:
    """Prune every linear in place; ``ctx`` is advanced through the pruned
    layers."""
    slots = arch_slots(cfg)
    taps = tuple(dict.fromkeys(slot_tap(s) for s in slots))
    for i, lp in enumerate(params["layers"]):
        ops = layer_ops(cfg, qcfg, i)
        scaler = accumulate_scaler_rows(ctx, lp, i, taps, ops)
        for slot in slots:
            W = get_weight(lp, slot)
            set_weight(lp, slot, _prune_ria(W, scaler[slot_tap(slot)], sparsity_ratio, alpha))
        advance(ctx, lp, i, ops)
