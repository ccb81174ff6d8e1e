"""Wanda pruning: |W| * sqrt(mean ||x_c||^2), per-row masking (port of
``algorithms/wanda.py``).

Reference: pruning/wanda/core.py:22-145. Calibration inputs flow layer by
layer; the channel statistic is ``accumulate_scaler_rows``'; each row
zeroes every entry whose metric is at or below the row's k-th smallest,
k = int(cols * ratio) (ties prune more than k). The pruned layer's outputs
are the next layer's inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..capture.pipeline import CalibContext, accumulate_scaler_rows, advance
from ..device import full_f32_matmul
from ..models.config import ModelConfig
from ..models.transformer import arch_slots, layer_ops
from ..qformats.config import QuantConfig
from .common import get_weight, set_weight, slot_tap


def _prune_row_topk(W, scaler_row, sparsity_ratio: float):
    metric = torch.abs(W).float() * torch.sqrt(scaler_row)[None, :]
    k = int(W.shape[1] * sparsity_ratio)
    if k == 0:
        return W
    kth = torch.sort(metric, dim=1).values[:, k - 1:k]
    return torch.where(metric <= kth, torch.zeros_like(W), W)


@full_f32_matmul()
@torch.no_grad()
def wanda(params, cfg: ModelConfig, ctx: CalibContext, sparsity_ratio: float,
          qcfg: Optional[QuantConfig] = None, verbose: bool = True) -> None:
    """Prune every linear in place; ``ctx`` carries the layer-0 inputs and
    is advanced through the pruned layers."""
    slots = arch_slots(cfg)
    taps = tuple(dict.fromkeys(slot_tap(s) for s in slots))
    for i, lp in enumerate(params["layers"]):
        ops = layer_ops(cfg, qcfg, i)
        scaler = accumulate_scaler_rows(ctx, lp, i, taps, ops)
        for slot in slots:
            W = get_weight(lp, slot)
            set_weight(lp, slot, _prune_row_topk(W, scaler[slot_tap(slot)], sparsity_ratio))
        advance(ctx, lp, i, ops)
