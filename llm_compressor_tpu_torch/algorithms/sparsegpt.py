"""SparseGPT: blocked OBS one-shot pruning (port of
``algorithms/sparsegpt.py``).

Reference: pruning/sparsegpt/core.py:23-228. Per layer one pass
accumulates the Hessians of every linear's input (no sequential groups),
then each linear is pruned by ``sparsegpt_update``; the pruned layer's
outputs are the next layer's inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..capture.pipeline import CalibContext, accumulate_hessian, advance
from ..models.config import ModelConfig
from ..models.transformer import arch_slots, layer_ops
from ..qformats.config import QuantConfig
from .common import get_weight, set_weight, slot_tap
from .obs import sparsegpt_update


@torch.no_grad()
def sparsegpt(params, cfg: ModelConfig, ctx: CalibContext, sparsity_ratio: float,
              qcfg: Optional[QuantConfig] = None, blocksize: int = 128,
              verbose: bool = True) -> None:
    """Prune every linear in place; ``ctx`` is advanced through the pruned
    layers."""
    slots = arch_slots(cfg)
    taps = tuple(dict.fromkeys(slot_tap(s) for s in slots))
    for i, lp in enumerate(params["layers"]):
        ops = layer_ops(cfg, qcfg, i)
        H, _ = accumulate_hessian(ctx, lp, i, taps, ops)
        for slot in slots:
            W = get_weight(lp, slot)
            Wp = sparsegpt_update(W, H[slot_tap(slot)], sparsity_ratio, blocksize=blocksize)
            set_weight(lp, slot, Wp.to(W.dtype))
        del H
        advance(ctx, lp, i, ops)
