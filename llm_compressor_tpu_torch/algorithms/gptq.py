"""GPTQ — Hessian-weighted error-compensated weight quantization (port of
``algorithms/gptq.py``).

Reference: gptq/core.py:23-281. Per layer, per sequential group:
accumulate H = 2/n X X^T from the inputs of the group's linears (earlier
groups already quantized: the layer is re-run per group), then run the
blocked OBS update per linear. The outputs of the fully updated layer
become the next layer's inputs. The lm_head is RTN-quantized at the end.
"""

from __future__ import annotations

import time
from typing import Optional

from ..capture.pipeline import CalibContext, accumulate_hessian, advance
from ..models.config import ModelConfig
from ..models.transformer import layer_ops
from ..qformats.config import QuantConfig
from .common import (
    PhaseTimer,
    get_weight,
    quantize_head_weight,
    sequential_groups,
    set_weight,
    slot_tap,
    weight_quantizer_for,
)
from .obs import gptq_update_with_params


def gptq(params, cfg: ModelConfig, ctx: CalibContext, qcfg: QuantConfig,
         mse: bool = False, blocksize: int = 128, actorder: bool = True,
         scale_book: Optional[dict] = None, timings: Optional[PhaseTimer] = None) -> None:
    """Quantize every linear in place. ``scale_book`` (when given) records
    each linear's exact (scales, zeros) under ``(layer, slot)`` for a
    lossless ``pack_model``; ``timings`` collects seconds for the
    ``hessians`` (layer passes and Hessians, ``advance`` included) and the
    ``updates`` (OBS updates). ``mse`` runs the MSE clip search in each
    linear's parameter solve and in the head's RTN."""
    dev = ctx.hidden.device
    t = time.perf_counter()
    for i, lp in enumerate(params["layers"]):
        ops = layer_ops(cfg, qcfg, i)
        for group in sequential_groups(cfg):
            tap = slot_tap(group[0])
            H, _ = accumulate_hessian(ctx, lp, i, (tap,), ops)
            if timings is not None:
                t = timings.add("hessians", t, dev)
            for slot in group:
                qz = weight_quantizer_for(cfg, qcfg, i, slot, mse)
                if qz.qtype == "dummy":
                    continue
                W = get_weight(lp, slot)
                Q, s, z = gptq_update_with_params(W, H[tap], qz, blocksize=blocksize,
                                                  actorder=actorder)
                set_weight(lp, slot, Q.to(W.dtype))
                if scale_book is not None:
                    scale_book[(i, slot)] = (s, z)
            del H
            if timings is not None:
                t = timings.add("updates", t, dev)
        advance(ctx, lp, i, ops)
        if timings is not None:
            t = timings.add("hessians", t, dev)
    quantize_head_weight(params, qcfg, mse)
    if timings is not None:
        timings.add("updates", t, dev)
