"""Pack calibrated (fake-quantized) weights into QTensors (port of
``algorithms/pack.py``).

Calibration algorithms record the exact (scales, zeros) they rounded each
linear against in a ``scale_book``; packing with those is lossless:
``dequantize`` of the packed weight equals the calibrated weight bitwise.
Weights without an entry (RTN's) re-derive their parameters from the
grid-aligned values.
"""

from __future__ import annotations

from typing import Optional

from ..models.config import ModelConfig
from ..models.transformer import arch_slots
from ..qformats.config import QuantConfig
from ..qformats.qtensor import QTensor, quantize_pack
from .common import get_weight, set_weight, weight_quantizer_for


def pack_model(params, cfg: ModelConfig, qcfg: QuantConfig,
               scale_book: Optional[dict] = None, pack_head: bool = True) -> None:
    """Replace every quantizable linear weight with a packed QTensor (in
    place; JAX ``algorithms/pack.py:26-56``); ``scale_book`` maps ``(layer,
    slot)`` to the (scales, zeros) to pack with. With ``pack_head`` and a
    head quantizer the lm_head is packed too; for tied embeddings a packed
    ``lm_head`` copy is added and the embedding table stays dense for the
    gathers. ``pack_head=False`` leaves the head dense, tied or not: it is
    then served as its (RTN'd) float weight behind the head's act
    quantizer."""
    for i, lp in enumerate(params["layers"]):
        for slot in arch_slots(cfg):
            q = weight_quantizer_for(cfg, qcfg, i, slot)
            if q.qtype == "dummy":
                continue
            try:
                W = get_weight(lp, slot)
            except KeyError:  # slot fused away (fuse_model)
                continue
            if isinstance(W, QTensor):
                continue
            if scale_book is not None and (i, slot) in scale_book:
                s, z = scale_book[(i, slot)]
                set_weight(lp, slot, quantize_pack(q, W, scales=s, zeros=z))
            else:
                set_weight(lp, slot, quantize_pack(q, W))
    hq = qcfg.head.weight
    if pack_head and hq.qtype != "dummy":
        W = params["lm_head"]["weight"] if "lm_head" in params else params["embed"]["weight"]
        if not isinstance(W, QTensor):
            params.setdefault("lm_head", {})["weight"] = quantize_pack(hq, W)
