"""Pack calibrated (fake-quantized) weights into QTensors (port of
``algorithms/pack.py``).

Scales are re-derived from the grid-aligned values, as the JAX version
does for weights without a ``scale_book`` entry (the scale book serves the
calibration algorithms: ROADMAP.md, queue A item 9).
"""

from __future__ import annotations

from ..models.config import ModelConfig
from ..models.transformer import SLOTS
from ..qformats.config import QuantConfig
from ..qformats.qtensor import QTensor, quantize_pack
from .common import get_weight, set_weight, weight_quantizer_for


def pack_model(params, cfg: ModelConfig, qcfg: QuantConfig) -> None:
    """Replace every quantizable linear weight with a packed QTensor (in
    place). With a head quantizer the lm_head is packed too; for tied
    embeddings a packed ``lm_head`` copy is added and the embedding table
    stays dense for the gathers."""
    for i, lp in enumerate(params["layers"]):
        for slot in SLOTS:
            q = weight_quantizer_for(cfg, qcfg, i, slot)
            if q.qtype == "dummy":
                continue
            try:
                W = get_weight(lp, slot)
            except KeyError:  # slot fused away (fuse_model)
                continue
            if not isinstance(W, QTensor):
                set_weight(lp, slot, quantize_pack(q, W))
    hq = qcfg.head.weight
    if hq.qtype != "dummy":
        W = params["lm_head"]["weight"] if "lm_head" in params else params["embed"]["weight"]
        if not isinstance(W, QTensor):
            params.setdefault("lm_head", {})["weight"] = quantize_pack(hq, W)
