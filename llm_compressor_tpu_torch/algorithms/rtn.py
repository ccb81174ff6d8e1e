"""RTN — round-to-nearest weight quantization (port of ``algorithms/rtn.py``).

Per linear: W <- fake_quantize(W) * (W != 0), which keeps pruned zeros.
The lm_head is quantized with the head config. The linears round their
scales eagerly and the head as under ``jit``, as the JAX version does
(``quantize_dequant_with_params``; ``quantize_dequant``, which is jitted,
in ``quantize_head_weight``). The JAX version's MSE clip
search and ``scale_book`` are not ported (ROADMAP.md, queue A item 9).
"""

from __future__ import annotations

from ..models.config import ModelConfig
from ..models.transformer import SLOTS
from ..qformats.config import QuantConfig
from ..qformats.quantize import quantize_dequant_with_params
from .common import get_weight, quantize_head_weight, set_weight, weight_quantizer_for


def rtn(params, cfg: ModelConfig, qcfg: QuantConfig) -> None:
    """Quantize all linear weights in place."""
    for i, lp in enumerate(params["layers"]):
        for slot in SLOTS:
            q = weight_quantizer_for(cfg, qcfg, i, slot)
            if q.qtype == "dummy":
                continue
            W = get_weight(lp, slot)
            set_weight(lp, slot, quantize_dequant_with_params(q, W)[0] * (W != 0).to(W.dtype))
    quantize_head_weight(params, qcfg)
