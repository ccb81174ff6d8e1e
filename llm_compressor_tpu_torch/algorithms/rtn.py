"""RTN — round-to-nearest weight quantization (port of ``algorithms/rtn.py``).

Per linear: W <- fake_quantize(W) * (W != 0), which keeps pruned zeros.
The lm_head is quantized with the head config. The linears round their
scales eagerly and the head as under ``jit``, as the JAX version does
(``quantize_dequant_with_params``; ``quantize_dequant``, which is jitted,
in ``quantize_head_weight``); ``mse`` turns on the MSE clip search, which
rounds as jitted in both. ``scale_book`` records each linear's (scales,
zeros) for a lossless ``pack_model``.
"""

from __future__ import annotations

from typing import Optional

from ..models.config import ModelConfig
from ..models.transformer import arch_slots
from ..qformats.config import QuantConfig
from ..qformats.quantize import quantize_dequant_with_params
from .common import get_weight, quantize_head_weight, set_weight, weight_quantizer_for


def rtn(params, cfg: ModelConfig, qcfg: QuantConfig, mse: bool = False,
        scale_book: Optional[dict] = None, verbose: bool = True) -> None:
    """Quantize all linear weights in place; with ``scale_book``, record the
    solved (scales, zeros) under ``(layer, slot)``. ``verbose`` is the JAX
    signature's and logs nothing here."""
    for i, lp in enumerate(params["layers"]):
        for slot in arch_slots(cfg):
            q = weight_quantizer_for(cfg, qcfg, i, slot, mse)
            if q.qtype == "dummy":
                continue
            W = get_weight(lp, slot)
            dq, (s, z) = quantize_dequant_with_params(q, W)
            set_weight(lp, slot, dq * (W != 0).to(W.dtype))
            if scale_book is not None:
                scale_book[(i, slot)] = (s, z)
    quantize_head_weight(params, qcfg, mse)
