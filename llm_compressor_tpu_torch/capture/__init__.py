"""capture — the layerwise calibration pipeline (port of part of
``llm_compressor_tpu.capture``)."""

from .pipeline import (
    SLOT_TAP,
    TAP_KEYS,
    CalibContext,
    accumulate_hessian,
    advance,
    capture_layer0,
    run_layer,
)

__all__ = ["SLOT_TAP", "TAP_KEYS", "CalibContext", "capture_layer0", "run_layer",
           "advance", "accumulate_hessian"]
