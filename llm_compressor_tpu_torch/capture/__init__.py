"""capture — the layerwise calibration pipeline (port of
``llm_compressor_tpu.capture``)."""

from .pipeline import (
    SLOT_TAP,
    TAP_KEYS,
    CalibContext,
    accumulate_hessian,
    accumulate_scaler_rows,
    advance,
    capture_layer0,
    layer_taps,
    run_layer,
)

__all__ = ["SLOT_TAP", "TAP_KEYS", "CalibContext", "capture_layer0", "run_layer",
           "advance", "accumulate_hessian", "layer_taps", "accumulate_scaler_rows"]
