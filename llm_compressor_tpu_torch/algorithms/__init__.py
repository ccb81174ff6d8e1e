"""algorithms — RTN and packing (port of part of
``llm_compressor_tpu.algorithms``; the calibration and pruning algorithms
are queued in ROADMAP.md, queue A item 9)."""

from .pack import pack_model
from .rtn import rtn

__all__ = ["rtn", "pack_model"]
