"""algorithms — RTN, GPTQ, SpinQuant (Hadamard mode) and packing (port of
part of ``llm_compressor_tpu.algorithms``; GPTAQ, SparseGPT, AWQ,
SmoothQuant, SpinQuant's optimize mode and the pruning algorithms are
queued in ROADMAP.md, queue A item 9)."""

from .common import PhaseTimer
from .gptq import gptq
from .obs import gptq_update, gptq_update_with_params, hessian_inverse_factor
from .pack import pack_model
from .rtn import rtn
from .spinquant import load_rotations, save_rotations, spinquant

__all__ = ["rtn", "gptq", "gptq_update", "gptq_update_with_params",
           "hessian_inverse_factor", "spinquant", "load_rotations", "save_rotations",
           "pack_model", "PhaseTimer"]
