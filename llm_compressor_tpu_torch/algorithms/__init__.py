"""algorithms — calibration (RTN, SmoothQuant, GPTQ, AWQ, AWQ+, GPTAQ,
SpinQuant) and pruning (magnitude, Wanda, SparseGPT, RIA) as functions
over params, and packing (port of ``llm_compressor_tpu.algorithms``;
``spinquant`` runs the Hadamard mode and raises for the optimize mode)."""

from .awq import awq, awq_plus
from .common import PhaseTimer
from .gptaq import gptaq
from .gptq import gptq
from .magnitude import magnitude
from .obs import (
    gptaq_update,
    gptaq_update_with_params,
    gptq_update,
    gptq_update_with_params,
    hessian_inverse_factor,
    sparsegpt_update,
)
from .pack import pack_model
from .ria import ria
from .rtn import rtn
from .smoothquant import smoothquant
from .sparsegpt import sparsegpt
from .spinquant import load_rotations, save_rotations, spinquant
from .wanda import wanda

__all__ = ["rtn", "smoothquant", "gptq", "awq", "awq_plus", "gptaq", "spinquant",
           "magnitude", "wanda", "sparsegpt", "ria",
           "gptq_update", "gptq_update_with_params", "gptaq_update",
           "gptaq_update_with_params", "sparsegpt_update", "hessian_inverse_factor",
           "load_rotations", "save_rotations", "pack_model", "PhaseTimer"]
