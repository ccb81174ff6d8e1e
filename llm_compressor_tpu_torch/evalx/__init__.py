"""evalx — evaluation (port of ``llm_compressor_tpu.evalx``): perplexity
and the task runner (``ppl``), the sparsity check, per-op profiling
(``profiler``), SQNR-driven MPQ plans (``mpq``), the lm-eval bridge
(``lm_eval_bridge``), and the text-to-image evaluator (``t2i_eval``) with
its CLIP and ImageReward towers (``clip``, ``image_reward``)."""

from .mpq import read_stats, select_ops, sqnr_driven_mpq
from .ppl import compute_ppl, evaluate
from .profiler import profile_model
from .sparsity import check_sparsity

__all__ = ["compute_ppl", "evaluate", "check_sparsity", "profile_model",
           "read_stats", "select_ops", "sqnr_driven_mpq"]
