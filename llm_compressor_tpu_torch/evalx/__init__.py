"""evalx — evaluation (port of part of ``llm_compressor_tpu.evalx``: the
sparsity check; perplexity, the profiler, MPQ plans and the bridges are
queued in ROADMAP.md, queue A item 10)."""

from .sparsity import check_sparsity

__all__ = ["check_sparsity"]
