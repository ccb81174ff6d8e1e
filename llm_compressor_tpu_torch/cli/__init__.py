"""cli — the command-line pipeline (port of ``llm_compressor_tpu.cli``):
load -> prune -> profile -> quantize -> evaluate -> pack -> save."""

from .args import build_parser
from .main import run_pipeline

__all__ = ["build_parser", "run_pipeline"]
