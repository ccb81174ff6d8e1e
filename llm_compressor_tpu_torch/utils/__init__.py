"""utils — host-side helpers (port of part of ``llm_compressor_tpu.utils``)."""

from .dataset import synthetic_tokens

__all__ = ["synthetic_tokens"]
