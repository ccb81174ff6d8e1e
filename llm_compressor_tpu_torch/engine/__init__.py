"""engine — int8 KV cache, prefill and greedy decode (port of part of
``llm_compressor_tpu.engine``)."""

from .generate import decode_greedy_steps, decode_step, prefill
from .kvcache import KVCache, init_cache

__all__ = ["KVCache", "init_cache", "prefill", "decode_step", "decode_greedy_steps"]
