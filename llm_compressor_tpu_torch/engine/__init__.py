"""engine — bf16 / int8 KV cache, prefill, greedy decode and sampling (port
of part of ``llm_compressor_tpu.engine``)."""

from .generate import acts_mode, decode_greedy_steps, decode_step, generate, prefill
from .kvcache import KVCache, init_cache

__all__ = ["KVCache", "init_cache", "prefill", "decode_step", "decode_greedy_steps",
           "generate", "acts_mode"]
