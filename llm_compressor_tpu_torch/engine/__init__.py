"""engine — bf16 / int8 KV cache, prefill, greedy decode and sampling (port
of part of ``llm_compressor_tpu.engine``)."""

from .generate import (
    CHAT_TEMPLATE,
    acts_mode,
    decode_greedy_steps,
    decode_step,
    generate,
    generate_text,
    prefill,
)
from .kvcache import KVCache, init_cache

__all__ = ["KVCache", "init_cache", "prefill", "decode_step", "decode_greedy_steps",
           "generate", "generate_text", "CHAT_TEMPLATE", "acts_mode"]
