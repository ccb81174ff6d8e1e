"""engine — bf16 / int8 KV cache, prefill, greedy decode and sampling, CUDA
graphs of the decode, continuous batching and speculative decoding (port of
``llm_compressor_tpu.engine``)."""

from .batching import ContinuousBatcher, Request
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
from .speculative import decode_verify_step, generate_speculative

__all__ = ["KVCache", "init_cache", "prefill", "decode_step", "decode_greedy_steps",
           "generate", "generate_text", "CHAT_TEMPLATE", "acts_mode", "ContinuousBatcher",
           "Request", "decode_verify_step", "generate_speculative"]
