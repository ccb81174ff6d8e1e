"""Model configuration (port of ``models/config.py``).

The port's transformer runs the Llama family only; the other eight
architectures of the JAX package are queued in ROADMAP.md (queue A item 7).
The config keeps the fields the Llama path reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

SUPPORTED_ARCHS = ("llama",)


@dataclass(frozen=True)
class RopeScaling:
    kind: str = "default"          # "default" | "linear" | "llama3"
    factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_position_embeddings: int = 2048
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    tie_word_embeddings: bool = True
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.arch not in SUPPORTED_ARCHS:
            raise NotImplementedError(
                f"arch {self.arch!r} is not ported yet: ROADMAP.md queue A item 7")
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def attn_scale(self) -> float:
        return self.head_dim ** -0.5
