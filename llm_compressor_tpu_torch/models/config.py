"""Model configuration (port of ``models/config.py``).

The port's transformer runs the Llama family only; the other eight
architectures of the JAX package are queued in ROADMAP.md (queue A item 7).
The config keeps the fields the Llama path reads. ``from_hf_config`` maps a
HuggingFace Llama config (object or dict) onto it and refuses what the
port cannot run: another ``model_type``, or biased projections;
``to_hf_config`` writes the dict it reads back field for field.
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


def _rope_scaling_from_hf(rs) -> Optional[RopeScaling]:
    if rs is None:
        return None
    if not isinstance(rs, dict):
        rs = dict(rs)
    kind = rs.get("rope_type", rs.get("type", "default"))
    if kind == "default":
        return None
    return RopeScaling(
        kind=kind,
        factor=rs.get("factor", 1.0),
        low_freq_factor=rs.get("low_freq_factor", 1.0),
        high_freq_factor=rs.get("high_freq_factor", 4.0),
        original_max_position=rs.get("original_max_position_embeddings", 8192),
    )


def from_hf_config(hf) -> ModelConfig:
    """A ModelConfig from a HuggingFace config object or dict, with the JAX
    function's defaults for absent keys. Only ``model_type == "llama"``
    without projection biases: the others raise ``NotImplementedError``."""
    get = (lambda k, d=None: hf.get(k, d)) if isinstance(hf, dict) else (
        lambda k, d=None: getattr(hf, k, d))
    mt = get("model_type")
    if mt != "llama":
        raise NotImplementedError(
            f"model_type {mt!r} is not ported yet: ROADMAP.md queue A item 7")
    for key in ("attention_bias", "mlp_bias"):
        if get(key, False):
            raise NotImplementedError(
                f"a Llama config with {key}=True: the port's projections have no "
                "bias (ROADMAP.md queue A item 7)")
    heads = get("num_attention_heads")
    return ModelConfig(
        arch=mt,
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=heads,
        num_kv_heads=get("num_key_value_heads", heads),
        head_dim=get("head_dim") or get("hidden_size") // heads,
        max_position_embeddings=get("max_position_embeddings", 2048),
        hidden_act=get("hidden_act", "silu"),
        rms_norm_eps=get("rms_norm_eps", 1e-6),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=_rope_scaling_from_hf(get("rope_scaling")),
        tie_word_embeddings=get("tie_word_embeddings", False),
    )


def to_hf_config(cfg: ModelConfig) -> dict:
    """The HF ``config.json`` dict of a Llama ``cfg``: ``from_hf_config``
    of it gives ``cfg`` back (the dtype as ``torch_dtype``, which
    ``from_hf_config`` leaves at its default, as the JAX function does)."""
    rs = cfg.rope_scaling
    return {
        "model_type": cfg.arch, "architectures": ["LlamaForCausalLM"],
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "max_position_embeddings": cfg.max_position_embeddings,
        "hidden_act": cfg.hidden_act, "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "rope_scaling": None if rs is None else {
            "rope_type": rs.kind, "factor": rs.factor, "low_freq_factor": rs.low_freq_factor,
            "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings": rs.original_max_position},
        "tie_word_embeddings": cfg.tie_word_embeddings, "attention_bias": False,
        "mlp_bias": False, "torch_dtype": cfg.dtype,
    }
