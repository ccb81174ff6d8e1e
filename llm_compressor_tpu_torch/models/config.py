"""Model configuration (port of ``models/config.py``).

The port's transformer runs the nine architectures of the JAX package:
Llama, Qwen2, Qwen3, Gemma, Gemma2, Gemma3, OPT, BLOOM and Phi. Their
differences are flags, as in the JAX package: projection biases (Qwen2,
OPT, BLOOM, Phi), q/k norms (Qwen3, Gemma3; Phi's optional q/k LayerNorm),
``(1 + w)`` norms and an embedding scale (Gemma), attention and
final-logit softcaps (Gemma2), per-layer sliding windows (Gemma2, Gemma3),
a second rope theta on the local layers (Gemma3), pre/post feed-forward
norms (Gemma2, Gemma3), LayerNorm and fc1/fc2 MLPs (OPT, BLOOM, Phi),
learned positions with an offset (OPT), ALiBi and a fused interleaved
q|k|v (BLOOM), a parallel residual and partial rotary (Phi), and OPT-350m's
``project_in`` / ``project_out`` and post-norm. ``from_hf_config`` maps a
HuggingFace config (object or dict) onto the config and refuses what the
port cannot run; ``to_hf_config`` writes the dict it reads back field for
field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

SUPPORTED_ARCHS = (
    "llama", "qwen2", "qwen3", "gemma", "gemma2", "gemma3", "opt", "bloom", "phi",
)


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
    hidden_act: str = "silu"            # silu | gelu | gelu_new | gelu_tanh | relu
    norm_type: str = "rmsnorm"          # rmsnorm | layernorm (opt, bloom, phi)
    rms_norm_eps: float = 1e-6          # the eps of either norm
    norm_weight_plus_one: bool = False  # gemma: (1 + w) RMSNorm
    mlp_style: str = "gated"            # gated (gate/up/down) | mlp (fc1/fc2)
    pos_embedding: str = "rope"         # rope | learned (opt) | alibi (bloom)
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    partial_rotary_factor: float = 1.0  # phi: rope on the first rotary_dim dims
    rope_local_theta: Optional[float] = None  # gemma3: the local layers' theta
    learned_pos_offset: int = 0         # opt: positions offset by 2
    attention_bias: bool = False        # q/k/v biases (qwen2, opt, bloom, phi)
    attention_out_bias: bool = False    # the o projection's bias (opt, bloom, phi)
    mlp_bias: bool = False              # fc1/fc2 biases (opt, bloom, phi)
    qk_norm: bool = False               # qwen3, gemma3: RMS q/k norm over head_dim
    qk_layernorm: bool = False          # phi option: LayerNorm q/k norm over head_dim
    query_pre_attn_scalar: Optional[float] = None  # gemma2/3: scores * qpas ** -0.5
    attn_logit_softcapping: Optional[float] = None   # gemma2
    final_logit_softcapping: Optional[float] = None  # gemma2
    sliding_window: Optional[int] = None
    layer_types: Tuple[str, ...] = ()   # per layer "full_attention" / "sliding_attention"
    fused_qkv: bool = False             # bloom: one query_key_value, (H, 3, D) along N
    parallel_residual: bool = False     # phi: attention and MLP share one input norm
    pre_post_ffw_norm: bool = False     # gemma2/3: norms before and after the MLP
    post_attn_residual_norm: bool = False  # gemma2/3: a norm on the attention output
    do_layer_norm_before: bool = True   # opt-350m: False, post-norm
    final_norm: bool = True
    embedding_layernorm: bool = False   # bloom: a LayerNorm right after the embedding
    embed_scale: Optional[float] = None  # gemma: hidden *= sqrt(hidden_size)
    project_in_dim: Optional[int] = None  # opt-350m: word_embed_proj_dim
    tie_word_embeddings: bool = True
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.arch not in SUPPORTED_ARCHS:
            raise ValueError(f"unknown arch {self.arch!r} (supported: {SUPPORTED_ARCHS})")
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        if self.layer_types and len(self.layer_types) != self.num_layers:
            raise ValueError("layer_types must name every layer")

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def attn_scale(self) -> float:
        if self.query_pre_attn_scalar is not None:
            return self.query_pre_attn_scalar ** -0.5
        return self.head_dim ** -0.5

    def layer_type(self, i: int) -> str:
        if self.layer_types:
            return self.layer_types[i]
        if self.sliding_window is not None and self.arch == "gemma2":
            return "sliding_attention" if i % 2 == 0 else "full_attention"
        return "full_attention"

    def layer_window(self, i: int) -> int:
        """Layer ``i``'s sliding window, 0 for full attention (the
        kernels' convention; JAX ``models/transformer.py::layer_window``
        gives None)."""
        if self.sliding_window is not None and self.layer_type(i) == "sliding_attention":
            return int(self.sliding_window)
        return 0


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
    function's defaults for absent keys (``model_type`` llama, qwen2, qwen3,
    gemma, gemma2, gemma3, gemma3_text, opt, bloom or phi). A gated-MLP
    config with ``mlp_bias`` (which the JAX function does not read) raises
    ``NotImplementedError``."""
    get = (lambda k, d=None: hf.get(k, d)) if isinstance(hf, dict) else (
        lambda k, d=None: getattr(hf, k, d))
    mt = get("model_type")
    if mt not in ("opt", "bloom", "phi") and get("mlp_bias", False):
        raise NotImplementedError(
            "a config with mlp_bias=True: the gated MLP has no biases here, nor in the JAX "
            "package")
    heads = get("num_attention_heads")
    if mt in ("llama", "qwen2", "qwen3"):
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
            attention_bias=bool(get("attention_bias", mt == "qwen2")),
            qk_norm=(mt == "qwen3"),
            sliding_window=get("sliding_window") if get("use_sliding_window", False) else None,
            tie_word_embeddings=get("tie_word_embeddings", False),
        )
    if mt in ("gemma", "gemma2", "gemma3", "gemma3_text"):
        arch = "gemma3" if mt == "gemma3_text" else mt
        hidden = get("hidden_size")
        return ModelConfig(
            arch=arch,
            vocab_size=get("vocab_size"),
            hidden_size=hidden,
            intermediate_size=get("intermediate_size"),
            num_layers=get("num_hidden_layers"),
            num_heads=heads,
            num_kv_heads=get("num_key_value_heads", heads),
            head_dim=get("head_dim") or hidden // heads,
            max_position_embeddings=get("max_position_embeddings", 8192),
            hidden_act=(get("hidden_activation") or get("hidden_act") or "gelu_pytorch_tanh"),
            rms_norm_eps=get("rms_norm_eps", 1e-6),
            norm_weight_plus_one=True,
            rope_theta=get("rope_theta", 10000.0),
            rope_local_theta=get("rope_local_base_freq") if arch == "gemma3" else None,
            rope_scaling=_rope_scaling_from_hf(get("rope_scaling")),
            query_pre_attn_scalar=(get("query_pre_attn_scalar")
                                   if arch in ("gemma2", "gemma3") else None),
            attn_logit_softcapping=get("attn_logit_softcapping") if arch == "gemma2" else None,
            final_logit_softcapping=get("final_logit_softcapping") if arch == "gemma2" else None,
            sliding_window=get("sliding_window"),
            layer_types=tuple(get("layer_types") or ()),
            qk_norm=(arch == "gemma3"),
            pre_post_ffw_norm=arch in ("gemma2", "gemma3"),
            post_attn_residual_norm=arch in ("gemma2", "gemma3"),
            embed_scale=float(hidden) ** 0.5,
            tie_word_embeddings=True,
        )
    if mt == "opt":
        hidden = get("hidden_size")
        bias = get("enable_bias", True)
        return ModelConfig(
            arch="opt",
            vocab_size=get("vocab_size"),
            hidden_size=hidden,
            intermediate_size=get("ffn_dim"),
            num_layers=get("num_hidden_layers"),
            num_heads=heads,
            num_kv_heads=heads,
            head_dim=hidden // heads,
            max_position_embeddings=get("max_position_embeddings", 2048),
            hidden_act=get("activation_function", "relu"),
            norm_type="layernorm",
            rms_norm_eps=1e-5,  # nn.LayerNorm's default, which HF's OPT keeps
            mlp_style="mlp",
            pos_embedding="learned",
            learned_pos_offset=2,
            attention_bias=bias,
            attention_out_bias=bias,
            mlp_bias=bias,
            do_layer_norm_before=get("do_layer_norm_before", True),
            project_in_dim=(get("word_embed_proj_dim")
                            if get("word_embed_proj_dim") != hidden else None),
            tie_word_embeddings=get("tie_word_embeddings", True),
        )
    if mt == "bloom":
        # the width under ``hidden_size``, as the JAX function reads it (a
        # hub config.json names it ``n_embed``; BloomConfig maps that key)
        hidden = get("hidden_size")
        heads = get("n_head") or heads
        return ModelConfig(
            arch="bloom",
            vocab_size=get("vocab_size"),
            hidden_size=hidden,
            intermediate_size=4 * hidden,
            num_layers=get("n_layer") or get("num_hidden_layers"),
            num_heads=heads,
            num_kv_heads=heads,
            head_dim=hidden // heads,
            hidden_act="gelu_tanh",
            norm_type="layernorm",
            rms_norm_eps=get("layer_norm_epsilon", 1e-5),
            mlp_style="mlp",
            pos_embedding="alibi",
            attention_bias=True,
            attention_out_bias=True,
            mlp_bias=True,
            fused_qkv=True,
            embedding_layernorm=True,
            tie_word_embeddings=True,
        )
    if mt == "phi":
        hidden = get("hidden_size")
        return ModelConfig(
            arch="phi",
            vocab_size=get("vocab_size"),
            hidden_size=hidden,
            intermediate_size=get("intermediate_size"),
            num_layers=get("num_hidden_layers"),
            num_heads=heads,
            num_kv_heads=get("num_key_value_heads") or heads,
            head_dim=hidden // heads,
            max_position_embeddings=get("max_position_embeddings", 2048),
            hidden_act=get("hidden_act", "gelu_new"),
            norm_type="layernorm",
            rms_norm_eps=get("layer_norm_eps", 1e-5),
            mlp_style="mlp",
            rope_theta=get("rope_theta", 10000.0),
            partial_rotary_factor=get("partial_rotary_factor", 0.5),
            attention_bias=True,
            attention_out_bias=True,
            mlp_bias=True,
            qk_layernorm=get("qk_layernorm", False),
            parallel_residual=True,
            tie_word_embeddings=get("tie_word_embeddings", False),
        )
    raise ValueError(f"Unsupported model_type {mt!r} (supported: {SUPPORTED_ARCHS})")


_HF_NAMES = {"llama": ("llama", "LlamaForCausalLM"), "qwen2": ("qwen2", "Qwen2ForCausalLM"),
             "qwen3": ("qwen3", "Qwen3ForCausalLM"), "gemma": ("gemma", "GemmaForCausalLM"),
             "gemma2": ("gemma2", "Gemma2ForCausalLM"),
             "gemma3": ("gemma3_text", "Gemma3ForCausalLM"), "opt": ("opt", "OPTForCausalLM"),
             "bloom": ("bloom", "BloomForCausalLM"), "phi": ("phi", "PhiForCausalLM")}


def to_hf_config(cfg: ModelConfig) -> dict:
    """The HF ``config.json`` dict of ``cfg``, under HF's ``model_type``,
    ``architectures`` and key names: ``from_hf_config`` of it gives ``cfg``
    back (the dtype as ``torch_dtype``, which ``from_hf_config`` leaves at
    its default, as the JAX function does). What ``from_hf_config`` fixes
    per architecture reads back as it fixes it: a Gemma config with the
    embedding scale sqrt(hidden) and tied embeddings, an OPT config with
    the LayerNorm eps 1e-5, a BLOOM config with 2048 positions."""
    model_type, archs = _HF_NAMES[cfg.arch]
    hf = {"model_type": model_type, "architectures": [archs], "vocab_size": cfg.vocab_size,
          "hidden_size": cfg.hidden_size, "tie_word_embeddings": cfg.tie_word_embeddings,
          "torch_dtype": cfg.dtype}
    if cfg.arch == "opt":
        hf.update(ffn_dim=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
                  num_attention_heads=cfg.num_heads,
                  max_position_embeddings=cfg.max_position_embeddings,
                  activation_function=cfg.hidden_act, enable_bias=cfg.attention_bias,
                  do_layer_norm_before=cfg.do_layer_norm_before,
                  word_embed_proj_dim=cfg.project_in_dim or cfg.hidden_size)
        return hf
    if cfg.arch == "bloom":
        hf.update(n_layer=cfg.num_layers, n_head=cfg.num_heads,
                  layer_norm_epsilon=cfg.rms_norm_eps)
        return hf
    hf.update(intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
              num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
              max_position_embeddings=cfg.max_position_embeddings, rope_theta=cfg.rope_theta)
    if cfg.arch == "phi":
        hf.update(hidden_act=cfg.hidden_act, layer_norm_eps=cfg.rms_norm_eps,
                  partial_rotary_factor=cfg.partial_rotary_factor,
                  qk_layernorm=cfg.qk_layernorm)
        return hf
    rs = cfg.rope_scaling
    hf.update(head_dim=cfg.head_dim, rms_norm_eps=cfg.rms_norm_eps,
              rope_scaling=None if rs is None else {
                  "rope_type": rs.kind, "factor": rs.factor,
                  "low_freq_factor": rs.low_freq_factor,
                  "high_freq_factor": rs.high_freq_factor,
                  "original_max_position_embeddings": rs.original_max_position})
    if cfg.arch in ("llama", "qwen2", "qwen3"):
        hf.update(hidden_act=cfg.hidden_act, attention_bias=cfg.attention_bias,
                  mlp_bias=False, use_sliding_window=cfg.sliding_window is not None,
                  sliding_window=cfg.sliding_window)
        return hf
    hf.update(hidden_activation=cfg.hidden_act, sliding_window=cfg.sliding_window,
              layer_types=list(cfg.layer_types) or None,
              query_pre_attn_scalar=cfg.query_pre_attn_scalar,
              attn_logit_softcapping=cfg.attn_logit_softcapping,
              final_logit_softcapping=cfg.final_logit_softcapping,
              rope_local_base_freq=cfg.rope_local_theta)
    return hf
