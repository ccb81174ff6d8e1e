"""models — the transformer core of the nine architectures (port of
``llm_compressor_tpu.models``)."""

from .config import (
    SUPPORTED_ARCHS,
    ModelConfig,
    RopeScaling,
    from_hf_config,
    to_hf_config,
)
from .params import (
    init_params,
    load_compressed,
    load_hf_checkpoint,
    load_params_from_state_dict,
    save_compressed,
)
from .transformer import (
    LayerOps,
    embed,
    forward,
    fuse_model,
    head,
    layer_ops,
    quant_uniform,
    scan_segments,
    stack_model,
    uniform_layers,
)


def tiny_config(arch: str = "llama", **overrides) -> ModelConfig:
    """Small random-init config for tests (no checkpoint needed), each
    architecture's as the JAX package's ``tiny_config`` builds it."""
    base = dict(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_position_embeddings=128,
        dtype="float32",
    )
    gemma = dict(hidden_act="gelu_pytorch_tanh", norm_weight_plus_one=True, embed_scale=8.0,
                 tie_word_embeddings=True)
    if arch == "gemma":
        cfg = dict(base, arch=arch, num_kv_heads=4, **gemma)
    elif arch == "gemma2":
        cfg = dict(base, arch=arch, **gemma, query_pre_attn_scalar=16.0,
                   attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                   sliding_window=8, pre_post_ffw_norm=True, post_attn_residual_norm=True)
    elif arch == "gemma3":
        cfg = dict(base, arch=arch, **gemma, query_pre_attn_scalar=16.0, qk_norm=True,
                   sliding_window=8, rope_local_theta=10000.0, rope_theta=1000000.0,
                   pre_post_ffw_norm=True, post_attn_residual_norm=True)
    elif arch in ("llama", "qwen2", "qwen3"):
        cfg = dict(base, arch=arch, attention_bias=arch == "qwen2", qk_norm=arch == "qwen3")
    elif arch in ("opt", "bloom", "phi"):
        biased = dict(norm_type="layernorm", mlp_style="mlp", attention_bias=True,
                      attention_out_bias=True, mlp_bias=True)
        if arch == "opt":
            cfg = dict(base, arch=arch, num_kv_heads=4, hidden_act="relu", **biased,
                       pos_embedding="learned", learned_pos_offset=2, tie_word_embeddings=True)
        elif arch == "bloom":
            cfg = dict(base, arch=arch, num_kv_heads=4, intermediate_size=256,
                       hidden_act="gelu_tanh", **biased, pos_embedding="alibi",
                       fused_qkv=True, embedding_layernorm=True, tie_word_embeddings=True)
        else:
            cfg = dict(base, arch=arch, num_kv_heads=4, hidden_act="gelu_new", **biased,
                       partial_rotary_factor=0.5, parallel_residual=True,
                       tie_word_embeddings=False)
    else:
        raise ValueError(arch)
    cfg.update(overrides)
    if arch == "gemma3" and "layer_types" not in cfg:
        # gemma3's alternating local/global pattern, sized to num_layers
        cfg["layer_types"] = tuple(
            "sliding_attention" if i % 2 == 0 else "full_attention"
            for i in range(cfg["num_layers"]))
    return ModelConfig(**cfg)


__all__ = [
    "ModelConfig", "RopeScaling", "SUPPORTED_ARCHS", "from_hf_config", "to_hf_config",
    "init_params", "load_params_from_state_dict", "save_compressed", "load_compressed",
    "load_hf_checkpoint", "forward", "embed", "head", "tiny_config", "LayerOps",
    "layer_ops", "fuse_model", "stack_model", "scan_segments", "uniform_layers",
    "quant_uniform",
]
