"""models — the Llama transformer core (port of ``llm_compressor_tpu.models``)."""

from .config import ModelConfig, RopeScaling, SUPPORTED_ARCHS, from_hf_config, to_hf_config
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
    """Small random-init config for tests (no checkpoint needed)."""
    if arch != "llama":
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: ROADMAP.md queue A item 7")
    cfg = dict(
        arch=arch,
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
    cfg.update(overrides)
    return ModelConfig(**cfg)


__all__ = [
    "ModelConfig", "RopeScaling", "SUPPORTED_ARCHS", "from_hf_config", "to_hf_config",
    "init_params", "load_params_from_state_dict", "save_compressed", "load_compressed",
    "load_hf_checkpoint", "forward", "embed", "head", "tiny_config", "LayerOps",
    "layer_ops", "fuse_model", "stack_model", "scan_segments", "uniform_layers",
    "quant_uniform",
]
