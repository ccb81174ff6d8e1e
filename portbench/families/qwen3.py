"""Qwen3 (``model_type`` "qwen3"): GQA with q/k RMS norms, RMS norms, a
gated silu MLP, no biases, full rotary."""

from portbench.spec import Spec


def spec(cfg: dict) -> Spec:
    if cfg.get("attention_bias") or cfg.get("use_sliding_window"):
        raise ValueError("qwen3 with attention biases or a sliding window is not modelled")
    if cfg["hidden_act"] != "silu":
        raise ValueError(f"qwen3 activation {cfg['hidden_act']!r} is not modelled")
    heads, hidden = cfg["num_attention_heads"], cfg["hidden_size"]
    d = cfg.get("head_dim") or hidden // heads
    return Spec(layers=cfg["num_hidden_layers"], hidden=hidden, ffn=cfg["intermediate_size"],
                heads=heads, kv_heads=cfg["num_key_value_heads"], head_dim=d,
                vocab=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]), rotary_dim=d,
                eps=float(cfg["rms_norm_eps"]), tied=bool(cfg["tie_word_embeddings"]),
                act="silu", gated=True, qk_norm=True, layernorm=False,
                parallel_residual=False, biases=False)
