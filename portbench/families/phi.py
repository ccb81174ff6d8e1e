"""Phi-1/1.5/2 (``model_type`` "phi"): LayerNorm with biases, one norm
read by attention and MLP side by side, biased linears and head, partial
rotary, a gelu-tanh MLP."""

from portbench.spec import Spec


def spec(cfg: dict) -> Spec:
    if cfg.get("qk_layernorm"):
        raise ValueError("phi with qk_layernorm is not modelled")
    if cfg["hidden_act"] != "gelu_new":
        raise ValueError(f"phi activation {cfg['hidden_act']!r} is not modelled")
    heads, hidden = cfg["num_attention_heads"], cfg["hidden_size"]
    d = hidden // heads
    return Spec(layers=cfg["num_hidden_layers"], hidden=hidden, ffn=cfg["intermediate_size"],
                heads=heads, kv_heads=cfg.get("num_key_value_heads") or heads, head_dim=d,
                vocab=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]),
                rotary_dim=int(d * cfg["partial_rotary_factor"]),
                eps=float(cfg["layer_norm_eps"]), tied=bool(cfg["tie_word_embeddings"]),
                act="gelu_tanh", gated=False, qk_norm=False, layernorm=True,
                parallel_residual=True, biases=True)
