"""Random parameter init (port of ``models/params.py::init_params``).

The params layout matches the JAX package (weights in (out, in)
orientation):

    params = {"embed": {"weight"},
              "layers": [{"ln1", "ln2", "attn": {"q","k","v","o"},
                          "mlp": {"gate","up","down"}}, ...],
              "final_norm", ["lm_head"]}

``save_compressed`` / ``load_compressed`` and HF checkpoint loading are
queued in ROADMAP.md (queue A item 3).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..device import resolve_device
from .config import ModelConfig

Params = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def init_params(cfg: ModelConfig, seed: int = 0, scale: float = 0.02,
                device=None) -> Params:
    """Normal(0, scale) weights from ``torch.Generator(seed)``, ones for the
    norms, in ``cfg.dtype`` on ``device`` (the card unless told otherwise).
    The draws do not equal ``jax.random``'s; tests hand the JAX package's
    params over through ``convert.py`` instead."""
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
                * scale).to(dt)

    def norm():
        return {"weight": torch.ones((cfg.hidden_size,), dtype=dt, device=dev)}

    E, I = cfg.hidden_size, cfg.intermediate_size
    params: Params = {"embed": {"weight": w(cfg.vocab_size, E)}}
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "ln1": norm(),
            "attn": {"q": {"weight": w(cfg.q_size, E)}, "k": {"weight": w(cfg.kv_size, E)},
                     "v": {"weight": w(cfg.kv_size, E)}, "o": {"weight": w(E, cfg.q_size)}},
            "mlp": {"gate": {"weight": w(I, E)}, "up": {"weight": w(I, E)},
                    "down": {"weight": w(E, I)}},
            "ln2": norm(),
        })
    params["layers"] = layers
    params["final_norm"] = norm()
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"weight": w(cfg.vocab_size, E)}
    return params
