"""Seed-made float weights of a configuration, shared by the program's feed
and the plain reference.

Every tensor of one kind is drawn in one call, stacked over the layers, on
the device and in bfloat16 (the type the model is served in): linear
weights N(0, 0.02), biases N(0, 0.02), norm weights 1 + N(0, 0.05), norm
biases N(0, 0.02). The same seed on the same device gives the same bits,
so the reference can draw them again after the program's state is gone.
"""

from __future__ import annotations

from typing import Dict

import torch

from .spec import Spec

SCALE = 0.02
NORM_SPREAD = 0.05


def draw(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> bf16 tensor; per-layer kinds carry a leading layer axis."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, E, I, V = spec.layers, spec.hidden, spec.ffn, spec.vocab
    q_out, kv_out = spec.heads * spec.head_dim, spec.kv_heads * spec.head_dim

    def normal(shape, std):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(std).to(torch.bfloat16)

    def norm(shape):
        return (1.0 + normal(shape, NORM_SPREAD).float()).to(torch.bfloat16)

    w = {"embed": normal((V, E), SCALE)}
    if not spec.tied:
        w["lm_head"] = normal((V, E), SCALE)
    w["q"], w["k"], w["v"] = (normal((L, q_out, E), SCALE), normal((L, kv_out, E), SCALE),
                              normal((L, kv_out, E), SCALE))
    w["o"] = normal((L, E, q_out), SCALE)
    if spec.gated:
        w["gate"], w["up"] = normal((L, I, E), SCALE), normal((L, I, E), SCALE)
        w["down"] = normal((L, E, I), SCALE)
    else:
        w["fc1"], w["fc2"] = normal((L, I, E), SCALE), normal((L, E, I), SCALE)
    w["ln1"] = norm((L, E))
    if not spec.parallel_residual:
        w["ln2"] = norm((L, E))
    w["final_norm"] = norm((E,))
    if spec.qk_norm:
        w["q_norm"], w["k_norm"] = norm((L, spec.head_dim)), norm((L, spec.head_dim))
    if spec.biases:
        for name, n in (("q", q_out), ("k", kv_out), ("v", kv_out), ("o", E)):
            w[name + ".bias"] = normal((L, n), SCALE)
        w["fc1.bias"], w["fc2.bias"] = normal((L, I), SCALE), normal((L, E), SCALE)
        w["lm_head.bias"] = normal((V,), SCALE)
    if spec.layernorm:
        w["ln1.bias"] = normal((L, E), SCALE)
        if "ln2" in w:
            w["ln2.bias"] = normal((L, E), SCALE)
        w["final_norm.bias"] = normal((E,), SCALE)
    return w
