"""The shapes and mechanisms of a configuration file, read from its
published ``config.json`` keys by the benchmark itself (the reference, the
weights and the roofline counters use this; the program reads the same
keys through its own parser).

Each ``model_type`` has a file of its own, ``families/<model_type>.py``,
whose ``spec(cfg)`` gives the :class:`Spec` of a configuration of that
family and refuses keys whose mechanism the reference does not model. A
family built of the mechanisms below is one new file; a new mechanism is
new code in the reference as well.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path

FAMILIES = Path(__file__).resolve().parent / "families"


@dataclass(frozen=True)
class Spec:
    layers: int
    hidden: int
    ffn: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    rope_theta: float
    rotary_dim: int        # rope on the first rotary_dim dims of a head, rotate-half
    eps: float
    tied: bool             # the head is the embedding table
    act: str               # "silu" or "gelu_tanh"
    gated: bool            # act(gate) * up, else fc2(act(fc1))
    qk_norm: bool          # RMS norms on q and k per head, before rope
    layernorm: bool        # LayerNorm with biases, else RMS norm
    parallel_residual: bool  # attention and MLP read one norm (no ln2)
    biases: bool           # every linear and the untied head carry a bias


def spec_of(cfg: dict) -> Spec:
    """The Spec of a configuration file's published keys."""
    mt = cfg["model_type"]
    path = FAMILIES / f"{mt}.py"
    if not path.is_file():
        raise ValueError(f"model_type {mt!r} has no file portbench/families/{mt}.py")
    mod_spec = importlib.util.spec_from_file_location(f"portbench_family_{mt}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.spec(cfg)
