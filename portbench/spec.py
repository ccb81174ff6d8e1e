"""The shapes and mechanisms of a configuration file, read from its
published ``config.json`` keys by the benchmark itself (the reference, the
weights and the roofline counters use this; the program reads the same
keys through its own parser).

Each ``model_type`` has a file of its own, ``families/<model_type>.py``,
whose ``spec(cfg)`` gives the :class:`Spec` of a configuration of that
family (or a frozen dataclass of its own, such as a subclass with further
fields) and refuses keys whose mechanism its reference does not model. The
file may also bring the hooks that ``portbench/family.py`` lists, for the
mechanisms this Spec does not name.
"""

from __future__ import annotations

import functools
import importlib.util
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

# where a model_type's family file is looked up (the tests point it elsewhere)
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


@functools.lru_cache(maxsize=None)
def _load(path: Path) -> ModuleType:
    # registered under its name, as an imported module is (a dataclass in the
    # file looks its module up there)
    name = f"portbench_family_{path.parent.name}_{path.stem}"
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def family_of(cfg: dict) -> ModuleType:
    """The family file of a configuration's ``model_type``, loaded once."""
    mt = cfg["model_type"]
    path = FAMILIES / f"{mt}.py"
    if not path.is_file():
        raise ValueError(f"model_type {mt!r} has no file portbench/families/{mt}.py")
    return _load(path)


def spec_of(cfg: dict) -> Spec:
    """The Spec of a configuration file's published keys."""
    return family_of(cfg).spec(cfg)
