"""A model family's hooks: what the harness takes from
``families/<model_type>.py`` beside its ``spec(cfg)``.

A family file may define any of these names; where it leaves one out, the
harness uses the default named here, which is the code the benchmark ran
before families had hooks:

* ``draw(spec, seed, device)`` -> {name: bf16 tensor}, the seed's float
  weights on the device (default ``weights.draw``);
* ``params(spec, W)`` -> the params tree that the program's
  ``from_hf_config`` config serves (default :func:`to_params`); the
  harness then runs RTN, ``pack_model``, ``fuse_model``, ``stack_model``;
* ``logits(spec, W, samples, bits)`` -> per sample the f32 logits of its
  checked positions: the plain reference, a file of its own under
  ``reference/`` that imports nothing of the program (default
  ``reference/model.py::logits``); ``check``, the control and
  ``calibrate.py`` all go through it;
* ``bits_of(recipe)`` -> the precision of each stage, refusing what the
  family's reference does not model (default ``reference/model.py::bits_of``,
  whose ``own`` names the recipe keys a family adds), and
  ``control_of(bits)`` -> the control's (default every 8-bit stage at 4);
* ``Counters``: the bytes and operations of a step (a subclass of
  ``roofline.Counters``, which is the default), read by every roofline
  and ``mfu`` metric;
* ``init_cache(ctx, batch, max_len)`` -> the program's cache for
  ``batch`` slots of ``max_len`` rows, and ``splice(cache, group, j,
  slot)``, which copies slot ``j`` of a group's cache into ``slot`` (the
  drivers' only ways to make and fill a cache; defaults
  :func:`init_cache`, :func:`splice`);
* ``TINY``: the published keys changed for the CPU tests' tiny size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from . import roofline, weights
from .reference import model as reference
from .spec import Spec, family_of


def to_params(spec: Spec, W: Dict[str, torch.Tensor]) -> dict:
    """The program's params tree (per-layer dicts of views into ``W``)."""
    def entry(name, i=None):
        pick = (lambda t: t) if i is None else (lambda t: t[i])
        d = {"weight": pick(W[name])}
        if name + ".bias" in W:
            d["bias"] = pick(W[name + ".bias"])
        return d

    layers = []
    for i in range(spec.layers):
        attn = {s: entry(s, i) for s in ("q", "k", "v", "o")}
        if spec.qk_norm:
            attn["q_norm"], attn["k_norm"] = entry("q_norm", i), entry("k_norm", i)
        mlp = {s: entry(s, i) for s in (("gate", "up", "down") if spec.gated else ("fc1", "fc2"))}
        lp = {"ln1": entry("ln1", i), "attn": attn, "mlp": mlp}
        if "ln2" in W:
            lp["ln2"] = entry("ln2", i)
        layers.append(lp)
    params = {"embed": {"weight": W["embed"]}, "layers": layers, "final_norm": entry("final_norm")}
    if not spec.tied:
        params["lm_head"] = entry("lm_head")
    return params


def init_cache(ctx, batch: int, max_len: int):
    """The program's KV cache over every layer, int8 where the recipe's is."""
    from llm_compressor_tpu_torch import engine

    spec = ctx.spec
    return engine.init_cache(spec.layers, batch, max_len, spec.kv_heads, spec.head_dim,
                             quantized=ctx.bits.kv is not None, device=ctx.device)


def splice(cache, group, j: int, slot: int) -> None:
    """Slot ``j`` of the cache ``group`` into slot ``slot`` of ``cache``."""
    from llm_compressor_tpu_torch.engine import kvcache

    kvcache.write_slot(cache, slot, group.k[:, j], group.v[:, j],
                       group.k_scale[:, j], group.v_scale[:, j])


@dataclass(frozen=True)
class Family:
    """The hooks of one family file, each its own or the default."""
    spec: Callable
    draw: Callable
    params: Callable
    logits: Callable
    bits_of: Callable
    control_of: Callable
    counters: Callable
    init_cache: Callable
    splice: Callable
    tiny: Optional[dict]


def of(config: dict) -> Family:
    """The hooks of a configuration file's family."""
    mod = family_of(config)
    return Family(spec=mod.spec,
                  draw=getattr(mod, "draw", weights.draw),
                  params=getattr(mod, "params", to_params),
                  logits=getattr(mod, "logits", reference.logits),
                  bits_of=getattr(mod, "bits_of", reference.bits_of),
                  control_of=getattr(mod, "control_of", reference.control_of),
                  counters=getattr(mod, "Counters", roofline.Counters),
                  init_cache=getattr(mod, "init_cache", init_cache),
                  splice=getattr(mod, "splice", splice),
                  tiny=getattr(mod, "TINY", None))
