"""SpinQuant — rotation-based outlier suppression, then GPTQ (port of
``algorithms/spinquant.py``, Hadamard mode).

Reference: spinquant/{core.py:45-165, rotation_utils.py:20-161,
fuse_norm_utils.py:5-61}. Pipeline:

1. untie the embeddings (core.py:151-154);
2. fuse the RMSNorm weights into the following linears and recenter the
   embedding rows (fuse_norm_utils.py:29-61);
3. rotate: R1 (hidden x hidden) on the embedding, head, q/k/v/gate/up
   inputs and o/down outputs; a per-layer R2 (head_dim) on V's output
   rows and O's input columns, per head (rotation_utils.py:57-159);
4. GPTQ on the rotated model.

Steps 2 and 3 run in float64 on the params' device, each product cast
once to the params' dtype, as the JAX package's host float64 (the
reference's ``.double()``) does. ``mode="hadamard"`` draws randomized
orthonormal Hadamard matrices (B10, ``kernels/hadamard.py``) with signs
from a CPU ``torch.Generator`` seeded with ``seed``, so the card and the
CPU draw the same rotations; a ``rotation_path`` holding ``R.npz`` (the
JAX package's format) supplies them instead. ``mode="optimize"`` (Cayley
SGD through the straight-through quantized forward) is not ported yet.
Llama family only, as the reference (core.py:63-71).
"""

from __future__ import annotations

import time
from dataclasses import replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..capture.pipeline import capture_layer0
from ..kernels.hadamard import random_hadamard_matrix
from ..models.config import ModelConfig
from ..qformats.config import QuantConfig
from .common import PhaseTimer, get_bias, get_weight, set_bias, set_weight
from .gptq import gptq


def fuse_layer_norms(params, cfg: ModelConfig) -> None:
    """Fold the RMSNorm weights into the following linears and recenter the
    embedding rows, in float64 (in place)."""
    dt = params["embed"]["weight"].dtype
    E = params["embed"]["weight"].double()
    params["embed"]["weight"] = (E - E.mean(-1, keepdim=True)).to(dt)
    del E
    for lp in params["layers"]:
        for norm_key, slots in (("ln1", ("q", "k", "v")), ("ln2", ("gate", "up"))):
            w_norm = lp[norm_key]["weight"].double()
            for slot in slots:
                set_weight(lp, slot, (get_weight(lp, slot).double() * w_norm[None, :]).to(dt))
            lp[norm_key]["weight"] = torch.ones_like(lp[norm_key]["weight"])
    if "final_norm" in params and "lm_head" in params:
        w_norm = params["final_norm"]["weight"].double()
        params["lm_head"]["weight"] = (params["lm_head"]["weight"].double()
                                       * w_norm[None, :]).to(dt)
        params["final_norm"]["weight"] = torch.ones_like(params["final_norm"]["weight"])


def _rotate_params(params, cfg: ModelConfig, R1, R2s) -> None:
    """Apply R1 and the per-layer R2s to every weight, in float64 (in
    place). ``R1`` / ``R2s`` are tensors or numpy arrays."""
    dev = params["embed"]["weight"].device
    dt = params["embed"]["weight"].dtype
    R1 = torch.as_tensor(R1, dtype=torch.float64, device=dev)
    d, kvh, H = cfg.head_dim, cfg.num_kv_heads, cfg.num_heads

    for key in ("embed", "lm_head"):
        params[key]["weight"] = (params[key]["weight"].double() @ R1).to(dt)
    for i, lp in enumerate(params["layers"]):
        for slot in ("q", "k", "v", "gate", "up"):
            set_weight(lp, slot, (get_weight(lp, slot).double() @ R1).to(dt))
        for slot in ("o", "down"):
            set_weight(lp, slot, (R1.t() @ get_weight(lp, slot).double()).to(dt))
            b = get_bias(lp, slot)
            if b is not None:
                set_bias(lp, slot, (R1.t() @ b.double()).to(dt))
        R2 = torch.as_tensor(R2s[i], dtype=torch.float64, device=dev)
        # V: rotate each head's OUTPUT rows (rotation_utils.py:113-118)
        Wv = get_weight(lp, "v").double()
        Wv = torch.einsum("hdi,de->hei", Wv.reshape(kvh, d, -1), R2).reshape(Wv.shape)
        set_weight(lp, "v", Wv.to(dt))
        # O: rotate each head's INPUT columns
        Wo = get_weight(lp, "o").double()
        Wo = torch.einsum("ohd,de->ohe", Wo.reshape(-1, H, d), R2).reshape(Wo.shape)
        set_weight(lp, "o", Wo.to(dt))


def _untie(params, cfg: ModelConfig) -> ModelConfig:
    if "lm_head" not in params:
        params["lm_head"] = {"weight": params["embed"]["weight"].clone()}
        cfg = replace(cfg, tie_word_embeddings=False)
    return cfg


def load_rotations(path, cfg: ModelConfig):
    data = np.load(Path(path))
    return data["R1"], [data[f"R2.{i}"] for i in range(cfg.num_layers)]


def save_rotations(path, R1, R2s) -> None:
    as_np = lambda r: r.cpu().numpy() if torch.is_tensor(r) else np.asarray(r)
    np.savez(Path(path), R1=as_np(R1), **{f"R2.{i}": as_np(r) for i, r in enumerate(R2s)})


def hadamard_rotations(cfg: ModelConfig, seed: int, device):
    """R1 (hidden) and one R2 (head_dim) per layer: randomized Hadamard
    matrices, signs from a CPU generator seeded with ``seed``, transforms
    on ``device`` (1 + num_layers launches of B10 on the card)."""
    gen = torch.Generator().manual_seed(seed)
    R1 = random_hadamard_matrix(cfg.hidden_size, gen, device=device).double()
    R2s = [random_hadamard_matrix(cfg.head_dim, gen, device=device).double()
           for _ in range(cfg.num_layers)]
    return R1, R2s


def spinquant(params, cfg: ModelConfig, calib_tokens, qcfg: QuantConfig,
              mode: str = "hadamard", rotation_path: Optional[str] = None,
              mse: bool = False, seed: int = 0, chunk: int = 8,
              scale_book: Optional[dict] = None,
              timings: Optional[PhaseTimer] = None) -> ModelConfig:
    """Rotate, then GPTQ, in place. Returns the untied ModelConfig: rebind
    it for later forwards. ``scale_book`` records the GPTQ parameters for a
    lossless ``pack_model``; ``timings`` collects seconds for ``rotation``
    and for GPTQ's ``hessians`` (capture included) and ``updates``."""
    if cfg.arch not in ("llama",):
        raise NotImplementedError(
            f"SpinQuant supports the llama family only (reference core.py:63-71), got {cfg.arch}")
    if mode == "optimize":
        raise NotImplementedError(
            "SpinQuant mode='optimize' (Cayley SGD through the straight-through quantized "
            "forward) is not ported yet: ROADMAP.md queue A item 9c")
    if mode != "hadamard":
        raise ValueError(f"unknown SpinQuant mode {mode!r}")
    dev = params["embed"]["weight"].device
    t = time.perf_counter()

    cfg = _untie(params, cfg)
    if rotation_path and (Path(rotation_path) / "R.npz").is_file():
        R1, R2s = load_rotations(Path(rotation_path) / "R.npz", cfg)
    else:
        R1, R2s = hadamard_rotations(cfg, seed, dev)
    fuse_layer_norms(params, cfg)
    _rotate_params(params, cfg, R1, R2s)
    del R1, R2s
    if timings is not None:
        t = timings.add("rotation", t, dev)

    ctx = capture_layer0(params, cfg, calib_tokens, chunk=chunk)
    if timings is not None:
        timings.add("hessians", t, dev)
    gptq(params, cfg, ctx, qcfg, mse=mse, scale_book=scale_book, timings=timings)
    return cfg
