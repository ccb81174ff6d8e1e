"""SmoothQuant: fold activation outliers into the preceding norm (port of
``algorithms/smoothquant.py``).

Reference: quantization/calibrations/smoothquant/{core.py:28-141,
auto_scale.py:19-170}. Per layer: each tap's per-channel absmax over all
calibration tokens and the fed linears' column absmax give
s = clip(a^alpha / max(w, 1e-5)^(1 - alpha), 1e-5); the scale divides the
preceding norm's weight and bias and multiplies the linears' input
columns. The inputs advance through the layer before it is smoothed, as
the reference does. RTN finishes.

The scale-pair map is the reference's: OPT (OPT-350m has none, so only RTN
runs), BLOOM and the Llama / Qwen2 / Qwen3 family; Phi and every Gemma
raise.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..capture.pipeline import CalibContext, advance, run_layer
from ..device import full_f32_matmul
from ..models.config import ModelConfig
from ..models.transformer import layer_ops
from ..qformats.config import QuantConfig
from .common import fpow, get_weight, set_weight
from .rtn import rtn


def _scale_pairs(cfg: ModelConfig) -> List[Tuple[str, List[str], str]]:
    """(norm key, the linears it feeds, their tap) per supported family."""
    if cfg.arch == "opt":
        if cfg.project_in_dim is not None:   # OPT-350m: none in the reference
            return []
        return [("ln1", ["q", "k", "v"], "attn_in"), ("ln2", ["fc1"], "mlp_in")]
    if cfg.arch == "bloom":
        return [("ln1", ["qkv"], "attn_in"), ("ln2", ["fc1"], "mlp_in")]
    if cfg.arch in ("llama", "qwen2", "qwen3"):
        return [("ln1", ["q", "k", "v"], "attn_in"), ("ln2", ["gate", "up"], "mlp_in")]
    raise NotImplementedError(
        f"SmoothQuant scale map not defined for arch {cfg.arch!r} "
        "(parity with reference auto_scale.py:73-144)")


def _act_absmax(ctx: CalibContext, lp, layer_idx, ops, tap_keys):
    """Per-channel absmax of the tap activations over every token, float32."""
    acc = {}
    for _, _, _, taps in run_layer(ctx, lp, layer_idx, ops, tap_keys):
        for k, x in taps.items():
            m = torch.amax(torch.abs(x.reshape(-1, x.shape[-1]).float()), dim=0)
            acc[k] = m if k not in acc else torch.maximum(acc[k], m)
    return acc


def smooth_scales(a: torch.Tensor, w_max: torch.Tensor, alpha: float) -> torch.Tensor:
    """s = clip(a^alpha / max(w_max, 1e-5)^(1 - alpha), 1e-5), float32."""
    w_max = torch.clamp_min(w_max, 1e-5)
    return torch.clamp_min(fpow(a, alpha) / fpow(w_max, 1.0 - alpha), 1e-5)


@full_f32_matmul()
@torch.no_grad()
def smoothquant(params, cfg: ModelConfig, ctx: CalibContext, qcfg: QuantConfig,
                alpha: float = 0.5, mse: bool = False, scale_book: Optional[dict] = None,
                verbose: bool = True) -> None:
    """Smooth every layer in place, then RTN (``scale_book`` as for
    ``rtn``); ``ctx`` is advanced through the unsmoothed layers."""
    pairs = _scale_pairs(cfg)
    tap_keys = tuple(dict.fromkeys(t for _, _, t in pairs))
    for i, lp in enumerate(params["layers"]):
        ops = layer_ops(cfg, qcfg, i)
        act_max = _act_absmax(ctx, lp, i, ops, tap_keys)
        advance(ctx, lp, i, ops)
        for norm_key, slots, tap in pairs:
            w_max = None
            for slot in slots:
                wm = torch.amax(torch.abs(get_weight(lp, slot).float()), dim=0)
                w_max = wm if w_max is None else torch.maximum(w_max, wm)
            scales = smooth_scales(act_max[tap], w_max, alpha)
            norm = lp[norm_key]
            norm["weight"] = (norm["weight"].float() / scales).to(norm["weight"].dtype)
            if norm.get("bias") is not None:
                norm["bias"] = (norm["bias"].float() / scales).to(norm["bias"].dtype)
            for slot in slots:
                W = get_weight(lp, slot)
                set_weight(lp, slot, (W.float() * scales[None, :]).to(W.dtype))
    rtn(params, cfg, qcfg, mse=mse, scale_book=scale_book, verbose=False)
