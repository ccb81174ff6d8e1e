"""Layerwise calibration pipeline (port of ``capture/pipeline.py``): capture
the layer-0 inputs, run one layer chunk by chunk with taps on its linears'
inputs, accumulate Hessians, advance the inputs to the next layer.

Hessian normalization as in the reference (gptq/core.py:114-119):
H = (2 / n_samples) * sum over tokens of x x^T, with n_samples counting
sequences, not tokens, summed in full float32 (TF32 off: see
:func:`~..device.full_f32_matmul`). Chunks hold ``chunk`` samples (8, as
in the JAX package), which bounds the attention's (chunk, heads, T, T)
float32 scores. ``layer_taps`` materialises a layer's tap activations
(AWQ); ``accumulate_scaler_rows`` sums their squares per channel (Wanda,
RIA).

``advance`` writes the next layer's inputs over ``ctx.hidden`` in place,
where the JAX version rebinds an immutable array. A tap is a view of the
chunk it was taken from (OPT-350m's post-norm taps ``attn_in`` on the layer
input itself), so whatever holds a tap across an ``advance`` owns a copy:
``layer_taps`` concatenates, which copies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..device import full_f32_matmul
from ..models.config import ModelConfig
from ..models.transformer import (
    LayerOps,
    decoder_layer,
    embed,
    make_causal_mask,
    rope_for_layer,
)

TAP_KEYS = ("attn_in", "o_in", "mlp_in", "down_in")

# which tap feeds which linear slot
SLOT_TAP = {
    "q": "attn_in", "k": "attn_in", "v": "attn_in", "qkv": "attn_in",
    "o": "o_in",
    "gate": "mlp_in", "up": "mlp_in", "fc1": "mlp_in",
    "down": "down_in", "fc2": "down_in",
}


@dataclass
class CalibContext:
    """Calibration state: the current layer's inputs and their positions."""

    cfg: ModelConfig
    hidden: torch.Tensor       # (N, T, hidden) inputs to the current layer
    positions: torch.Tensor    # (N, T)
    chunk: int = 8             # samples per step

    def chunks(self):
        n = self.hidden.shape[0]
        for s in range(0, n, self.chunk):
            yield s, min(s + self.chunk, n)


def capture_layer0(params, cfg: ModelConfig, tokens, chunk: int = 8) -> CalibContext:
    """Embed the calibration tokens (N, T) — numpy or a tensor — into the
    layer-0 inputs, on the params' device."""
    dev = params["embed"]["weight"].device
    tokens = torch.as_tensor(tokens, device=dev)
    N, T = tokens.shape
    positions = torch.arange(T, device=dev)[None, :].expand(N, T)
    outs = [embed(params, cfg, tokens[s:min(s + chunk, N)], positions[s:min(s + chunk, N)])
            for s in range(0, N, chunk)]
    return CalibContext(cfg=cfg, hidden=torch.cat(outs, 0), positions=positions, chunk=chunk)


@torch.no_grad()
def run_layer(ctx: CalibContext, layer_params, layer_idx: int,
              ops: Optional[LayerOps] = None, tap_keys: Tuple[str, ...] = ()):
    """Yield (start, end, out_chunk, taps_chunk) for each calibration chunk,
    with the layer's own rope and mask (Gemma2/3's local layers)."""
    cfg = ctx.cfg
    for s, e in ctx.chunks():
        pos = ctx.positions[s:e]
        cos, sin = rope_for_layer(cfg, layer_idx, pos)
        mask = make_causal_mask(cfg, layer_idx, pos, pos)
        taps: dict = {}
        y = decoder_layer(layer_params, cfg, ctx.hidden[s:e], cos, sin, mask, ops, taps)
        yield s, e, y, {k: taps[k] for k in tap_keys if k in taps}


def advance(ctx: CalibContext, layer_params, layer_idx: int,
            ops: Optional[LayerOps] = None) -> None:
    """Propagate ``ctx.hidden`` through the (already updated) layer. The
    outputs overwrite the inputs chunk by chunk, in place: each chunk's
    inputs are read before its outputs are written, and chunks are
    independent."""
    for s, e, y, _ in run_layer(ctx, layer_params, layer_idx, ops):
        ctx.hidden[s:e] = y


def _hessian_chunk(x: torch.Tensor) -> torch.Tensor:
    """Sum over tokens of x x^T for a (B, T, C) chunk, in float32."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    return x2.t() @ x2


def accumulate_hessian(ctx: CalibContext, layer_params, layer_idx: int,
                       tap_keys: Tuple[str, ...], ops: Optional[LayerOps] = None,
                       collect_outputs: bool = False):
    """One pass over the calibration set accumulating, per tap key,
    H = (2 / n_samples) * sum_tokens x x^T (JAX :136-160). Returns
    (hessians {tap: (C, C) f32}, outs): with ``collect_outputs`` the
    layer's outputs (N, T, hidden), concatenated over the chunks, else
    None."""
    n_samples = ctx.hidden.shape[0]
    H: Dict[str, torch.Tensor] = {}
    outs = [] if collect_outputs else None
    with full_f32_matmul():
        for _, _, y, taps in run_layer(ctx, layer_params, layer_idx, ops, tap_keys):
            for k, x in taps.items():
                h = _hessian_chunk(x)
                H[k] = h if k not in H else H[k] + h
            if collect_outputs:
                outs.append(y)
    return ({k: 2.0 * v / n_samples for k, v in H.items()},
            torch.cat(outs, 0) if collect_outputs else None)


def layer_taps(ctx: CalibContext, layer_params, layer_idx: int,
               ops: Optional[LayerOps] = None,
               tap_keys: Tuple[str, ...] = TAP_KEYS) -> Dict[str, torch.Tensor]:
    """Every tap activation of one layer, concatenated over the samples
    (AWQ and SmoothQuant read the whole input feature). The result owns its
    storage: it outlives an ``advance`` of ``ctx``."""
    acc: Dict[str, list] = {k: [] for k in tap_keys}
    for _, _, _, taps in run_layer(ctx, layer_params, layer_idx, ops, tap_keys):
        for k, v in taps.items():
            acc[k].append(v)
    return {k: torch.cat(v, 0) for k, v in acc.items() if v}


def _sqnorm_chunk(x: torch.Tensor) -> torch.Tensor:
    """Sum over tokens of x_c^2 per channel for a (B, T, C) chunk, in float32."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    return torch.sum(x2 * x2, dim=0)


def accumulate_scaler_rows(ctx: CalibContext, layer_params, layer_idx: int,
                           tap_keys: Tuple[str, ...],
                           ops: Optional[LayerOps] = None) -> Dict[str, torch.Tensor]:
    """The Wanda / RIA channel statistic per tap key: sum over tokens of
    x_c^2 / n_samples (reference wanda/core.py:92-113: the running mean over
    one sample per hook call), float32."""
    n_samples = ctx.hidden.shape[0]
    acc: Dict[str, torch.Tensor] = {}
    for _, _, _, taps in run_layer(ctx, layer_params, layer_idx, ops, tap_keys):
        for k, x in taps.items():
            v = _sqnorm_chunk(x)
            acc[k] = v if k not in acc else acc[k] + v
    return {k: v / n_samples for k, v in acc.items()}
