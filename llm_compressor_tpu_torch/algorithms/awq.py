"""AWQ: activation-aware weight scaling and per-group weight clipping (port
of ``algorithms/awq.py``).

Reference: quantization/calibrations/awq/{core.py:26-158,
auto_scale.py:23-353, auto_clip.py:15-101}. Per layer:

1. every linear's input activations (``layer_taps``, all samples);
2. the inputs advance through the ORIGINAL layer (core.py:111-113);
3. scale search per scale pair: 20 grid points s = mean|x|^ratio
   normalised by sqrt(max(s) min(s)), loss the mean squared difference
   of the inspected module's output over all samples at once, with the
   pair's weights quantized as W * s -> / s; the first strictly smaller
   loss wins;
4. clip search per linear but q / k / qkv: per (row, group) the max of
   |W| shrunk over 10 grid points, error measured on the group's partial
   products x . w of 512 sampled tokens (auto_clip.py:16-66);
5. the scale folded into the preceding norm or linear, the clip applied,
   RTN last.

The scale-pair maps are the reference's (auto_scale.py:145-310), OPT-350m's
special case and the missing Gemma-1 map (raises) included. As in the
reference, the cached input of a scaled linear is divided by s once per
linear of the pair, so the tap of q, k and v is divided three times.

Roundings as in the JAX package: the search quantizes through the jitted
``quantize_dequant``; ``_clip_search_chunk`` is jitted whole there, and
XLA's CPU backend computes its shrink factor 1 - i/20 as one fused
multiply-add with the float32 reciprocal of 20 (``_shrink``); the search's
own ``W * s / s`` and ``s / sqrt(max * min)`` run eagerly, true divisions.
Powers are taken as ``common.fpow``. The sums (the channel mean, the
losses) run in PyTorch's order, so two nearly equal losses may order
differently from JAX's (tests/test_torch_awq.py states the tie rule).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..capture.pipeline import CalibContext, advance, layer_taps
from ..device import full_f32_matmul
from ..models.config import ModelConfig
from ..models.layers import qlinear
from ..models.transformer import (
    arch_slots,
    attention,
    decoder_layer,
    layer_ops,
    make_causal_mask,
    mlp,
    rope_for_layer,
)
from ..qformats.config import QuantConfig
from ..qformats.quantize import _fma, quantize_dequant
from .common import (
    PhaseTimer,
    copy_tree,
    fpow,
    get_bias,
    get_weight,
    set_bias,
    set_weight,
    slot_tap,
    weight_quantizer_for,
)
from .rtn import rtn


@dataclass(frozen=True)
class ScalePair:
    prev_kind: str          # "norm" | "fc"
    prev_key: str           # norm param key or fc slot
    slots: Tuple[str, ...]  # linears receiving the column scale
    tap: str                # input_feat key
    inspect: str            # "attn" | "mlp" | "layer" | "linear"


def scale_pairs(cfg: ModelConfig, lp) -> List[ScalePair]:
    """The scale pairs of one layer (reference auto_scale.py:145-310)."""
    a = cfg.arch
    if a == "opt":
        if cfg.project_in_dim is not None:  # OPT-350m
            return [ScalePair("fc", "v", ("o",), "o_in", "linear")]
        return [
            ScalePair("norm", "ln1", ("q", "k", "v"), "attn_in", "attn"),
            ScalePair("fc", "v", ("o",), "o_in", "linear"),
            ScalePair("norm", "ln2", ("fc1",), "mlp_in", "linear"),
        ]
    if a == "bloom":
        return [
            ScalePair("norm", "ln1", ("qkv",), "attn_in", "layer"),
            ScalePair("norm", "ln2", ("fc1",), "mlp_in", "layer"),
        ]
    if a in ("llama", "qwen2", "qwen3"):
        pairs = [ScalePair("norm", "ln1", ("q", "k", "v"), "attn_in", "attn")]
        if get_weight(lp, "v").shape == get_weight(lp, "o").shape:
            pairs.append(ScalePair("fc", "v", ("o",), "o_in", "linear"))
        pairs.append(ScalePair("norm", "ln2", ("gate", "up"), "mlp_in", "mlp"))
        pairs.append(ScalePair("fc", "up", ("down",), "down_in", "linear"))
        return pairs
    if a == "phi":
        return [
            ScalePair("norm", "ln1", ("q", "k", "v"), "attn_in", "attn"),
            ScalePair("fc", "v", ("o",), "o_in", "linear"),
            ScalePair("fc", "o", ("fc1",), "mlp_in", "linear"),
        ]
    if a in ("gemma2", "gemma3"):
        pairs = []
        if get_weight(lp, "v").shape == get_weight(lp, "o").shape:
            pairs.append(ScalePair("fc", "v", ("o",), "o_in", "linear"))
        pairs.append(ScalePair("fc", "up", ("down",), "down_in", "linear"))
        return pairs
    raise NotImplementedError(
        f"AWQ scale map not defined for arch {a!r} (reference auto_scale.py:145-310)")


# ---------------------------------------------------------------------------
# Scale search (reference auto_scale.py:71-125)
# ---------------------------------------------------------------------------


def _inspect_out(cfg, lp, ops, inspect: str, slot0: str, x, cos, sin, mask):
    if inspect == "attn":
        return attention(lp, cfg, x, cos, sin, mask, ops)
    if inspect == "mlp":
        return mlp(lp, cfg, x, ops)
    if inspect == "layer":
        return decoder_layer(lp, cfg, x, cos, sin, mask, ops)
    op = ops.get(slot0) if ops is not None else None
    return qlinear(x, get_weight(lp, slot0), get_bias(lp, slot0), op)


def _with_scaled_weights(lp, cfg: ModelConfig, slots, scales, quantizers):
    """A copy of the layer params with W -> quantize(W * s) / s for the slots."""
    new = copy_tree(lp)
    for slot in slots:
        W = get_weight(new, slot)
        Ws = W.float() * scales[None, :]
        q = quantizers[slot]
        if q.qtype != "dummy":
            Ws = quantize_dequant(q, Ws)
        set_weight(new, slot, (Ws / scales[None, :]).to(W.dtype))
    return new


def _scale_grid(cfg, lp, ops, pair: ScalePair, x, cos, sin, mask, quantizers,
                n_grid: int = 20):
    """[(loss, scales)] of every grid point, ratio r / n_grid in order."""
    x_mean = torch.mean(torch.abs(x.float().reshape(-1, x.shape[-1])), dim=0)
    org_out = _inspect_out(cfg, lp, ops, pair.inspect, pair.slots[0], x, cos, sin, mask).float()
    grid = []
    for r in range(n_grid):
        s = torch.clamp_min(fpow(x_mean, r / n_grid), 1e-4)
        s = s / torch.sqrt(torch.max(s) * torch.min(s))
        lp_s = _with_scaled_weights(lp, cfg, pair.slots, s, quantizers)
        out = _inspect_out(cfg, lp_s, ops, pair.inspect, pair.slots[0], x, cos, sin, mask)
        grid.append((float(torch.mean((org_out - out.float()) ** 2)), s))
        del out, lp_s
    return grid


def _search_scale(cfg, lp, ops, pair: ScalePair, x, cos, sin, mask, quantizers,
                  n_grid: int = 20):
    """The grid point of least loss (the first on equal losses)."""
    best_loss, best_scales = float("inf"), None
    for loss, s in _scale_grid(cfg, lp, ops, pair, x, cos, sin, mask, quantizers, n_grid):
        if loss < best_loss:
            best_loss, best_scales = loss, s
    return best_scales


def _apply_scale(lp, cfg: ModelConfig, pair: ScalePair, scales):
    """Fold the scale into the layer (reference auto_scale.py:29-65)."""
    if pair.prev_kind == "norm":
        norm = lp[pair.prev_key]
        norm["weight"] = (norm["weight"].float() / scales).to(norm["weight"].dtype)
        if norm.get("bias") is not None:
            norm["bias"] = (norm["bias"].float() / scales).to(norm["bias"].dtype)
    else:   # fc -> fc: the last len(scales) output rows of the previous linear
        Wp = get_weight(lp, pair.prev_key)
        n = scales.shape[0]
        Wp32 = Wp.float()
        Wp32 = torch.cat([Wp32[:-n], Wp32[-n:] / scales[:, None]], 0)
        set_weight(lp, pair.prev_key, Wp32.to(Wp.dtype))
        bp = get_bias(lp, pair.prev_key)
        if bp is not None:
            set_bias(lp, pair.prev_key, (bp.float() / scales).to(bp.dtype))
    for slot in pair.slots:
        W = get_weight(lp, slot)
        set_weight(lp, slot, (W.float() * scales[None, :]).to(W.dtype))


# ---------------------------------------------------------------------------
# Clip search (reference auto_clip.py:15-66)
# ---------------------------------------------------------------------------


# the slots whose clip search is skipped: the reference's q_/k_/query/key/
# Wqkv names, by slot (JAX ``algorithms/awq.py:171``)
CLIP_SKIP_SUBSTRINGS = ("q", "k", "qkv")


def _clip_skip(slot: str) -> bool:
    return slot in CLIP_SKIP_SUBSTRINGS


def _shrink(i: int, n_grid: int) -> float:
    """1 - i / n_grid as XLA's CPU backend computes it inside the jitted
    search: fma(-i, f32(1 / n_grid), 1), one rounding."""
    rcp = torch.tensor(1.0 / n_grid, dtype=torch.float32)
    return float(_fma(torch.tensor(-float(i), dtype=torch.float32), rcp,
                      torch.tensor(1.0, dtype=torch.float32)))


def _clip_errors(w, xg, quantizer, n_grid: int = 20, max_shrink: float = 0.5):
    """w (oc, n_g, g), xg (T', n_g, g) -> (best max, its error, the
    unclipped error), each (oc, n_g): the first strictly smaller error
    wins."""
    w32 = w.float()
    x32 = xg.float()
    org_max = torch.amax(torch.abs(w32), dim=-1, keepdim=True)           # (oc, n_g, 1)
    org_out = torch.einsum("tgc,ogc->otg", x32, w32)
    best_max = org_max
    min_err = torch.full_like(org_max, float("inf"))
    err0 = None
    for i_s in range(int(max_shrink * n_grid)):
        mv = org_max * _shrink(i_s, n_grid)
        q_w = quantize_dequant(quantizer, torch.clamp(w32, -mv, mv))
        cur_out = torch.einsum("tgc,ogc->otg", x32, q_w)
        err = torch.mean((cur_out - org_out) ** 2, dim=1)[:, :, None]   # (oc, n_g, 1)
        take = err < min_err
        best_max = torch.where(take, mv, best_max)
        min_err = torch.where(take, err, min_err)
        err0 = err if err0 is None else err0
    return best_max[..., 0], min_err[..., 0], err0[..., 0]


def _clip_search_chunk(w, xg, quantizer, n_grid: int = 20, max_shrink: float = 0.5):
    """w (oc, n_g, g), xg (T', n_g, g) -> the best max per (oc, n_g)."""
    return _clip_errors(w, xg, quantizer, n_grid, max_shrink)[0]


def _auto_clip(lp, cfg, qcfg, layer_idx, slot, inp, mse, n_sample_token=512, oc_chunk=256):
    q = weight_quantizer_for(cfg, qcfg, layer_idx, slot, False)
    gs = q.group_size
    if q.qtype == "dummy" or gs in (0, -1, -2):
        return None
    W = get_weight(lp, slot)
    O, C = W.shape
    x = inp.reshape(-1, C)
    x = x[::max(1, x.shape[0] // n_sample_token)]
    xg = x.reshape(x.shape[0], C // gs, gs)
    wg = W.reshape(O, C // gs, gs)
    step = oc_chunk if O % oc_chunk == 0 else O
    return torch.cat([_clip_search_chunk(wg[i:i + step], xg, quantizer=q)
                      for i in range(0, O, step)], 0)   # (O, n_g)


def _apply_clip(lp, slot, best_max):
    W = get_weight(lp, slot)
    O, C = W.shape
    n_g = best_max.shape[1]
    Wg = W.float().reshape(O, n_g, C // n_g)
    Wg = torch.clamp(Wg, -best_max[..., None], best_max[..., None])
    set_weight(lp, slot, Wg.reshape(O, C).to(W.dtype))


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


@full_f32_matmul()
@torch.no_grad()
def awq(params, cfg: ModelConfig, ctx: CalibContext, qcfg: QuantConfig,
        mse: bool = False, do_clip: bool = True, finish_rtn: bool = True,
        scale_book: Optional[dict] = None, verbose: bool = True,
        timings: Optional[PhaseTimer] = None) -> None:
    """Scale and clip every layer in place, then RTN (``scale_book`` as for
    ``rtn``). ``timings`` collects seconds for ``taps`` (the tap pass and
    ``advance``), ``scale search`` (search and fold), ``clip search`` and
    ``rtn``."""
    dev = ctx.hidden.device
    t = time.perf_counter()

    def tick(name):
        return t if timings is None else timings.add(name, t, dev)

    for i, lp in enumerate(params["layers"]):
        ops = layer_ops(cfg, qcfg, i)
        pairs = scale_pairs(cfg, lp)
        tap_keys = tuple(dict.fromkeys(
            [p.tap for p in pairs] + [slot_tap(s) for s in arch_slots(cfg)]))
        feats = layer_taps(ctx, lp, i, ops, tap_keys)
        advance(ctx, lp, i, ops)   # the ORIGINAL layer (core.py:111-113)
        t = tick("taps")

        quantizers = {s: weight_quantizer_for(cfg, qcfg, i, s, False) for s in arch_slots(cfg)}
        for pair in pairs:
            x = feats[pair.tap]
            p = ctx.positions[:x.shape[0]]
            cos, sin = rope_for_layer(cfg, i, p)
            mask = make_causal_mask(cfg, i, p, p)
            s = _search_scale(cfg, lp, ops, pair, x, cos, sin, mask, quantizers)
            _apply_scale(lp, cfg, pair, s)
            # the scaled linears' cached inputs (auto_scale.py:344-347)
            for slot in pair.slots:
                k = slot_tap(slot)
                feats[k] = (feats[k].float() / s).to(feats[k].dtype)
        t = tick("scale search")

        if do_clip:
            for slot in arch_slots(cfg):
                if _clip_skip(slot):
                    continue
                best = _auto_clip(lp, cfg, qcfg, i, slot, feats[slot_tap(slot)], mse)
                if best is not None:
                    _apply_clip(lp, slot, best)
        del feats
        t = tick("clip search")

    if finish_rtn:
        rtn(params, cfg, qcfg, mse=mse, scale_book=scale_book, verbose=False)
        tick("rtn")


def awq_plus(params, cfg: ModelConfig, ctx: CalibContext, gptq_ctx: CalibContext,
             qcfg: QuantConfig, mse: bool = False, scale_book: Optional[dict] = None,
             verbose: bool = True) -> None:
    """AWQ+: AWQ's scale and clip, then GPTQ instead of RTN (reference
    awq_plus/core.py:26-160); ``gptq_ctx`` carries the GPTQ stage's own
    calibration inputs."""
    from .gptq import gptq

    awq(params, cfg, ctx, qcfg, mse=mse, finish_rtn=False, verbose=verbose)
    gptq(params, cfg, gptq_ctx, qcfg, mse=mse, scale_book=scale_book)
