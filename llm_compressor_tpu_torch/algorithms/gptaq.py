"""GPTAQ: GPTQ with the asymmetric-error correction (port of
``algorithms/gptaq.py``).

Reference: quantization/calibrations/gptaq/core.py:24-335. A second,
full-precision stream of layer inputs runs through the ORIGINAL layers
(gptaq/core.py:96-99) beside the quantized stream; per sequential group
the two give H = 2/n sum x x^T and the cross term
dXXT = 2/n sum (x_fp - x) x^T, and ``gptaq_update_with_params`` adds
P = alpha * triu(dXXT @ Hinv^T, 1) @ Hinv to every propagation step.

``advance`` overwrites a stream's inputs in place, so the full-precision
stream starts as a copy of the quantized one (the JAX version can share
the first array: it rebinds instead of writing). The original layer is a
copy of the layer's dicts (``copy_tree``): the updates replace entries,
they do not write into the tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..capture.pipeline import CalibContext, advance, run_layer
from ..device import full_f32_matmul
from ..models.config import ModelConfig
from ..models.transformer import layer_ops
from ..qformats.config import QuantConfig
from .common import (
    copy_tree,
    get_weight,
    quantize_head_weight,
    sequential_groups,
    set_weight,
    slot_tap,
    weight_quantizer_for,
)
from .obs import gptaq_update_with_params


def _cross_chunk(x, fx):
    """(sum (fp - x) x^T, sum x x^T) over the tokens of a (B, T, C) chunk."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    f2 = fx.reshape(-1, fx.shape[-1]).float()
    return (f2 - x2).t() @ x2, x2.t() @ x2


def cross_hessians(ctx: CalibContext, fp_ctx: CalibContext, lp, orig_lp, layer_idx: int,
                   ops, tap: str):
    """(H, dXXT) of one tap over both streams: the quantized stream through
    ``lp`` as it stands, the full-precision one through ``orig_lp``."""
    n_samples = ctx.hidden.shape[0]
    H = dXXT = None
    q_stream = run_layer(ctx, lp, layer_idx, ops, (tap,))
    fp_stream = run_layer(fp_ctx, orig_lp, layer_idx, ops, (tap,))
    for (_, _, _, taps_q), (_, _, _, taps_fp) in zip(q_stream, fp_stream):
        d, h = _cross_chunk(taps_q[tap], taps_fp[tap])
        H = h if H is None else H + h
        dXXT = d if dXXT is None else dXXT + d
    return 2.0 * H / n_samples, 2.0 * dXXT / n_samples


@full_f32_matmul()
@torch.no_grad()
def gptaq(params, cfg: ModelConfig, ctx: CalibContext, qcfg: QuantConfig,
          mse: bool = False, blocksize: int = 128, actorder: bool = True,
          alpha: float = 0.25, scale_book: Optional[dict] = None,
          verbose: bool = True) -> None:
    """Quantize every linear in place (``scale_book`` as for ``gptq``);
    the lm_head is RTN-quantized at the end."""
    fp_ctx = CalibContext(cfg=cfg, hidden=ctx.hidden.clone(), positions=ctx.positions,
                          chunk=ctx.chunk)
    for i, lp in enumerate(params["layers"]):
        ops = layer_ops(cfg, qcfg, i)
        orig_lp = copy_tree(lp)
        for group in sequential_groups(cfg):
            H, dXXT = cross_hessians(ctx, fp_ctx, lp, orig_lp, i, ops, slot_tap(group[0]))
            for slot in group:
                qz = weight_quantizer_for(cfg, qcfg, i, slot, mse)
                if qz.qtype == "dummy":
                    continue
                W = get_weight(lp, slot)
                Q, s, z = gptaq_update_with_params(W, H, dXXT, qz, blocksize=blocksize,
                                                   actorder=actorder, alpha=alpha)
                set_weight(lp, slot, Q.to(W.dtype))
                if scale_book is not None:
                    scale_book[(i, slot)] = (s, z)
            del H, dXXT
        advance(fp_ctx, orig_lp, i, ops)
        advance(ctx, lp, i, ops)
    quantize_head_weight(params, qcfg, mse)
