"""Per-op quantization profiling -> stats.csv, the data of MPQ plans (port
of ``evalx/profiler.py``; reference quantizers/base.py:30-113 driven by
CompressForCausalLM.profile, models/base.py:53-104): one weight pass and
one activation batch, a CSV row per quantizer with PC99% / Max / QDQ(Max)
/ SQNR / ClipError / Elem / BPV, in the JAX package's schema, op names,
row order and number formats.

The statistics are taken on the tensor's device, where the JAX package
takes them on the host in numpy: PC99% is the same order statistic
(``torch.kthvalue``), min and max are exact, and only SQNR's mean sums in
another order. The fake quantization is the jitted ``quantize_dequant``,
as in the JAX package.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from ..algorithms.common import get_bias, get_weight, slot_tap
from ..capture.pipeline import capture_layer0, run_layer
from ..models.config import ModelConfig
from ..models.layers import qlinear
from ..models.transformer import arch_slots, layer_ops, op_names
from ..qformats.config import QuantConfig
from ..qformats.quantize import Quantizer, quantize_dequant

LOGGER = logging.getLogger(__name__)

KEYS = ("Op Name", "PC99%", "Max", "QDQ(Max)", "SQNR", "ClipError", "Elem", "BPV")
TAP_KEYS = ("attn_in", "o_in", "mlp_in", "down_in", "qk_in1", "qk_in2",
            "qk_out", "sv_in1", "sv_in2", "sv_out")


def _sqnr(t: torch.Tensor, q: torch.Tensor) -> float:
    tn = (t - t.min()) / (t.max() - t.min() + 1e-12)
    qn = (q - q.min()) / (q.max() - q.min() + 1e-12)
    return float(-10.0 * torch.log10(torch.mean((tn - qn) ** 2) + 1e-10))


def _pc99(t: torch.Tensor) -> float:
    k = round(0.99 * (t.numel() - 1))
    return float(torch.kthvalue(t.flatten(), k + 1).values)


def _bpv(q: Quantizer, numel: int) -> float:
    """Bits-per-value accounting (reference base.py:64-92)."""
    if q.qtype == "dummy":
        return 16.0
    gs = q.group_size
    group = gs if gs and gs > 0 else numel   # -1/-2/0 approximated by the caller
    elem = 4 if q.fmt is not None and q.fmt.bits == 4 else 8
    if q.qtype == "nvfp":
        scales = 16.0 / numel + 8.0 / group
    else:
        scales = 16.0 / group
    zeros = 16.0 / group if q.zero_point else 0.0
    return elem + scales + zeros


def _row(csv_path: Path, op_name: str, q: Quantizer, x: torch.Tensor, qdq: torch.Tensor):
    vals = (
        op_name,
        _pc99(x),
        float(x.max()),
        float(qdq.max()),
        _sqnr(x, qdq),
        float(x.max()) - float(qdq.max()),
        x.numel(),
        _bpv(q, x.numel()),
    )
    header = "" if csv_path.exists() else (
        (("%46s," + "%14s," * (len(KEYS) - 1)) % KEYS).rstrip(",") + "\n"
    )
    with open(csv_path, "a") as f:
        f.write(header + (("%46s," + "%14.5g," * (len(vals) - 1)) % vals).rstrip(",") + "\n")


def _record(csv_path, op_name, q: Quantizer, x: torch.Tensor):
    x32 = x.float()
    qdq = quantize_dequant(q, x32) if q.qtype != "dummy" else x32
    _row(csv_path, op_name, q, x32, qdq)


@torch.no_grad()
def profile_model(params, cfg: ModelConfig, qcfg: QuantConfig, tokens: np.ndarray,
                  save_path: str = "./", verbose: bool = True) -> Path:
    """Run the weight pass and the activation pass, appending to
    ``save_path``/stats.csv, on the params' device (per-layer float
    params). ``tokens``: one small batch (the reference takes one
    256-token wikitext sample, models/base.py:95-102)."""
    csv_path = Path(save_path) / "stats.csv"
    LOGGER.info(f"Profiling model -> {csv_path}")

    for i, lp in enumerate(params["layers"]):   # the weight pass
        names = op_names(cfg, i)
        for slot in arch_slots(cfg):
            q = qcfg.for_op(names[slot], "linear").weight
            _record(csv_path, f"{names[slot]}.weight", q, get_weight(lp, slot))
    w_head = params["lm_head"]["weight"] if "lm_head" in params else params["embed"]["weight"]
    _record(csv_path, "lm_head.weight", qcfg.head.weight, w_head)

    # the activation pass: one batch through the decoder with taps
    ctx = capture_layer0(params, cfg, tokens, chunk=tokens.shape[0])
    for i, lp in enumerate(params["layers"]):
        names = op_names(cfg, i)
        ops = layer_ops(cfg, qcfg, i)
        outs = None
        for _, _, y, taps in run_layer(ctx, lp, i, ops, TAP_KEYS):
            outs = y
            for slot in arch_slots(cfg):
                op = qcfg.for_op(names[slot], "linear")
                x_in = taps[slot_tap(slot)]
                _record(csv_path, f"{names[slot]}.input", op.act_in, x_in)
                out = qlinear(x_in, get_weight(lp, slot), get_bias(lp, slot))
                _record(csv_path, f"{names[slot]}.output", op.act_out, out)
            qk = qcfg.for_op(names["qk"], "matmul")
            sv = qcfg.for_op(names["sv"], "matmul")
            _record(csv_path, f"{names['qk']}.input1", qk.act_in, taps["qk_in1"])
            _record(csv_path, f"{names['qk']}.input2",
                    qk.act_in.with_axes_flipped() if qk.act_in.eff_axes == -2 else qk.act_in,
                    taps["qk_in2"])
            _record(csv_path, f"{names['qk']}.output", qk.act_out, taps["qk_out"])
            _record(csv_path, f"{names['sv']}.input1", sv.act_in, taps["sv_in1"])
            _record(csv_path, f"{names['sv']}.input2",
                    sv.act_in.with_axes_flipped() if sv.act_in.eff_axes == -1 else sv.act_in,
                    taps["sv_in2"])
            _record(csv_path, f"{names['sv']}.output", sv.act_out, taps["sv_out"])
        ctx.hidden = outs
    return csv_path
