"""The CLI's flags (port of ``cli/args.py``): the reference's
(utils/args.py:25-162) and the JAX package's extras (``--tiny`` random
models, ``--pack``, ``--head-act``, ``--kv-quant``, ``--mesh``, ``--cpu``),
with the same names, defaults, types and choices.

``--cpu`` runs on the CPU; without it the run is on the card, and raises
before any work when there is none. ``--mesh`` is parsed and read nowhere,
as in the JAX package.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("llm-compressor-tpu")
    p.add_argument("--model", type=str, default=None,
                   help="local HF checkpoint dir (config.json + safetensors)")
    p.add_argument("--arch", type=str, default=None,
                   help="architecture for --tiny runs (llama/opt/bloom/...)")
    p.add_argument("--tiny", action="store_true",
                   help="random-init tiny model (offline testing)")
    p.add_argument("--exp", type=str, default="exp",
                   help="experiment name (creates experiments/<exp>/)")

    # profiling / quantization
    p.add_argument("--profile", action="store_true")
    p.add_argument("--quantize", action="store_true")
    p.add_argument("--quant-method", type=str, default="rtn",
                   choices=["rtn", "smoothquant", "gptq", "awq", "awq_plus",
                            "spinquant-had", "spinquant-opt", "gptaq"])
    p.add_argument("--weight", type=str, default=None,
                   help="weight quant DSL, e.g. int4-g[128]-rw")
    p.add_argument("--act-in", type=str, default=None)
    p.add_argument("--act-out", type=str, default=None)
    p.add_argument("--head", type=str, default=None)
    p.add_argument("--head-act", type=str, default=None,
                   help="input-act quantizer for the lm_head (TPU serving "
                        "extension: int8-g[-1]-rw routes the packed head "
                        "through the integer W4A8 kernel)")
    p.add_argument("--rotation-path", type=str, default=None,
                   help="SpinQuant learned rotations (R.npz)")
    p.add_argument("--w-clip", action="store_true",
                   help="MSE clip grid search on weight quantizers")
    p.add_argument("--sq-alpha", type=float, default=0.8,
                   help="SmoothQuant migration strength")

    # pruning
    p.add_argument("--prune", action="store_true")
    p.add_argument("--prune-method", type=str, default="magnitude",
                   choices=["magnitude", "wanda", "sparsegpt", "ria"])
    p.add_argument("--sparsity", type=float, default=0.3)
    p.add_argument("--ria-alpha", type=float, default=0.5)

    # calibration / eval
    p.add_argument("--calib-num", type=int, default=128)
    p.add_argument("--calib-dataset", type=str, default=None,
                   help="local text file for calibration (offline)")
    p.add_argument("--tasks", type=str, default="ppl")
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)

    # execution
    p.add_argument("--pack", action="store_true",
                   help="pack weights into QTensors (kernel execution)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8-quantized KV cache for generation")
    p.add_argument("--mesh", type=str, default=None,
                   help="'DxM' data x model mesh, e.g. 1x4")
    p.add_argument("--save-path", type=str, default=None)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch path) instead of "
                        "the card")
    return p


def make_exp_dir(args) -> Path:
    """``experiments/<exp>`` under the working directory."""
    d = Path("experiments") / args.exp
    d.mkdir(parents=True, exist_ok=True)
    return d
