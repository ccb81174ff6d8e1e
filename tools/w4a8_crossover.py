"""The rows up to which a W4A8 linear with many K groups runs faster on the
integer kernels than on the dense route, on one card.

    python3 tools/w4a8_crossover.py [--rows 512 1024 ...] [--out FILE]

For each int4-g128 weight shape N x C (Qwen3-1.7B's ``down`` 2048 x 6144,
Phi-2's ``qkv`` 7680 x 2560 and ``fc2`` 2560 x 10240) and each row count M,
the two routes of ``models/layers.py::qlinear`` for bf16 acts with int8
per-token act quantization, over a stack of layers whose packed weights
exceed the card's 50 MB L2 (each layer's weight arrives cold, as in
decode):

* ``dense``: the act fake quantizer (``maybe_quant``), ``dequantize`` to
  bf16, ``torch.matmul``;
* ``kernel``: ``quantize_acts_per_token`` and B1 (``w4a8_matmul(layer=)``),
  each layer read in place from the stack;

and each route's act quantizer alone (``dense_quant``, ``kernel_quant``).
Each over the whole stack, every layer quantizing its own input, is
captured as one CUDA graph, as decode runs it, and replayed ``REPS`` times
between CUDA events, in turns (dense, kernel, kernel, dense); a case's
time is the median turn over the layers, in ms a layer. Prints one JSON line a case (also written to ``--out``),
then the card's name and power limit. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from dataclasses import replace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llm_compressor_tpu_torch.kernels import w4a8_matmul as wm  # noqa: E402
from llm_compressor_tpu_torch.models.layers import maybe_quant  # noqa: E402
from llm_compressor_tpu_torch.qformats import (  # noqa: E402
    build_quant_config,
    dequantize,
    quantize_pack,
)

SHAPES = {"qwen3_down": (2048, 6144), "phi2_qkv": (7680, 2560), "phi2_fc2": (2560, 10240)}
ROWS = (512, 1024, 1280, 1536, 1792, 2048, 2560, 3072, 4096, 6144, 9216, 24576)
L2_BYTES = 50 * 2 ** 20
REPS, TURNS = 5, ("dense", "kernel", "kernel", "dense")


def stacked_weight(N: int, C: int, gen: torch.Generator, layers: int = 0):
    """A stack of packed int4-g128 layers, by default 2 x L2 of codes at
    least, and the int8 per-token act quantizer."""
    q = build_quant_config("int4-g[128]-rw", "int8-g[-1]-rw", None, None).linear
    layers = layers or max(2, -(-2 * L2_BYTES // (N * C // 2)))
    qts = [quantize_pack(q.weight, 0.02 * torch.randn((N, C), generator=gen, device=gen.device))
           for _ in range(layers)]
    qt = replace(qts[0], codes=torch.stack([t.codes for t in qts]),
                 scales=torch.stack([t.scales for t in qts]))
    return qt, layers, q.act_in


def routes(x, qt, layers: int, ai, out: dict) -> dict:
    """The two routes over every layer of the stack, each layer's act
    quantizer included, as each linear runs its own; each keeps its last
    layer's output in ``out``. Then each route's act quantizer alone."""
    def dense():
        for i in range(layers):
            out["dense"] = torch.matmul(maybe_quant(ai, x),
                                        dequantize(qt.layer(i)).to(x.dtype).t())

    def kernel():
        for i in range(layers):
            out["kernel"] = wm.w4a8_matmul(x, qt, layer=i)

    def dense_quant():
        for _ in range(layers):
            out["dense_quant"] = maybe_quant(ai, x)

    def kernel_quant():
        for _ in range(layers):
            out["kernel_quant"] = wm.quantize_acts_per_token(x)

    return {"dense": dense, "kernel": kernel, "dense_quant": dense_quant,
            "kernel_quant": kernel_quant}


def graphed(fn) -> torch.cuda.CUDAGraph:
    """``fn`` run once eagerly on a side stream, then captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g


def replay_ms(g: torch.cuda.CUDAGraph) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    g.replay()
    start.record()
    for _ in range(REPS):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def case(name: str, N: int, C: int, M: int, qt, layers: int, ai, gen) -> dict:
    x = torch.randn((M, C), generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    graphs = {k: graphed(fn) for k, fn in routes(x, qt, layers, ai, out).items()}
    ms = {k: [] for k in graphs}
    for turn in TURNS:
        for route in (turn, turn + "_quant"):
            ms[route].append(replay_ms(graphs[route]) / layers)
    d, k = out["dense"].float(), out["kernel"].float()
    row = {"shape": name, "N": N, "C": C, "groups": C // 128, "M": M, "layers": layers,
           **{f"{r}_ms": statistics.median(t) for r, t in ms.items()},
           "dense_turns": ms["dense"], "kernel_turns": ms["kernel"],
           "b1_grid": list(wm.matmul_stacked.last_grid),
           "rel_diff": float((d - k).norm() / d.norm())}
    row["kernel_over_dense"] = row["kernel_ms"] / row["dense_ms"]
    del graphs
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", nargs="+", type=int, default=list(ROWS))
    ap.add_argument("--out", default="w4a8_crossover.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for name, (N, C) in SHAPES.items():
            qt, layers, ai = stacked_weight(N, C, gen)
            for M in args.rows:
                row = case(name, N, C, M, qt, layers, ai, gen)
                print(json.dumps(row), flush=True)
                f.write(json.dumps(row) + "\n")
            del qt
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
