"""Readings for a cell's limits: the program's widest gap and the
control's (the family's reference at its ``control_of`` precisions, by
default every 8-bit stage at 4 bits, at the same positions of the same
served sequences) on each of several seeds, in one process, with the
cell's own sizes and a short window.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

One JSON line per seed on standard output, each with the run's end-to-end
numbers beside its two readings. Needs the card, as ``run.py`` does. A
cell that fills most of the card may leave too little for a second seed
in the same process: give such a cell one seed a call.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from portbench import harness

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(bench, args.workload, seed, args.seconds, False, control=True,
                             log=lambda *a, **k: None)
        print(json.dumps({"seed": seed, "program": r["checks"]["gap_max"]["value"],
                          "control": r["checks"]["control_gap_max"]["value"],
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "failed": r["failed"], "call_s": time.perf_counter() - t0}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
