"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix, limits
and per-layer readers are the files that ``BENCHMARK.json`` names (see
``portbench/README.md``). Exits 2 without a CUDA card (or with fewer cards
than the cell asks for), 3 when a JAX module is loaded once the window has
closed; neither prints a result. The last line of standard output is the
result's JSON object; the last lines of standard error are each compared
number beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    chips = [w["chips"] for w in bench["workloads"] if w["name"] == args.workload]
    if not chips:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[0]:
        print(f"{args.workload} needs {chips[0]} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    from portbench import harness

    result = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package loaded: {bad}", file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
