"""Some kernels of several trees on one card, in turns.

    python3 tools/kernel_turns.py TREE [TREE ...] --kernels NAME [NAME ...]
                          e.g.  python3 tools/kernel_turns.py _parent . . _parent --kernels B10

Each turn is a process of its own that imports ``chip_smoke.py`` and the
port from one tree (a directory holding a checkout; ``.`` is this one)
and runs that tree's own cases of each named kernel
(``chip_smoke.kernel_cases``: the shapes of the main path, every case held
against its plain version), plus an empty launch
(``torch.cuda._sleep(0)``) timed by the same ``time_ms``. A kernel is
named by its key there or by the key's first word (``B8``). A tree other
than this one is typically an earlier commit unpacked with ``git archive``
into a directory that ``.gitignore`` lists; its ``chip_smoke.py`` must
have ``kernel_cases``. Prints one JSON line per turn, then the card's name
and power limit. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SEED = 0
KEEP = ("case", "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")


def one_turn(tree: str, kernels) -> dict:
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs

    if os.path.dirname(os.path.abspath(cs.__file__)) != os.path.abspath(tree):
        raise RuntimeError(f"chip_smoke.py came from {cs.__file__}, not from {tree}")
    table = cs.kernel_cases(torch.Generator(device="cuda").manual_seed(SEED))
    out = {"tree": tree, "launch_floor_ms": cs.launch_floor_ms(), "kernels": {}}
    for k in kernels:
        names = [n for n in table if k in (n, n.split("_")[0])]
        if len(names) != 1:
            raise KeyError(f"{k}: not one kernel of {sorted(table)}")
        out["kernels"][names[0]] = [{key: c[key] for key in KEEP} for c in table[names[0]]()]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="the trees, in the order of the turns")
    ap.add_argument("--kernels", nargs="+", required=True, help="e.g. B8 B10")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_turn(args.one, args.kernels)), flush=True)
        return 0
    for tree in args.trees:
        tree = os.path.abspath(tree)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree,
                              "--kernels", *args.kernels],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
