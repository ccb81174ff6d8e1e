"""The harness end to end on the CPU at tiny sizes: each cell's run gives a
result line of the expected shape, its served tokens agree with the
reference, and no module of JAX or of the JAX package is loaded."""

import json
import os
import subprocess
import sys

import pytest

import tiny

CELLS = [w["name"] for w in tiny.bench()["workloads"]]
DRY = """
import json, sys
sys.path[0:0] = [{root!r}, {tests!r}]
import tiny
from portbench import harness
r = harness.run_cell(tiny.bench(), {cell!r}, 2**31 + 101, 1.0, False, device="cpu",
                     adjust=tiny.shrink, control=True, log=lambda *a, **k: None)
print(json.dumps({{"result": r, "forbidden": harness.forbidden_modules()}}))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run(cell):
    code = DRY.format(root=str(tiny.ROOT), tests=str(tiny.ROOT / "portbench" / "tests"), cell=cell)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=tiny.ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    r = got["result"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    names = {m["name"] for m in tiny.bench()["end_to_end"]
             if "workloads" not in m or cell in m["workloads"]}
    assert set(r["metrics"]) == names
    assert r["checks"]["gap_max"]["value"] <= r["checks"]["gap_max"]["limit"]
    # the control, the reference with every 8-bit stage at 4 bits, fails the same limit
    # (tiny.LIMIT at this size; on the card at the cell's own: test_portbench_card.py)
    assert r["checks"]["control_gap_max"]["value"] > r["checks"]["control_gap_max"]["limit"]


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=tiny.ROOT)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""
