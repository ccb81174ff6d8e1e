"""On the card, at each cell's own size: the program's served tokens pass
the cell's limit and the control (the reference with every 8-bit stage at
4 bits, at the same positions) fails it."""

import pytest

import tiny
from portbench import harness

CELLS = [w["name"] for w in tiny.bench()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(card, cell):
    r = harness.run_cell(tiny.bench(), cell, 2**31 + 555, 8.0, False, device=card,
                         control=True, log=lambda *a, **k: None)
    c = r["checks"]
    assert r["correct"] and c["gap_max"]["value"] <= c["gap_max"]["limit"]
    assert c["control_gap_max"]["value"] > c["control_gap_max"]["limit"]
