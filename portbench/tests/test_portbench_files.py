"""BENCHMARK.json and the files it names: every cell resolves to its
configuration, traffic mix, driver, limits and per-layer readers by name,
and every name and unit keeps to the allowed characters."""

import json
import re

import pytest

import tiny
from portbench import harness, traceutil
from portbench.spec import spec_of

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = tiny.bench()
PB = tiny.ROOT / "portbench"


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    cell = harness.resolve(BENCH, w["name"])
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert (PB / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert cell.limits["gap_max"] > 0
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
        assert any(e["name"] == m["moves"] for e in cell.end_to_end)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    cfg = harness.read_json(tiny.ROOT / c["file"])
    assert c["file"].startswith("portbench/configs/") and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"] == [] and cfg["assumed"] == []
    spec_of(cfg)
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_every_plugin_file_is_named_in_the_benchmark():
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {p.stem for p in (PB / "limits").glob("*.json")} == cells
    assert {p.stem for p in (PB / "metrics").glob("*.py")} == {m["name"] for m in BENCH["per_layer"]}
    assert {p.stem for p in (PB / "configs").glob("*.json")} == {c["name"] for c in BENCH["configs"]}


def test_kernel_class_files_load():
    hand, primary = traceutil.classes()
    assert set(traceutil.HAND_KERNELS.items()) <= set(hand.items())
    assert set(traceutil.PRIMARY) <= set(primary)
