"""A family brings its own hooks (``portbench/family.py``): a test-only
family (``hooked/qwen3.py``: Qwen3's, each hook a recording wrapper of its
default) runs through ``run_cell`` with no other file changed, a fault in
one of its hooks reads not correct, the roofline readers take its counters,
and a kernel-class file classes a kernel by data alone."""

import json
from pathlib import Path

import pytest

import tiny
from portbench import family, harness, roofline, spec as spec_mod, traceutil, weights
from portbench.reference import model as reference

HOOKED = Path(__file__).resolve().parent / "hooked"
METRICS = tiny.ROOT / "portbench" / "metrics"
CELL = "qwen3_1p7b_w4a8.decode_b1024_ctx1k"
# what an untraced run_cell calls (the counters are the traced readers')
RUN_HOOKS = {"spec", "draw", "params", "logits", "bits_of", "control_of", "init_cache", "splice"}


def run(adjust=tiny.shrink):
    logged = []
    r = harness.run_cell(tiny.bench(), CELL, 2**31 + 4242, 0.0, False, device="cpu",
                         adjust=adjust, control=True, log=lambda *a, **k: logged.append(a[0]))
    return r, logged


def timeless(r, logged):
    """The result line and the logged lines without the clock's readings."""
    r = json.loads(json.dumps(r))
    for m in r["metrics"].values():
        m["value"] = None
    info = json.loads(logged[0])["info"]
    for k in ("setup_s", "window_s"):
        info.pop(k)
    return r, info, logged[1:]


def hooked(monkeypatch):
    """Point the family lookup at the test-only family; its record cleared."""
    monkeypatch.setattr(spec_mod, "FAMILIES", HOOKED)
    fam = spec_mod.family_of({"model_type": "qwen3"})
    fam.CALLS.clear()
    monkeypatch.setattr(fam, "FAULT", None)
    return fam


def test_shipped_families_use_the_defaults():
    for c in tiny.bench()["configs"]:
        fam = family.of(harness.read_json(tiny.ROOT / c["file"]))
        assert (fam.draw, fam.params, fam.logits) == (weights.draw, family.to_params,
                                                      reference.logits)
        assert (fam.bits_of, fam.control_of) == (reference.bits_of, reference.control_of)
        assert (fam.counters, fam.init_cache, fam.splice) == (roofline.Counters,
                                                              family.init_cache, family.splice)
        assert fam.tiny is None


def test_every_hook_is_called_and_the_line_is_the_default_paths(monkeypatch):
    want = timeless(*run())
    fam = hooked(monkeypatch)
    monkeypatch.setattr(tiny, "CONFIG", {})      # the tiny size from the family's TINY

    def adjust(cell):
        tiny.shrink(cell)
        # a recipe key of the family's own: its bits_of models it, the shared one refuses it
        cell.config["recipe"]["hooked_stage"] = "int8-g[-1]-rw"
        with pytest.raises(ValueError):
            reference.bits_of(cell.config["recipe"])

    got = timeless(*run(adjust))
    assert set(fam.CALLS) == RUN_HOOKS
    # the program's weights and the reference's; the reference's logits and the control's
    assert [fam.CALLS.count(h) for h in ("draw", "params", "logits", "control_of")] == [2, 1, 2, 1]
    assert got == want
    assert got[0]["correct"] is True


@pytest.mark.parametrize("fault", ["reference", "draw"])
def test_a_fault_in_one_hook_is_not_correct(monkeypatch, fault):
    fam = hooked(monkeypatch)
    monkeypatch.setattr(fam, "FAULT", fault)
    assert run()[0]["correct"] is False


def record(config):
    """A traced decode call of two steps at batch 8: one launch a linear a
    step, 10 us each, and one B4 launch a step, 200 us."""
    c = roofline.of(config)
    ev = [("void w4a8_mma_kernel<1, __nv_bfloat16>", 0.0, 10.0)] * (2 * c.linear_launches())
    ev += [("void decode_attention_append_kernel<64>", 0.0, 200.0)] * 2
    return {"kind": "decode", "config": config, "events": ev, "steps": 2, "batch": 8,
            "rows": 8 * 2 * 500, "window_s": 0.01, "busy_s": 0.01}


@pytest.mark.parametrize("metric,hooks", [
    ("kern.attn_roofline.decode", {"Counters.attention"}),
    ("kern.w4a8_roofline.decode", {"Counters.linears", "Counters.linear_launches"}),
    ("step_mfu.decode", {"Counters.linears", "Counters.attention", "Counters.weights_bytes"}),
])
def test_roofline_readers_take_the_familys_counters(monkeypatch, metric, hooks):
    config = harness.resolve(tiny.bench(), CELL).config
    rec = record(config)
    fam = hooked(monkeypatch)
    reader = harness.load_module(METRICS / f"{metric}.py")
    assert 0 < reader.read(rec) < 100
    assert hooks <= set(fam.CALLS)


def test_doubled_attention_bytes_double_the_attention_share(monkeypatch):
    config = harness.resolve(tiny.bench(), CELL).config
    fam = hooked(monkeypatch)
    reader = harness.load_module(METRICS / "kern.attn_roofline.decode.py")
    rec = record(config)
    one = reader.read(rec)
    monkeypatch.setattr(fam.Counters, "ATTENTION_BYTES", 2)
    # the cache's bytes bound B4 (its operations' time is under 1 % of theirs)
    assert reader.read(rec) == pytest.approx(2 * one, rel=1e-12)


def test_a_kernel_class_file_classes_a_kernel(tmp_path, monkeypatch):
    (tmp_path / "expert.json").write_text(json.dumps(
        {"fragment": "synthetic_expert", "class": "E1", "primary": "synthetic_expert_kernel"}))
    glue = harness.load_module(METRICS / "model.glue_ms.decode.py")
    ev = [("void synthetic_expert_kernel<4, __nv_bfloat16>", 0.0, 30.0),
          ("void synthetic_expert_reduce<4>", 30.0, 40.0),
          ("void at::native::elementwise_kernel<128, 2>", 40.0, 45.0)]
    rec = {"kind": "decode", "events": ev, "steps": 1}
    assert glue.read(rec) == pytest.approx(0.045)
    assert traceutil.launches(ev) == 0
    monkeypatch.setattr(traceutil, "CLASS_FILES", tmp_path)
    assert [traceutil.kernel_class(n) for n, _, _ in ev] == ["E1", "E1", "glue"]
    assert glue.read(rec) == pytest.approx(0.005)
    assert traceutil.launches(ev) == traceutil.launches(ev, of=["E1"]) == 1
    assert traceutil.launches(ev, of=["B1/B3", "B2"]) == 0


@pytest.mark.parametrize("entry", [
    {"fragment": "w4a8", "class": "E1", "primary": None},           # inside B1/B3's and B2's
    {"fragment": "w4a8_mma_kernel_e", "class": "E1", "primary": None},  # holds B1/B3's
    {"fragment": "expert", "class": "E1", "primary": "gemm_kernel"},    # a primary not its own
    {"fragment": "expert", "class": "E1"},                          # a key left out
])
def test_a_kernel_class_file_that_clashes_is_refused(tmp_path, monkeypatch, entry):
    (tmp_path / "bad.json").write_text(json.dumps(entry))
    monkeypatch.setattr(traceutil, "CLASS_FILES", tmp_path)
    with pytest.raises(ValueError):
        traceutil.classes()
