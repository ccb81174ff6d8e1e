"""The byte and operation counters against numbers worked out by hand."""

import pytest

import tiny
from portbench import harness, roofline

QWEN3 = "qwen3_1p7b_w4a8.decode_b1024_ctx1k"
PHI2 = "phi2_w4a8.decode_b256_ctx1408"


def of(cell):
    return roofline.of(harness.resolve(tiny.bench(), cell).config)


def test_qwen3_counts():
    s, b = of(QWEN3)
    # per layer: q|k|v 4096 x 2048, o 2048 x 2048, gate|up 12288 x 2048, down 2048 x 6144
    assert roofline.linear_weight_count(s) == 1_409_286_144
    # (2 x 8 x 128 codes + 2 x 8 x 4 scale bytes) x 28 layers
    assert roofline.kv_row_bytes(s, b) * s.layers == 59_136
    # int4 codes 704,643,072 + scales 44,040,192; int8 head 311,164,928 + 9,723,904
    assert roofline.step_weights_bytes(s, b) == 1_069_572_096


def test_phi2_counts():
    s, b = of(PHI2)
    # per layer: q|k|v 7680 x 2560, o 2560 x 2560, fc1 10240 x 2560, fc2 2560 x 10240
    assert roofline.linear_weight_count(s) == 2_516_582_400
    assert roofline.kv_row_bytes(s, b) * s.layers == 172_032
    assert roofline.step_weights_bytes(s, b) == 1_258_291_200 + 78_643_200 + 131_072_000 + 4_096_000


def test_cells_fill_the_card():
    # each cell's int8 cache: batch x (prompt + steps) rows x KV bytes a token
    for cell, want in ((QWEN3, 1024 * 1024 * 59_136), (PHI2, 256 * 1408 * 172_032)):
        c = harness.resolve(tiny.bench(), cell)
        s, b = roofline.of(c.config)
        t = c.traffic
        rows = t["prompt_len"] + t["steps_per_call"] * t["calls_per_job"]
        assert t["batch"] * rows * roofline.kv_row_bytes(s, b) * s.layers == want
        assert 0.75 * 80e9 < want < 0.8 * 80e9


def test_w4a8_step_at_batch_128():
    s, b = of(QWEN3)
    nbytes, ops = roofline.w4a8_step(s, b, 128)
    acts = 28 * 128 * ((2048 + 4) * 3 + 6144 + 4)            # q|k|v, o, gate|up, down inputs
    outs = 28 * 128 * 2 * (4096 + 2048 + 6144 + 2048)        # bf16 outputs (gate|up: I)
    head_io = 128 * (2048 + 4) + 128 * 151936 * 2
    assert nbytes == roofline.step_weights_bytes(s, b) + acts + outs + head_io
    assert ops == 2 * 128 * (1_409_286_144 + 151936 * 2048)


def test_attention_counts():
    s, b = of(QWEN3)
    nbytes, ops = roofline.attention(s, b, rows=1000, slot_steps=10)
    row = 2 * 8 * 128 + 2 * 8 * 4
    assert nbytes == 28 * (1000 * row + 10 * (row + 2 * 16 * 128 * 4))
    assert ops == 28 * 4 * 16 * 128 * 1000


@pytest.mark.parametrize("nbytes,ops,want", [(3.35e12, 0, 1.0), (0, 1979e12, 1.0),
                                             (3.35e12, 2 * 1979e12, 2.0)])
def test_bound(nbytes, ops, want):
    assert roofline.bound_s(nbytes, ops) == pytest.approx(want)


def test_w4a8_share_needs_every_linear_on_the_kernels():
    reader = harness.load_module(tiny.ROOT / "portbench/metrics/kern.w4a8_roofline.decode.py")
    c = harness.resolve(tiny.bench(), PHI2)
    s, _ = roofline.of(c.config)
    # two steps: q|k|v, o, fc1, fc2 in each layer and the head, 10 us each
    ev = [("void (anonymous namespace)::w4a8_mma_kernel<1, __nv_bfloat16>", 0.0, 10.0)]
    ev = ev * (2 * (4 * s.layers + 1))
    rec = {"kind": "decode", "config": c.config, "events": ev, "steps": 2, "batch": 256}
    assert 0 < reader.read(rec) < 100
    # one linear routed elsewhere: nothing to attribute
    assert reader.read(dict(rec, events=ev[:-2])) is None
