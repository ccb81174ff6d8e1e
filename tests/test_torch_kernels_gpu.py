"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, at small shapes.

Run on a machine with an H100: ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
Here, without a card, every test skips (the check runs inside a fixture,
so every pytest-xdist worker collects the same tests).

Tolerances:
* B1/B2/B3: the kernel and the plain version take the same exact int32
  group dots and add the scaled parts in the same order without FMA
  contraction (K split as the wrapper launched it, and the plain version
  sums the same splits), so B1/B3 outputs are bitwise equal. B2's outputs
  may differ by one ulp of the out dtype where the f32 activation rounds
  differently (``expf`` against torch's ``exp``). Two launches give the
  same bits.
* B4, B7: the written cache codes are bitwise equal; the output agrees to
  a few f32 ulps (the row sum is reduced in another order), plus at most one
  flipped prob code per row (exp may differ by an ulp at a .5 boundary).
  At the flagship decode shape B4's prob codes equal the plain version's
  and two launches of B4 and B7 give the same bits. The same tolerances
  hold at caches of 16K and 128K rows.
* B6: m, a and sum_main to rtol 1e-5; o32 (integer dots) equal but for
  flipped prob codes on at most 1 % of entries; the hybrid output
  assembled around it as B7's against the assembly around the plain
  version, and within the JAX test's tolerance of the two-part epilogue.
* B8: bitwise (a copy).
* B9: its act quantizer kernel gives the codes and scales of
  ``quantize_acts_per_token``, then B3's core: bitwise.
* B5: kernel and plain version build the same bf16 weight (checked
  bitwise through x = I) and differ only in the order of the f32 sums
  (split-K included): one ulp of the output dtype plus
  2 * C * 2**-24 * (|x| @ |W|^T). Two launches give the same bits.
* B10: the kernel and the plain version take the same float32 adds in the
  same order (butterfly stages h = 1, 2, 4, ..., then the base terms
  l = 0..K-1), scale once and round once: bitwise equal.
"""

import functools

import numpy as np
import pytest
import torch

from llm_compressor_tpu_torch.kernels import decode_attention as da
from llm_compressor_tpu_torch.kernels import dequant_matmul as dm
from llm_compressor_tpu_torch.kernels import hadamard as hd
from llm_compressor_tpu_torch.kernels import w4a8_matmul as wm
from llm_compressor_tpu_torch.qformats import parse_qspec, quantize_pack

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (H100); the CPU runs the plain versions only")
    return torch.device("cuda")


def _packed(spec, N, C, seed, stack=1):
    rng = np.random.default_rng(seed)
    q = parse_qspec(spec)
    qts = [quantize_pack(q, torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32)))
           for _ in range(stack)]
    return qts


def _w4a8_inputs(cuda, spec, N, C, M, seed=0, stack=2):
    qts = _packed(spec, N, C, seed=seed, stack=stack)
    x = torch.from_numpy(np.random.default_rng(seed + 1).normal(size=(M, C)).astype(np.float32))
    x_i8, sx = wm.quantize_acts_per_token(x.to(cuda))
    codes = torch.stack([q.codes for q in qts]).to(cuda)
    scales = torch.stack([q.scales for q in qts]).to(cuda)
    return x.to(cuda), x_i8, sx, codes, scales, wm._wfmt(qts[0])


# even group counts pack as pair planes, odd ones as group halves; at N = 320
# the plan splits K into 1 (one group), 2, 4, 8 or 16 (C = 4096) parts
@pytest.mark.parametrize("spec,C", [("int4-g[128]-rw", 512), ("int4-g[128]-rw", 640),
                                    ("int4-g[256]-rw", 1024), ("int8-g[128]-rw", 640),
                                    ("int8-g[128]-rw", 128), ("int4-g[128]-rw", 128),
                                    ("int8-g[128]-rw", 1024), ("int4-g[128]-rw", 4096)])
@pytest.mark.parametrize("M", [8, 40, 130, 256, 300])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_w4a8_flat_and_stacked(cuda, spec, C, M, out_dtype):
    """B1 and B3 bitwise against the plain version at the split count the
    wrapper launched (its plan), and two launches give the same bits."""
    N = 320
    _, x_i8, sx, codes, scales, fmt = _w4a8_inputs(cuda, spec, N, C, M, seed=M)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = wm.split_plan(M, N, C, C // scales.shape[-1], fmt, sms)
    for layer in (0, 1):
        got = wm.matmul_stacked(x_i8, codes, scales, sx, layer, fmt, out_dtype)
        assert wm.matmul_stacked.last_grid == (5, -(-M // 128), plan)
        want = wm.w4a8_plain(x_i8, codes[layer], scales[layer], sx, fmt, out_dtype, splits=plan)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    got = wm.matmul_flat(x_i8, codes[1].contiguous(), scales[1].contiguous(), sx, fmt, out_dtype)
    assert wm.matmul_flat.last_grid[2] == plan
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    again = wm.matmul_flat(x_i8, codes[1].contiguous(), scales[1].contiguous(), sx, fmt,
                           out_dtype)
    assert torch.equal(again, got)


# K units: int8 8 groups, pair planes 8 group pairs (g = 128 and 256), group
# halves 9 groups
@pytest.mark.parametrize("spec,C", [("int8-g[128]-rw", 1024), ("int4-g[128]-rw", 2048),
                                    ("int4-g[128]-rw", 1152), ("int4-g[256]-rw", 4096)])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_w4a8_forced_splits(cuda, spec, C, splits, out_dtype):
    """B3 and B9 with the split count forced: bitwise against the plain
    version summed in the same splits, and launch to launch."""
    M, N = 40, 192
    x, x_i8, sx, codes, scales, fmt = _w4a8_inputs(cuda, spec, N, C, M, stack=1)
    c, s = codes[0], scales[0]
    got = wm.matmul_flat(x_i8, c, s, sx, fmt, out_dtype, splits=splits)
    assert wm.matmul_flat.last_grid == (3, 1, splits)
    want = wm.w4a8_plain(x_i8, c, s, sx, fmt, out_dtype, splits=splits)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(wm.matmul_flat(x_i8, c, s, sx, fmt, out_dtype, splits=splits), got)
    got = wm.matmul_actq(x, c, s, fmt, out_dtype, splits=splits)
    assert wm.matmul_actq.last_grid == (3, 1, splits)
    assert torch.equal(got, wm.actq_plain(x, c, s, fmt, out_dtype, splits=splits))


@pytest.mark.parametrize("N", [200, 77])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_w4a8_ragged_n(cuda, N, out_dtype):
    """Output widths that are not a multiple of the 64-wide tile, odd ones
    included (single stores)."""
    x, x_i8, sx, codes, scales, fmt = _w4a8_inputs(cuda, "int4-g[128]-rw", N, 512, 40, stack=1)
    got = wm.matmul_flat(x_i8, codes[0], scales[0], sx, fmt, out_dtype)
    want = wm.w4a8_plain(x_i8, codes[0], scales[0], sx, fmt, out_dtype,
                         splits=wm.matmul_flat.last_grid[2])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_w4a8_qlinear_down_on_b1(cuda):
    """``qlinear`` on a LayerSlice of a stacked int4-g128 weight of Qwen3's
    ``down`` shape (N = 2048, C = 6144: 48 K groups) at M = 1024 rows with
    int8 per-token acts: one B1 launch reading the layer in place (no B3,
    no B5); bitwise the plain version on the same codes; within the JAX
    routing test's bf16 tolerance (2e-2, ``tests/test_torch_dequant_matmul.py``)
    of the dense route it took before (fake quant, dequantize,
    ``torch.matmul``), which rounds acts and weights to bf16."""
    from dataclasses import replace

    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.models.layers import LayerSlice, maybe_quant, qlinear
    from llm_compressor_tpu_torch.qformats import build_quant_config, dequantize

    M, N, C = 1024, 2048, 6144
    qts = _packed("int4-g[128]-rw", N, C, seed=5, stack=2)
    qt = replace(qts[0], codes=torch.stack([q.codes for q in qts]).to(cuda),
                 scales=torch.stack([q.scales for q in qts]).to(cuda))
    op = build_quant_config("int4-g[128]-rw", "int8-g[-1]-rw", None, None).linear
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(M, C)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    before = kernels.launch_counts()
    got = qlinear(x, LayerSlice(qt, 1), None, op, slot="down")
    added = {k: n - before[k] for k, n in kernels.launch_counts().items()}
    assert (added["w4a8_stacked"], added["w4a8_flat"], added["dequant_matmul"]) == (1, 0, 0)
    x_i8, sx = wm.quantize_acts_per_token(x)
    want = wm.w4a8_plain(x_i8, qt.codes[1], qt.scales[1], sx, wm._wfmt(qt), torch.bfloat16,
                         splits=wm.matmul_stacked.last_grid[2])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    dense = torch.matmul(maybe_quant(op.act_in, x), dequantize(qt.layer(1)).to(x.dtype).t())
    torch.testing.assert_close(got.float(), dense.float(), rtol=2e-2,
                               atol=2e-2 * float(dense.float().abs().max()))


@pytest.mark.parametrize("C,above,want", [
    (2048, False, (1, 0, 0)),  # 16 K groups within the limit: B1 in place
    (2048, True, (0, 1, 0)),  # above it: the layer's view on B3
    (6144, True, (0, 0, 0)),  # 48 groups above it: the dense route
], ids=["16g_within", "16g_above", "48g_above"])
def test_w4a8_qlinear_card_limit(cuda, C, above, want):
    """``qlinear`` on a LayerSlice around ``CARD_W4A8_ROWS``: within it B1
    reads the layer in place at any C/g; above it the layer is taken as a
    view, B3 at C/g <= 16 and plain dequantization + ``torch.matmul``
    beyond; each route's output is finite and of the input's dtype."""
    from dataclasses import replace

    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.models.layers import CARD_W4A8_ROWS, LayerSlice, qlinear
    from llm_compressor_tpu_torch.qformats import build_quant_config

    M, N = CARD_W4A8_ROWS + (1024 if above else -1024), 512
    qts = _packed("int4-g[128]-rw", N, C, seed=7, stack=2)
    qt = replace(qts[0], codes=torch.stack([q.codes for q in qts]).to(cuda),
                 scales=torch.stack([q.scales for q in qts]).to(cuda))
    op = build_quant_config("int4-g[128]-rw", "int8-g[-1]-rw", None, None).linear
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(M, C)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    before = kernels.launch_counts()
    got = qlinear(x, LayerSlice(qt, 1), None, op, slot="down")
    added = {k: n - before[k] for k, n in kernels.launch_counts().items()}
    assert (added["w4a8_stacked"], added["w4a8_flat"], added["dequant_matmul"]) == want
    assert got.dtype == x.dtype and got.shape == (M, N) and bool(torch.isfinite(got).all())


@functools.lru_cache(maxsize=None)
def _gateup_weights(spec, I, C):
    """A packed [gate | up] (2I, C) weight on the card, stacked as one
    layer: codes, scales and the kernel's layout."""
    qt = _packed(spec, 2 * I, C, seed=I + C)[0]
    return qt.codes[None].cuda(), qt.scales[None].cuda(), wm._wfmt(qt)


def _gateup_check(cuda, spec, I, C, M, act, out_dtype, splits=None):
    """B2 against its plain version at the split count it launched: one
    ulp of the out dtype (the f32 activation, ``expf`` against torch's
    ``exp``); two launches give the same bits. Returns the launched grid."""
    codes, scales, fmt = _gateup_weights(spec, I, C)
    x = torch.from_numpy(np.random.default_rng(M).normal(size=(M, C)).astype(np.float32))
    x_i8, sx = wm.quantize_acts_per_token(x.to(cuda))
    got = wm.gateup_silu(x_i8, codes, scales, sx, 0, fmt, act, out_dtype, splits=splits)
    grid = wm.gateup_silu.last_grid
    want = wm.gateup_plain(x_i8, codes[0], scales[0], sx, fmt, act, out_dtype, splits=grid[2])
    ulp = 2.0 ** -7 if out_dtype == torch.bfloat16 else 2.0 ** -22
    torch.testing.assert_close(got.float(), want.float(), rtol=ulp, atol=1e-6)
    again = wm.gateup_silu(x_i8, codes, scales, sx, 0, fmt, act, out_dtype, splits=splits)
    assert torch.equal(again, got)
    return grid


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gateup(cuda, act, out_dtype):
    _gateup_check(cuda, "int4-g[128]-rw", 256, 512, 40, act, out_dtype)


# every weight layout at g = 128 and 256: int8, pair planes (even group
# counts), group halves (odd ones)
GATEUP_LAYOUTS = [("int8-g[128]-rw", 640), ("int4-g[128]-rw", 512), ("int4-g[128]-rw", 640),
                  ("int8-g[256]-rw", 1024), ("int4-g[256]-rw", 1024), ("int4-g[256]-rw", 768)]


@pytest.mark.parametrize("spec,C", GATEUP_LAYOUTS)
@pytest.mark.parametrize("M", [1, 40, 128, 300])
@pytest.mark.parametrize("I", [128, 384, 8192])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gateup_layouts(cuda, spec, C, M, I, out_dtype):
    """B2 at the split count its plan picks over 128 x 32 output tiles
    (ragged M tiles; small I splits K)."""
    grid = _gateup_check(cuda, spec, I, C, M, "silu", out_dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = int(spec.split("[")[1].split("]")[0])
    fmt = _gateup_weights(spec, I, C)[2]
    assert grid == (-(-I // 32), -(-M // 128), wm.split_plan(M, 2 * I, C, g, fmt, sms))


# K units: int8 8 groups, pair planes 8 group pairs (g = 128 and 256), group
# halves 9 groups
@pytest.mark.parametrize("spec,C", [("int8-g[128]-rw", 1024), ("int4-g[128]-rw", 2048),
                                    ("int4-g[128]-rw", 1152), ("int4-g[256]-rw", 4096)])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gateup_forced_splits(cuda, spec, C, splits, act, out_dtype):
    grid = _gateup_check(cuda, spec, 192, C, 40, act, out_dtype, splits=splits)
    assert grid == (6, 1, splits)


@pytest.mark.parametrize("I", [200, 77])
@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gateup_ragged_i(cuda, I, splits, out_dtype):
    """Output widths that are not a multiple of the 32-wide tile, odd ones
    included (single stores)."""
    _gateup_check(cuda, "int4-g[128]-rw", I, 512, 40, "silu", out_dtype, splits=splits)


@pytest.mark.parametrize("window,softcap", [(0, None), (5, 30.0)])
def test_decode_attention(cuda, window, softcap):
    B, KV, r, D, S = 3, 2, 4, 64, 128
    g = torch.Generator(device="cpu").manual_seed(0)
    q = torch.randn(B, KV, r, D, generator=g).to(cuda)
    kc = torch.randint(-127, 128, (B, KV, S, D), generator=g, dtype=torch.int8).to(cuda)
    vc = torch.randint(-127, 128, (B, KV, S, D), generator=g, dtype=torch.int8).to(cuda)
    ks = (torch.rand(B, KV, S, generator=g) * 0.02).to(cuda)
    vs = (torch.rand(B, KV, S, generator=g) * 0.02).to(cuda)
    nk = torch.randint(-127, 128, (B, KV, D), generator=g, dtype=torch.int8).to(cuda)
    nv = torch.randint(-127, 128, (B, KV, D), generator=g, dtype=torch.int8).to(cuda)
    nks = (torch.rand(B, KV, generator=g) * 0.02).to(cuda)
    nvs = (torch.rand(B, KV, generator=g) * 0.02).to(cuda)
    pos = torch.tensor([0, 37, 127], dtype=torch.int32, device=cuda)
    caches = [t.clone() for t in (kc, vc, ks, vs)]
    got = da.decode_attention_append(q, nk, nv, nks, nvs, kc, vc, ks, vs, pos,
                                     window=window, scale=0.125, softcap=softcap)
    want = da.decode_attention_append_plain(q, nk, nv, nks, nvs, *caches, pos,
                                     window=window, scale=0.125, softcap=softcap)
    for a, b in zip((kc, vc, ks, vs), caches):
        assert torch.equal(a, b)
    # one flipped prob code moves an output by at most 127 * a / sum, and
    # a <= max(v_scale) / 127, sum >= 1
    err = (got - want).abs()
    ulps = 4 * torch.finfo(torch.float32).eps * want.abs() + 1e-7
    flip = float(torch.maximum(vs.max(), nvs.max()))
    assert bool((err <= ulps + flip).all()), float(err.max())
    assert float((err > ulps).float().mean()) <= 0.01


def _attention_inputs(cuda, seed, B=3, KV=2, r=4, D=64, S=128, W=16):
    g = torch.Generator(device="cpu").manual_seed(seed)
    i8 = lambda *shp: torch.randint(-127, 128, shp, generator=g, dtype=torch.int8).to(cuda)
    sc = lambda *shp: (torch.rand(*shp, generator=g) * 0.02 + 1e-3).to(cuda)
    q = torch.randn(B, KV, r, D, generator=g).to(cuda)
    main = (i8(B, KV, S, D), i8(B, KV, S, D), sc(B, KV, S), sc(B, KV, S))
    side = (i8(B, KV, W, D), i8(B, KV, W, D), sc(B, KV, W), sc(B, KV, W))
    return q, main, side


def _assert_attention_close(got, want, vmax):
    err = (got - want).abs()
    ulps = 4 * torch.finfo(torch.float32).eps * want.abs() + 1e-7
    assert bool((err <= ulps + vmax).all()), float(err.max())
    assert float((err > ulps).float().mean()) <= 0.01


@pytest.mark.parametrize("side,window,softcap,t", [(True, 0, None, 5), (True, 40, 30.0, 15),
                                                   (False, 0, None, 0), (False, 9, 20.0, 0)])
def test_two_part_attention(cuda, side, window, softcap, t):
    """B7 against its plain version, with and without the side block; slot 0
    keeps no main row (main_len 0)."""
    q, main, fresh = _attention_inputs(cuda, 2)
    mlen = torch.tensor([0, 37, 120], dtype=torch.int32, device=cuda)
    pos = mlen + t if side else mlen - 1
    fr = fresh if side else None
    before = da.decode_attention.launches
    got = da.decode_attention(q, *main, mlen, pos, window, t, fr, scale=0.125, softcap=softcap)
    assert da.decode_attention.launches == before + 1
    want = da.decode_attention_plain(q, *main, mlen, pos, window, t, fr, scale=0.125,
                                     softcap=softcap)
    vmax = max(float(main[3].max()), float(fresh[3].max()))
    assert bool(got.isfinite().all())
    _assert_attention_close(got, want, vmax)


def test_two_part_attention_no_kept_row(cuda):
    """No main row and no side block: every lane sits at -1e9 and the TPU
    kernel attends uniformly over the window; so do both versions here."""
    q, main, _ = _attention_inputs(cuda, 3)
    mlen = torch.zeros((3,), dtype=torch.int32, device=cuda)
    got = da.decode_attention(q, *main, mlen, mlen, scale=0.125)
    want = da.decode_attention_plain(q, *main, mlen, mlen, scale=0.125)
    _assert_attention_close(got, want, float(main[3].max()))


@pytest.mark.parametrize("window,softcap,t", [(0, None, 4), (50, 30.0, 12)])
def test_stats_attention(cuda, window, softcap, t, monkeypatch):
    """B6 against its plain version on the same side statistics, and the
    hybrid output assembled around each."""
    q, main, fresh = _attention_inputs(cuda, 4)
    mlen = torch.tensor([0, 64, 127], dtype=torch.int32, device=cuda)
    pos = mlen + t
    qi, qs = da.row_quant_i8(q)
    m_f = torch.randn(qs.shape, device=cuda)
    wfm = torch.rand(qs.shape, device=cuda) * 0.02
    before = da.decode_attention_stats.launches
    got = da.decode_attention_stats(qi, qs, m_f, wfm, *main, mlen, pos, window, scale=0.125,
                                    softcap=softcap)
    assert da.decode_attention_stats.launches == before + 1
    want = da.decode_attention_stats_plain(qi, qs, m_f, wfm, *main, mlen, pos, window,
                                           scale=0.125, softcap=softcap)
    # m, a, sum_main: rtol 1e-5 (an ulp of a softcapped score, tanhf against
    # torch's tanh, moves e = exp(s - m) by |s - m| ulps; the sum runs in
    # another order)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    d = (got[0] - want[0]).abs()
    assert float((d > 0).float().mean()) <= 0.01 and float(d.max()) <= 127 * 127
    vmax = max(float(main[3].max()), float(fresh[3].max()))
    args = (q, *main, mlen, pos, window, t, fresh)
    out = da.hybrid_decode_attention(*args, scale=0.125, softcap=softcap)
    monkeypatch.setattr(da, "decode_attention_stats", da.decode_attention_stats_plain)
    _assert_attention_close(out, da.hybrid_decode_attention(*args, scale=0.125, softcap=softcap),
                            vmax)
    # against the two-part epilogue: the hybrid assembly rounds exp(m_f - m)
    # once more, which may move side prob codes (the JAX test's tolerance)
    ref = da.decode_attention_plain(*args, scale=0.125, softcap=softcap)
    torch.testing.assert_close(out, ref, rtol=1e-3, atol=2 * float(fresh[3].max()))


def _attention_case(cuda, kernel, B, KV, r, D, S, W, t, window, softcap, scale, pos, mlen):
    """B4 (``kernel`` "append", new token at ``pos``), B7 ("two_part") or B6
    ("stats") over main rows ``< mlen`` and side lanes ``<= t`` against
    their plain versions, with the tolerances of ``test_decode_attention``,
    ``test_two_part_attention`` and ``test_stats_attention``."""
    q, main, fresh = _attention_inputs(cuda, 7, B=B, KV=KV, r=r, D=D, S=S, W=W)
    vmax = max(float(main[3].max()), float(fresh[3].max()))
    kw = dict(scale=scale, softcap=softcap)
    if kernel == "append":
        g = torch.Generator(device="cpu").manual_seed(8)
        new = (torch.randint(-127, 128, (B, KV, D), generator=g, dtype=torch.int8).to(cuda),
               torch.randint(-127, 128, (B, KV, D), generator=g, dtype=torch.int8).to(cuda),
               (torch.rand(B, KV, generator=g) * 0.02 + 1e-3).to(cuda),
               (torch.rand(B, KV, generator=g) * 0.02 + 1e-3).to(cuda))
        caches = [a.clone() for a in main]
        before = da.decode_attention_append.launches
        got = da.decode_attention_append(q, *new, *main, pos, window=window, **kw)
        assert da.decode_attention_append.launches == before + 1
        want = da.decode_attention_append_plain(q, *new, *caches, pos, window=window, **kw)
        for a, b in zip(main, caches):
            assert torch.equal(a, b)
        _assert_attention_close(got, want, max(vmax, float(new[3].max())))
        return
    pos = mlen + t
    if kernel == "two_part":
        got = da.decode_attention(q, *main, mlen, pos, window, t, fresh, **kw)
        want = da.decode_attention_plain(q, *main, mlen, pos, window, t, fresh, **kw)
        assert bool(got.isfinite().all())
        _assert_attention_close(got, want, vmax)
        return
    qi, qs = da.row_quant_i8(q)
    m_f = torch.randn(qs.shape, device=cuda)
    wfm = torch.rand(qs.shape, device=cuda) * 0.02
    got = da.decode_attention_stats(qi, qs, m_f, wfm, *main, mlen, pos, window, **kw)
    want = da.decode_attention_stats_plain(qi, qs, m_f, wfm, *main, mlen, pos, window, **kw)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    d = (got[0] - want[0]).abs()
    assert float((d > 0).float().mean()) <= 0.01 and float(d.max()) <= 127 * 127


@pytest.mark.parametrize("r", [2, 8])
@pytest.mark.parametrize("kernel", ["append", "two_part", "stats"])
@pytest.mark.parametrize("window,softcap", [(0, None), (100, 50.0)])
def test_attention_head_dim_256(cuda, r, kernel, window, softcap):
    """B4, B7 and B6 at Gemma's head dim 256 against their plain versions:
    r = 2 (Gemma-2-2B) keeps the window resident, r = 8 (Gemma-2B) has a
    cap of 128 keys under S = 256, so its windows go through the f32 score
    scratch. Tolerances as at D = 64."""
    B, KV, D, S, W, t = 3, 2, 256, 256, 16, 9
    assert da.plan(r, D, S, W).scratch == (r == 8)
    _attention_case(cuda, kernel, B, KV, r, D, S, W, t, window, softcap, 256 ** -0.5,
                    torch.tensor([0, 137, 255], dtype=torch.int32, device=cuda),
                    torch.tensor([0, 120, 240], dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("D", [80, 64])
@pytest.mark.parametrize("kernel", ["append", "two_part", "stats"])
@pytest.mark.parametrize("window,scale", [(0, 80 ** -0.5), (100, 1.0)])
def test_attention_one_row(cuda, D, kernel, window, scale):
    """B4, B7 and B6 at r = 1 (multi-head: Phi-2, OPT, one query row per kv
    head, one live row of each 16-row tensor-core tile) at Phi-2's decode
    shape, 128 slots x 32 kv heads over 256 rows, D = 80 (the Q.K
    contraction's last 32-wide step half past D, which the zeroed q codes
    cancel) and OPT's D = 64; scale 1.0 is OPT's pre-scaled query. Slots'
    positions spread over the cache, 0 and S - 1 included. Tolerances as
    at D = 64, r = 4."""
    B, KV, S, W, t = 128, 32, 256, 16, 9
    pos = (torch.arange(B, device=cuda) * (S - 1) // (B - 1)).to(torch.int32)
    mlen = (torch.arange(B, device=cuda) * (S - W) // (B - 1)).to(torch.int32)
    _attention_case(cuda, kernel, B, KV, 1, D, S, W, t, window, None, scale, pos, mlen)


def _long_inputs(cuda, seed, B, KV, r, D, S, W=8):
    """Random codes and scales generated on the card (a 128K cache is too
    large for the host generator to be quick)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    i8 = lambda *shp: torch.randint(-127, 128, shp, generator=g, device=cuda,
                                    dtype=torch.int16).to(torch.int8)
    sc = lambda *shp: torch.rand(shp, generator=g, device=cuda) * 0.02 + 1e-3
    q = torch.randn((B, KV, r, D), generator=g, device=cuda)
    return (q, (i8(B, KV, S, D), i8(B, KV, S, D), sc(B, KV, S), sc(B, KV, S)),
            (i8(B, KV, W, D), i8(B, KV, W, D), sc(B, KV, W), sc(B, KV, W)))


# cache lengths the first design could not launch (its shared memory grew
# with S: r * S * 5 bytes); a window of 1001 keys ends at S - 1 (starting
# at S - 1001, not 4-aligned) and at 5002 (starting at 4002), or the full
# cache; slot 0 sits at position 0. No window is a whole number of chunks.
LONG = [(S, r, D, window) for S in (16384, 131072) for r in (4, 8) for D in (64, 128)
        for window in (0, 1001)]


@pytest.mark.parametrize("S,r,D,window", LONG)
def test_decode_attention_long(cuda, S, r, D, window):
    """B4 at long caches: the written cache bitwise, the output within B4's
    tolerance (the score scratch holds windows past the resident cap)."""
    B, KV = 3, 2
    q, (kc, vc, ks, vs), (nk, nv, nks, nvs) = _long_inputs(cuda, S + r + D, B, KV, r, D, S, 1)
    nk, nv, nks, nvs = nk[:, :, 0], nv[:, :, 0], nks[:, :, 0], nvs[:, :, 0]
    pos = torch.tensor([0, S - 1, 5002], dtype=torch.int32, device=cuda)
    caches = [t.clone() for t in (kc, vc, ks, vs)]
    before = da.decode_attention_append.launches
    got = da.decode_attention_append(q, nk, nv, nks, nvs, kc, vc, ks, vs, pos, window=window,
                                     scale=D ** -0.5)
    assert da.decode_attention_append.launches == before + 1
    want = da.decode_attention_append_plain(q, nk, nv, nks, nvs, *caches, pos, window=window,
                                            scale=D ** -0.5)
    for a, b in zip((kc, vc, ks, vs), caches):
        assert torch.equal(a, b)
    _assert_attention_close(got, want, float(torch.maximum(vs.max(), nvs.max())))


@pytest.mark.parametrize("side", [True, False])
@pytest.mark.parametrize("S,r,D,window", LONG)
def test_two_part_attention_long(cuda, S, r, D, window, side):
    """B7 at long caches, with the side block (t = 5; slot 0 keeps no main
    row) and without (slot 0 at position 0)."""
    B, KV, t = 3, 2, 5
    q, main, fresh = _long_inputs(cuda, S + 2 * r + D, B, KV, r, D, S)
    if side:
        mlen = torch.tensor([0, S, 4997], dtype=torch.int32, device=cuda)
        pos, fr = mlen + t, fresh
    else:
        mlen = torch.tensor([1, S, 5003], dtype=torch.int32, device=cuda)
        pos, fr = mlen - 1, None
    got = da.decode_attention(q, *main, mlen, pos, window, t, fr, scale=D ** -0.5)
    want = da.decode_attention_plain(q, *main, mlen, pos, window, t, fr, scale=D ** -0.5)
    _assert_attention_close(got, want, max(float(main[3].max()), float(fresh[3].max())))


@pytest.mark.parametrize("S,r,D,window", LONG)
def test_stats_attention_long(cuda, S, r, D, window):
    """B6 at long caches, within its tolerance (m, a, sum_main rtol 1e-5;
    o32 equal but for flipped prob codes on at most 1 % of entries)."""
    B, KV = 3, 2
    q, main, _ = _long_inputs(cuda, S + 3 * r + D, B, KV, r, D, S)
    mlen = torch.tensor([1, S, 5003], dtype=torch.int32, device=cuda)
    pos = mlen + 4
    qi, qs = da.row_quant_i8(q)
    m_f = torch.randn(qs.shape, device=cuda)
    wfm = torch.rand(qs.shape, device=cuda) * 0.02
    got = da.decode_attention_stats(qi, qs, m_f, wfm, *main, mlen, pos, window, scale=D ** -0.5)
    want = da.decode_attention_stats_plain(qi, qs, m_f, wfm, *main, mlen, pos, window,
                                           scale=D ** -0.5)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    d = (got[0] - want[0]).abs()
    assert float((d > 0).float().mean()) <= 0.01


def _flagship_append(cuda, seed=11, B=128, KV=8, r=4, D=64, S=256, pos=144):
    g = torch.Generator(device=cuda).manual_seed(seed)
    i8 = lambda *shp: torch.randint(-127, 128, shp, generator=g, device=cuda,
                                    dtype=torch.int16).to(torch.int8)
    sc = lambda *shp: torch.rand(shp, generator=g, device=cuda) * 0.02
    q = torch.randn((B, KV, r, D), generator=g, device=cuda)
    cache = [i8(B, KV, S, D), i8(B, KV, S, D), sc(B, KV, S), sc(B, KV, S)]
    new = [i8(B, KV, D), i8(B, KV, D), sc(B, KV), sc(B, KV)]
    return q, cache, new, torch.full((B,), pos, dtype=torch.int32, device=cuda)


def test_decode_attention_flagship_codes(cuda):
    """B4 at the flagship decode shape (B=128 KV=8 r=4 D=64 S=256, pos 144):
    the written cache bitwise; two launches bitwise equal; the output within
    B4's tolerance; and every prob code equal to the plain version's. The
    codes are read through V caches of unit rows: with V row t = e_(t - 64k)
    on keys [64k, 64k + 64) and 0 elsewhere, out[i, d] = pi[i, 64k + d] *
    (a / sum), and a / sum agrees to f32 ulps, far below the 1/127 that one
    code step moves it."""
    q, cache, new, pos = _flagship_append(cuda)
    B, KV, r, D = q.shape
    S, n = cache[0].shape[2], int(pos[0]) + 1
    bufs, ref = [t.clone() for t in cache], [t.clone() for t in cache]
    got = da.decode_attention_append(q, *new, *bufs, pos, scale=0.125)
    want = da.decode_attention_append_plain(q, *new, *ref, pos, scale=0.125)
    for a, b in zip(bufs, ref):
        assert torch.equal(a, b)
    _assert_attention_close(got, want, float(torch.maximum(cache[3].max(), new[3].max())))
    assert torch.equal(da.decode_attention_append(q, *new, *bufs, pos, scale=0.125), got)

    qi, qs = da.row_quant_i8(q)
    keep = (torch.arange(S, device=cuda) < n)[None, :].expand(B, S)
    s = da._masked(da._scores(qi, qs, ref[0], ref[2], 0.125, None), keep)
    (pi,), oscale = da.i8_softmax_requant([s], [ref[3]])
    eye = torch.eye(D, dtype=torch.int8, device=cuda)
    for k in range((n + D - 1) // D):
        vk = torch.zeros((S, D), dtype=torch.int8, device=cuda)
        vk[k * D:(k + 1) * D] = eye
        vk = vk.expand(B, KV, S, D).contiguous()
        nv = vk[:, :, n - 1].contiguous()
        out = da.decode_attention_append(q, new[0], nv, new[2], new[3], ref[0].clone(), vk,
                                         ref[2].clone(), ref[3].clone(), pos, scale=0.125)
        codes = torch.round(out / oscale)[..., :min(D, n - k * D)]
        assert torch.equal(codes, pi[..., k * D:k * D + codes.shape[-1]])


def test_two_part_attention_flagship_repeatable(cuda):
    """B7 at the flagship two-part shape ([main | side], len0=128 t=16
    W=32): two launches bitwise equal, within B7's tolerance."""
    g = torch.Generator(device=cuda).manual_seed(12)
    B, KV, r, D, S, W, t = 128, 8, 4, 64, 256, 32, 16
    i8 = lambda *shp: torch.randint(-127, 128, shp, generator=g, device=cuda,
                                    dtype=torch.int16).to(torch.int8)
    sc = lambda *shp: torch.rand(shp, generator=g, device=cuda) * 0.02
    q = torch.randn((B, KV, r, D), generator=g, device=cuda)
    main = (i8(B, KV, S, D), i8(B, KV, S, D), sc(B, KV, S), sc(B, KV, S))
    fresh = (i8(B, KV, W, D), i8(B, KV, W, D), sc(B, KV, W), sc(B, KV, W))
    mlen = torch.full((B,), 128, dtype=torch.int32, device=cuda)
    got = da.decode_attention(q, *main, mlen, mlen + t, 0, t, fresh, scale=0.125)
    assert torch.equal(da.decode_attention(q, *main, mlen, mlen + t, 0, t, fresh, scale=0.125),
                       got)
    want = da.decode_attention_plain(q, *main, mlen, mlen + t, 0, t, fresh, scale=0.125)
    _assert_attention_close(got, want, max(float(main[3].max()), float(fresh[3].max())))


def test_fresh_write(cuda):
    g = torch.Generator(device="cpu").manual_seed(5)
    L, B, KV, W, D = 3, 4, 2, 8, 64
    fresh = [torch.randint(-127, 128, (L, B, KV, W, D), generator=g, dtype=torch.int8).to(cuda)
             for _ in range(2)] + [torch.rand(L, B, KV, W, generator=g).to(cuda) for _ in range(2)]
    new = [torch.randint(-127, 128, (B, KV, D), generator=g, dtype=torch.int8).to(cuda)
           for _ in range(2)] + [torch.rand(B, KV, generator=g).to(cuda) for _ in range(2)]
    want = da.fresh_write_plain([a.clone() for a in fresh], new, 2, 7)
    before = da.fresh_write.launches
    got = da.fresh_write(tuple(fresh), new, 2, 7)
    assert da.fresh_write.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _offset_view(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` elements into its
    storage (so off a 16-byte boundary)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


# D 64 and 128, the first and the last lane, every copy width: whole
# 16-byte pieces, 4-byte pieces (codes 4 bytes off), bytes (D = 38, or codes
# 1 byte off), scales off a 16-byte boundary or B * KV not a multiple of 4
# (one scale a thread instead of a float4 of four)
@pytest.mark.parametrize("D,code_off,scale_off,BKV,want", [
    (64, 0, 0, (4, 3), (16, True)), (128, 0, 0, (4, 3), (16, True)),
    (64, 4, 0, (4, 3), (4, True)), (64, 1, 0, (4, 3), (1, True)),
    (38, 0, 0, (4, 3), (1, True)), (36, 0, 1, (4, 3), (4, False)),
    (128, 4, 3, (4, 3), (4, False)), (64, 0, 0, (5, 3), (16, False))])
@pytest.mark.parametrize("t", [0, 7])
def test_fresh_write_widths(cuda, D, code_off, scale_off, BKV, want, t):
    g = torch.Generator(device="cpu").manual_seed(D + t)
    L, (B, KV), W = 3, BKV, 8
    codes = lambda *shp: _offset_view(torch.randint(-127, 128, shp, generator=g,
                                                    dtype=torch.int8).to(cuda), code_off)
    scales = lambda *shp: _offset_view(torch.rand(*shp, generator=g).to(cuda), scale_off)
    fresh = [codes(L, B, KV, W, D), codes(L, B, KV, W, D), scales(L, B, KV, W),
             scales(L, B, KV, W)]
    new = [codes(B, KV, D), codes(B, KV, D), scales(B, KV), scales(B, KV)]
    assert da.write_widths(fresh, new) == want
    want_bufs = da.fresh_write_plain([a.clone() for a in fresh], new, 1, t)
    got = da.fresh_write(tuple(fresh), new, 1, t)
    for a, b in zip(got, want_bufs):
        assert torch.equal(a, b)


def test_fresh_write_flagship(cuda):
    """B = 128, KV = 8, D = 64, L = 16, W = 32 at lanes 0 and W - 1."""
    g = torch.Generator(device="cpu").manual_seed(9)
    L, B, KV, W, D = 16, 128, 8, 32, 64
    fresh = [torch.randint(-127, 128, (L, B, KV, W, D), generator=g, dtype=torch.int8).to(cuda)
             for _ in range(2)] + [torch.rand(L, B, KV, W, generator=g).to(cuda) for _ in range(2)]
    for layer, t in ((0, 0), (15, W - 1)):
        new = [torch.randint(-127, 128, (B, KV, D), generator=g, dtype=torch.int8).to(cuda)
               for _ in range(2)] + [torch.rand(B, KV, generator=g).to(cuda) for _ in range(2)]
        want = da.fresh_write_plain([a.clone() for a in fresh], new, layer, t)
        da.fresh_write(tuple(fresh), new, layer, t)
        for a, b in zip(fresh, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("spec,C", [("int4-g[128]-rw", 512), ("int4-g[128]-rw", 640),
                                    ("int8-g[128]-rw", 640), ("int4-g[128]-rw", 3072),
                                    ("int4-g[128]-rw", 4096), ("int4-g[128]-rw", 8192),
                                    ("int8-g[128]-rw", 8192)])
@pytest.mark.parametrize("M", [8, 40, 130])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_w4a8_actq(cuda, spec, C, M, x_dtype):
    """B9 bitwise against the act quantizer + B3's plain version at the
    launched split count, and against the host quantizer + B3; any C runs
    (each row is quantized once, into scratch)."""
    N = 320
    qt = _packed(spec, N, C, seed=M)[0]
    codes, scales = qt.codes.to(cuda), qt.scales.to(cuda)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(M, C)).astype(np.float32))
    x = x.to(cuda).to(x_dtype)
    fmt = wm._wfmt(qt)
    before = wm.matmul_actq.launches
    got = wm.matmul_actq(x, codes, scales, fmt, x_dtype)
    assert wm.matmul_actq.launches == before + 1
    want = wm.actq_plain(x, codes, scales, fmt, x_dtype, splits=wm.matmul_actq.last_grid[2])
    assert got.dtype == x_dtype and torch.equal(got, want)
    # the same as the act quantizer on the host side, then B3
    x_i8, sx = wm.quantize_acts_per_token(x)
    assert torch.equal(got, wm.matmul_flat(x_i8, codes, scales, sx, fmt, x_dtype))


def test_decode_attention_position_outside_cache(cuda):
    """A slot whose position lies outside the cache gets NaN and no write;
    the other slots are unaffected."""
    B, KV, r, D, S = 2, 2, 4, 64, 32
    g = torch.Generator(device="cpu").manual_seed(1)
    q = torch.randn(B, KV, r, D, generator=g).to(cuda)
    kc = torch.randint(-127, 128, (B, KV, S, D), generator=g, dtype=torch.int8).to(cuda)
    vc = torch.randint(-127, 128, (B, KV, S, D), generator=g, dtype=torch.int8).to(cuda)
    ks = (torch.rand(B, KV, S, generator=g) * 0.02).to(cuda)
    vs = (torch.rand(B, KV, S, generator=g) * 0.02).to(cuda)
    nk = torch.ones((B, KV, D), dtype=torch.int8, device=cuda)
    ns = torch.ones((B, KV), device=cuda)
    before = [t.clone() for t in (kc, vc, ks, vs)]
    pos = torch.tensor([S, 5], dtype=torch.int32, device=cuda)
    out = da.decode_attention_append(q, nk, nk, ns, ns, kc, vc, ks, vs, pos, scale=0.125)
    torch.cuda.synchronize()
    assert bool(out[0].isnan().all()) and bool(out[1].isfinite().all())
    for a, b in zip((kc, vc, ks, vs), before):
        assert torch.equal(a[0], b[0])
    assert bool((kc[1, :, 5] == 1).all())


# every body and both int4 layouts: even group counts pack as pair planes,
# odd ones as group halves. At N = 192 the card's SMs are far from full, so
# K is split: int4-g[256] at C = 768 (G = 3) takes 2 splits of 2 and 1
# groups; C = 8192 runs at N = 2048, 8 splits at M = 8, 4 at 130. Group
# sizes off the 64-element chunk end in a partial chunk (g = 160 and 144;
# group halves of 80 bytes), and groups off a 16-byte boundary take the
# plain-load build (int8 and pair planes at g = 136, halves of 72 and of 65
# bytes, fp8 at g = 130).
@pytest.mark.parametrize("spec,C", [
    ("int4-g[128]-rw", 512), ("int4-g[128]-zp-rw", 512), ("int4-g[256]-rw", 768),
    ("int4-g[256]-zp-rw", 768), ("int8-g[128]-rw", 384), ("int8-g[128]-zp-rw", 384),
    ("fp8_e4m3-g[128]-rw", 512), ("fp8_e5m2-g[128]-rw", 512), ("fp8_e4m3-g[128]-zp-rw", 512),
    ("fp8_e5m2-g[128]-zp-rw", 512), ("int4-g[192]-rw", 768), ("int4-g[128]-zp-rw", 8192),
    ("int8-g[160]-rw", 640), ("int4-g[160]-rw", 640), ("int4-g[160]-zp-rw", 480),
    ("int8-g[136]-zp-rw", 408), ("int4-g[136]-rw", 544), ("int4-g[144]-rw", 432),
    ("int4-g[130]-zp-rw", 390), ("fp8_e4m3-g[130]-zp-rw", 390), ("int4-g[144]-rw", 576),
    ("fp8_e5m2-g[144]-rw", 576)])
@pytest.mark.parametrize("M", [8, 130])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_dequant_matmul(cuda, spec, C, M, out_dtype):
    N = 2048 if C == 8192 else 192
    qt = _packed(spec, N, C, seed=M)[0]
    codes, scales = qt.codes.to(cuda), qt.scales.to(cuda)
    zeros = None if qt.zeros is None else qt.zeros.to(cuda)
    fmt = dm.weight_format(qt)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(M, C)).astype(np.float32))
    xb = x.to(torch.bfloat16).to(cuda)
    before = dm.dequant_matmul_codes.launches
    got = dm.dequant_matmul_codes(xb, codes, scales, zeros, fmt, out_dtype)
    assert dm.dequant_matmul_codes.launches == before + 1
    want = dm.dequant_matmul_plain(xb, codes, scales, zeros, fmt, out_dtype)
    w = dm.dequant_weight_bf16(codes, scales, zeros, fmt).float()
    mag = xb.float().abs() @ w.abs().t()
    ulp = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11, torch.float32: 2.0 ** -24}[out_dtype]
    tol = 2 * ulp * want.float().abs() + 2 * C * 2.0 ** -24 * mag
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    # the weight the kernel builds, read out through x = I
    eye = torch.eye(C, device=cuda, dtype=torch.bfloat16)
    wt = dm.dequant_matmul_codes(eye, codes, scales, zeros, fmt, torch.float32)
    assert torch.equal(wt, w.t())


def _b5_inputs(cuda, spec, N, C, M, seed=0):
    qt = _packed(spec, N, C, seed=seed)[0]
    zeros = None if qt.zeros is None else qt.zeros.to(cuda)
    x = torch.from_numpy(np.random.default_rng(seed + 1).normal(size=(M, C)).astype(np.float32))
    return (x.to(torch.bfloat16).to(cuda), qt.codes.to(cuda), qt.scales.to(cuda), zeros,
            dm.weight_format(qt))


# (spec, N, C, M, splits on a 132-SM card): one unsplit case, the rest split
@pytest.mark.parametrize("spec,N,C,M,want_s", [("int4-g[128]-zp-rw", 16384, 1024, 128, 1),
                                               ("int4-g[128]-zp-rw", 2048, 8192, 8, 8),
                                               ("int4-g[256]-rw", 192, 768, 8, 2),
                                               ("int8-g[128]-rw", 2048, 2048, 130, 4),
                                               ("int8-g[136]-rw", 192, 408, 8, 2)])
def test_dequant_matmul_deterministic(cuda, spec, N, C, M, want_s):
    """Two launches on the same inputs give the same bits, without splits
    and with them (the partials are added in split order, no atomics)."""
    xb, codes, scales, zeros, fmt = _b5_inputs(cuda, spec, N, C, M)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms == 132:
        assert dm.split_plan(M, N, C, C // scales.shape[1], fmt, sms) == want_s
    a = dm.dequant_matmul_codes(xb, codes, scales, zeros, fmt, torch.bfloat16)
    assert dm.dequant_matmul_codes.last_grid[2] == dm.split_plan(M, N, C, C // scales.shape[1],
                                                                 fmt, sms)
    b = dm.dequant_matmul_codes(xb, codes, scales, zeros, fmt, torch.bfloat16)
    assert torch.equal(a, b)


# power-of-two sizes from 2 up (R2 at head_dim 64, R1 at hidden 2048), every
# base K, and row counts that are not a multiple of anything
@pytest.mark.parametrize("n", [2, 64, 2048, 8192, 32768, 12, 96, 2560, 28 * 32, 36 * 8,
                               44 * 4, 52 * 16, 60 * 2, 108 * 8, 140 * 64])
@pytest.mark.parametrize("rows", [1, 7, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hadamard(cuda, n, rows, dtype):
    x = torch.from_numpy(np.random.default_rng(n + rows).normal(size=(rows, n))
                         .astype(np.float32)).to(cuda).to(dtype)
    before = hd.hadamard_transform.launches
    got = hd.hadamard_transform(x)
    assert hd.hadamard_transform.launches == before + 1
    want = hd.hadamard_transform_plain(x)
    assert got.dtype == dtype and torch.equal(got, want)
    got = hd.hadamard_transform(x[None], scale=0.5)   # leading dims, explicit scale
    assert torch.equal(got[0], hd.hadamard_transform_plain(x, scale=0.5))


def test_hadamard_signed_diagonal_bitwise(cuda):
    """The R1 / R2 draws: H diag(+-1) / sqrt(n) on the card equals the CPU's."""
    for n in (64, 2048):
        signs = torch.from_numpy(np.random.default_rng(n).choice([-1.0, 1.0], n)
                                 .astype(np.float32))
        assert torch.equal(hd.signed_hadamard(signs.to(cuda)).cpu(), hd.signed_hadamard(signs))


def test_hadamard_refuses(cuda):
    with pytest.raises(ValueError, match="unsupported"):
        hd.hadamard_transform(torch.zeros(2, 24 * 7, device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        hd.hadamard_transform(torch.zeros(2, 64, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="shared memory"):
        hd.hadamard_transform(torch.zeros(1, 1 << 16, device=cuda))


# every change of the layout (kernels/hadamard.py::plan): E = 1, 2, 4 (tiny
# rows), E = 8 -> 16 -> 32 in one pass (m 256, 512, 1024), two passes at
# E = 8, 16, 32 (m 2048, 4096 / 8192, 16384 / 32768), and the largest rows
# of several bases; row counts around the rows per CTA
LAYOUT_SIZES = [1, 2, 4, 8, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                28 * 2048, 108 * 512, 12 * 4096]


@pytest.mark.parametrize("n", LAYOUT_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hadamard_layout_boundaries(cuda, n, dtype):
    p = hd.plan(n)
    for rows in sorted({1, 3, p.rows - 1 or 1, p.rows + 1, 2 * p.rows + 3}):
        x = torch.from_numpy(np.random.default_rng(n + rows).normal(size=(rows, n))
                             .astype(np.float32)).to(cuda).to(dtype)
        got = hd.hadamard_transform(x)
        assert got.dtype == dtype and torch.equal(got, hd.hadamard_transform_plain(x)), rows


# every base K at its smallest m (E > m), a middle m and its largest m
@pytest.mark.parametrize("K", [12, 20, 28, 36, 44, 52, 60, 108, 140])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hadamard_every_base(cuda, K, dtype):
    sizes = [K, 2 * K, 4 * K, 16 * K, 128 * K]
    m = 1
    while K * m * 2 * 4 + hd.sign_bytes(K) <= hd.SMEM_BYTES:
        m *= 2
    sizes.append(K * m)
    for n in sizes:
        rows = hd.plan(n).rows + 1
        x = torch.from_numpy(np.random.default_rng(n).normal(size=(rows, n))
                             .astype(np.float32)).to(cuda).to(dtype)
        assert torch.equal(hd.hadamard_transform(x), hd.hadamard_transform_plain(x)), n


@pytest.mark.parametrize("n", [64, 2560, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hadamard_unaligned_rows(cuda, n, dtype):
    """x starting off a 16-byte boundary takes the kernel's scalar loads."""
    x = _offset_view(torch.from_numpy(np.random.default_rng(n).normal(size=(5, n))
                                      .astype(np.float32)).to(cuda).to(dtype), 1)
    assert x.data_ptr() % 16
    assert torch.equal(hd.hadamard_transform(x), hd.hadamard_transform_plain(x))


# ---------------------------------------------------------------------------
# CUDA graphs of the serving engine (engine/graph.py) at 2 layers: a graph
# replays the eager loop's kernels in the same order on the same shapes, so
# tokens, cache codes, scales and lengths are bitwise equal to the loop's.
# ---------------------------------------------------------------------------

SERVING_CFG = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
                   head_dim=64, num_layers=2, vocab_size=512, dtype="bfloat16")
W4A8_SPEC = (("int4-g[128]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw"), "int8-g[-1]-rw")
WEIGHT_ONLY_SPEC = (("int4-g[128]-zp-rw", None, None, "int8-g[128]-rw"), None)


@functools.lru_cache(maxsize=None)
def _serving_model(spec):
    """RTN -> pack -> fuse -> stack of random weights on the card."""
    from llm_compressor_tpu_torch.algorithms import pack_model, rtn
    from llm_compressor_tpu_torch.models import fuse_model, init_params, stack_model, tiny_config
    from llm_compressor_tpu_torch.qformats import build_quant_config

    cfg = tiny_config("llama", **SERVING_CFG)
    qcfg = build_quant_config(*spec[0], head_act=spec[1])
    p = init_params(cfg, seed=0, device="cuda")
    rtn(p, cfg, qcfg)
    pack_model(p, cfg, qcfg)
    return cfg, qcfg, stack_model(fuse_model(p, cfg, qcfg))


def _prefilled(cfg, qcfg, params, quantized, B=4, T=16, max_len=64, seed=0):
    from llm_compressor_tpu_torch.engine import init_cache, prefill

    g = torch.Generator(device="cpu").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g, dtype=torch.int32).cuda()
    cache = init_cache(cfg.num_layers, B, max_len, cfg.num_kv_heads, cfg.head_dim,
                       quantized=quantized, device="cuda")
    logits, cache = prefill(params, toks, cache, cfg=cfg, qcfg=qcfg)
    return torch.argmax(logits, -1).to(torch.int32)[:, None], cache


def _clone_cache(cache):
    from llm_compressor_tpu_torch.engine.graph import _map

    return _map(torch.clone, cache)


def _same_cache(a, b):
    return all((getattr(a, n) is None and getattr(b, n) is None)
               or torch.equal(getattr(a, n), getattr(b, n))
               for n in ("k", "v", "k_scale", "v_scale", "lengths"))


def _restore(cache, start):
    for name in ("k", "v", "k_scale", "v_scale", "lengths"):
        if getattr(cache, name) is not None:
            getattr(cache, name).copy_(getattr(start, name))


@pytest.mark.parametrize("spec,attention", [(W4A8_SPEC, "append"), (W4A8_SPEC, "two_part"),
                                            (W4A8_SPEC, "hybrid"),
                                            (WEIGHT_ONLY_SPEC, "append")])
def test_graph_decode_equals_loop(cuda, spec, attention):
    """``decode_greedy_steps`` as one graph against its eager loop from the
    same prefilled cache: tokens, codes, scales and lengths bitwise. On one
    cache the first call runs eagerly, the second captures, the third
    replays; each replay counts the launches of the loop's steps."""
    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.engine import decode_greedy_steps

    cfg, qcfg, p = _serving_model(spec)
    quantized = spec is W4A8_SPEC
    tok, cache = _prefilled(cfg, qcfg, p, quantized)
    start = _clone_cache(cache)
    loop_cache = _clone_cache(cache)
    n = 8
    kernels.reset_counts()
    want, loop_cache = decode_greedy_steps(p, tok, loop_cache, n=n, cfg=cfg, qcfg=qcfg,
                                           attention=attention, graph=False)
    loop_counts = kernels.launch_counts()
    assert any(loop_counts.values())
    for captures in (0, 1, 1):
        _restore(cache, start)
        kernels.reset_counts()
        got, cache = decode_greedy_steps(p, tok, cache, n=n, cfg=cfg, qcfg=qcfg,
                                         attention=attention)
        assert cache.graphs.captures == captures
        assert kernels.launch_counts() == loop_counts
        assert torch.equal(got, want) and _same_cache(cache, loop_cache)


def test_graph_new_cache_new_capture(cuda):
    """A graph is kept on the cache it was captured on, keyed by the
    buffers it bakes in: a new cache of the same shapes starts eagerly and
    captures its own, another ``n`` another, and each cache decodes as the
    loop does."""
    from llm_compressor_tpu_torch.engine import decode_greedy_steps

    cfg, qcfg, p = _serving_model(W4A8_SPEC)
    tok, a = _prefilled(cfg, qcfg, p, True, seed=1)
    tok_b, b = _prefilled(cfg, qcfg, p, True, seed=2)
    ref_b = _clone_cache(b)
    for captures in (0, 1, 1):
        decode_greedy_steps(p, tok, a, n=4, cfg=cfg, qcfg=qcfg)
        assert a.graphs.captures == captures
    for captures in (0, 1):
        got, b = decode_greedy_steps(p, tok_b, b, n=4, cfg=cfg, qcfg=qcfg)
        want, ref_b = decode_greedy_steps(p, tok_b, ref_b, n=4, cfg=cfg, qcfg=qcfg,
                                          graph=False)
        assert b.graphs.captures == captures and a.graphs.captures == 1
        assert torch.equal(got, want) and _same_cache(b, ref_b)
        tok_b = got[:, -1:]
    for captures in (1, 2):                                         # another n
        decode_greedy_steps(p, tok, a, n=5, cfg=cfg, qcfg=qcfg)
        assert a.graphs.captures == captures


def test_graph_failed_capture_raises(cuda):
    """A capture that fails raises, at every call, and nothing falls back to
    the eager function; the launch counters are left as they were."""
    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.engine import graph as graphs
    from llm_compressor_tpu_torch.engine import init_cache

    cache = init_cache(1, 2, 8, 1, 64, device="cuda")
    eager = []

    def fn(x):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("no capture")
        eager.append(1)
        return x + 1

    kernels.reset_counts()
    x = torch.zeros(4, device="cuda")
    assert torch.equal(graphs.run(cache, "k", fn, (x,)), x + 1)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no capture"):
            graphs.run(cache, "k", fn, (x,))
    assert len(eager) == 1 and cache.graphs.captures == 0
    assert not any(kernels.launch_counts().values())


def test_graph_decode_step_equals_eager(cuda):
    """``decode_step`` through its one-step graph: the eager step's logits
    and cache, bitwise, over four steps (the first eager, the second
    captures, then replays)."""
    from llm_compressor_tpu_torch.engine import decode_step

    cfg, qcfg, p = _serving_model(W4A8_SPEC)
    tok, cache = _prefilled(cfg, qcfg, p, True, seed=3)
    ref = _clone_cache(cache)
    for captures in (0, 1, 1, 1):
        got, cache = decode_step(p, tok, cache, cfg=cfg, qcfg=qcfg)
        want, ref = decode_step(p, tok, ref, cfg=cfg, qcfg=qcfg, graph=False)
        assert torch.equal(got, want) and _same_cache(cache, ref)
        assert cache.graphs.captures == captures
        tok = torch.argmax(got, -1).to(torch.int32)[:, None]


def test_batcher_graph_equals_eager(cuda):
    """The continuous batcher with its decode step as one graph against the
    eager batcher: the same ids for every request and the same shared
    cache, a finished slot decoding on at ``max_len`` included."""
    from llm_compressor_tpu_torch.engine import ContinuousBatcher

    cfg, qcfg, p = _serving_model(W4A8_SPEC)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32)
               for t in (5, 40, 17, 58, 9, 33)]
    out = []
    for graph in (True, False):
        eng = ContinuousBatcher(p, cfg, batch_slots=3, max_len=64, qcfg=qcfg, quantized_kv=True,
                                prefill_chunk=16, graph=graph)
        eng.warmup()
        for t in prompts:
            eng.submit(t, max_new_tokens=8)
        out.append((eng.run(), eng.cache))
    (ga, gc), (ea, ec) = out
    assert gc.graphs.captures == 1 and ec.graphs.captures == 0
    assert set(ga) == set(ea) == set(range(1, 7))
    assert all(np.array_equal(ga[u], ea[u]) for u in ga)
    assert len(ga[4]) == 64 - 58 and _same_cache(gc, ec)


@pytest.mark.parametrize("quantized", [True, False])
def test_speculative_rounds_graph_equals_eager(cuda, quantized):
    """Four draft + verify rounds as one graph against the eager rounds from
    the same state, over three calls (the first eager, the second
    captures, the third replays): history, lengths, accept counts and
    cache bitwise after each."""
    from llm_compressor_tpu_torch.engine import init_cache, prefill
    from llm_compressor_tpu_torch.engine.speculative import speculative_rounds

    spec = W4A8_SPEC if quantized else WEIGHT_ONLY_SPEC
    cfg, qcfg, p = _serving_model(spec)
    motif = np.random.default_rng(5).integers(0, cfg.vocab_size, 4)
    prompt = torch.from_numpy(np.tile(motif, (4, 4)).astype(np.int32)).cuda()   # (4, 16)
    cache = init_cache(cfg.num_layers, 4, 96, cfg.num_kv_heads, cfg.head_dim,
                       quantized=quantized, device="cuda")
    logits, cache = prefill(p, prompt, cache, cfg=cfg, qcfg=qcfg)
    hist = torch.zeros((4, 72), dtype=torch.int32, device="cuda")
    hist[:, :16] = prompt
    hist[:, 16] = torch.argmax(logits, -1).to(torch.int32)
    hlen = torch.full((4,), 17, dtype=torch.int32, device="cuda")
    active = torch.tensor([True, True, False, True], device="cuda")
    state = [(hist.clone(), hlen.clone(), _clone_cache(cache)) for _ in range(2)]
    for captures in (0, 1, 1):
        res = [speculative_rounds(p, h, hl, c, active, rounds=4, k=3, ngram=2, cfg=cfg,
                                  qcfg=qcfg, graph=graph)
               for (h, hl, c), graph in zip(state, (True, False))]
        (gh, gl, gc, gacc), (eh, el, ec, eacc) = res
        assert torch.equal(gacc, eacc) and torch.equal(gh, eh) and torch.equal(gl, el)
        assert _same_cache(gc, ec) and int(gl[2]) == 17
        assert gc.graphs.captures == captures
