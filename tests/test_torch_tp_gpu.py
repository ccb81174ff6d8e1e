"""Tensor parallelism on the card: the TP kernel path against the TP plain
path, B1-B4 at the local shapes of Llama-3.2-1B's ranks, each against
its plain version, and, with a card a rank, the NCCL graphs of the TP
decode step and of the TP batcher against their eager runs (bitwise).

Run on a machine with an H100:
``python -m pytest -m gpu --noconftest tests/test_torch_tp_gpu.py``.
Here, without a card, every test skips (the check runs inside a fixture).
This file imports no JAX: the CPU side is held to the JAX package by
``tests/test_torch_tp.py`` and ``tests/test_torch_parallel.py``. The ranks
(``tests/torch_tp_ranks.py::gpu_paths``) run over NCCL, one card each,
where the machine has enough cards, else all on card 0 over gloo.

Tolerances: the TP kernel path's greedy tokens equal its plain path's
wherever the plain logits' top-2 gap exceeds 0.1 (``chip_smoke.py``'s
token check), and every rank's logits bitwise rank 0's. The local shapes:
B1 and B3 bitwise their plain version at the launched split count, B2 to
one bf16 ulp, B4's written codes bitwise and its output to the bounds of
``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

from llm_compressor_tpu_torch.kernels import decode_attention as da
from llm_compressor_tpu_torch.kernels import w4a8_matmul as wm
from llm_compressor_tpu_torch.parallel import launch
import torch_tp_ranks

pytestmark = pytest.mark.gpu

E, I, V = 2048, 8192, 128256   # Llama-3.2-1B


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (H100); the CPU side is held to JAX by the CPU tests")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [2, 4])
def test_tp_kernel_path_matches_plain(cuda, n, tmp_path):
    backend = launch.pick_backend(n)
    devices = [f"cuda:{r}" for r in range(n)] if backend == "nccl" else ["cuda:0"] * n
    res = launch.run(torch_tp_ranks.gpu_paths, n, str(tmp_path), (0,), backend=backend,
                     devices=devices, timeout=600)
    want_steps = {"w4a8_stacked": 6, "w4a8_gateup": 2, "w4a8_flat": 1,
                  "decode_attention_append": 2}
    for r in res:
        assert r["steps"] == [want_steps] * 3
        assert r["plain_steps"] == [{}] * 3
        assert r["local_o_codes"] == (2, 512, 512 // n // 2)
        checked = 0
        for got, want, ref in zip(r["kernel"], r["plain"], res[0]["kernel"]):
            np.testing.assert_array_equal(got, ref)
            top2 = np.sort(want, -1)[:, -2:]
            sure = top2[:, 1] - top2[:, 0] > 0.1
            checked += int(sure.sum())
            np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
        assert checked > 0


@pytest.mark.parametrize("n", [2, 4])
def test_row_parallel_b1_above_256_rows(cuda, n, tmp_path):
    """A row-parallel ``down`` at 1024 rows (Qwen3-1.7B's 2048 x 6144,
    under ``models/layers.py::CARD_W4A8_ROWS``) takes B1 on every rank, as
    the single device does: each rank's act codes and the per-token scales
    (the absmax over the whole row) equal the single device's, every rank
    holds rank 0's sum, within the dense-route routing tolerance
    (``tests/test_torch_dequant_matmul.py``, 2e-2) of the single device's
    output: the partials are rounded to bf16 and summed in bf16."""
    backend = launch.pick_backend(n)
    devices = [f"cuda:{r}" for r in range(n)] if backend == "nccl" else ["cuda:0"] * n
    res = launch.run(torch_tp_ranks.gpu_row_parallel, n, str(tmp_path), (3,), backend=backend,
                     devices=devices, timeout=600)
    for r in res:
        assert r["single"] == {"w4a8_stacked": 1} and r["tp"] == {"w4a8_stacked": 1}
        assert r["codes_equal"] and r["scales_equal"]
        np.testing.assert_array_equal(r["got"], res[0]["got"])
        np.testing.assert_allclose(r["got"], r["want"], rtol=2e-2,
                                   atol=2e-2 * np.abs(r["want"]).max())


@pytest.mark.parametrize("n", [2, 4])
def test_nccl_graphs_equal_eager(cuda, n, tmp_path):
    """Over NCCL, a card a rank: ``tp_serve_fns``' decode step replays a
    CUDA graph (the first call eager, the second captures) with logits and
    cache bitwise the eager TP step's on every rank, and the TP batcher's
    chunk and decode graphs give the eager TP batcher's ids and shared
    cache, with one capture a chunk-count class and one for the decode."""
    if torch.cuda.device_count() < n:
        pytest.skip(f"the NCCL graph path needs a card a rank: {n} cards")
    res = launch.run(torch_tp_ranks.nccl_graphs, n, str(tmp_path), (1,), backend="nccl",
                     devices=[f"cuda:{r}" for r in range(n)], timeout=600)
    for r in res:
        assert r["decode_steps"] == [(True, 0), (True, 1), (True, 1), (True, 1)]
        assert r["batcher_graph"] is True and r["batcher_eager"] is False
        assert r["ids_equal"] and r["cache_equal"] and r["ids"] == res[0]["ids"]
        assert r["captures"] == (r["captures"][2], 1, r["captures"][2])


def _codes(gen, shape, int4):
    if not int4:
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int16).to(torch.int8)
    return torch.randint(0x11, 0x100, shape, generator=gen, device="cuda",
                         dtype=torch.int16).to(torch.uint8)


# (kind, N weight rows, C): each rank's projections of Llama-3.2-1B at
# n_model 2 and 4 (int4-g128 pair planes), and the n = 2 int8 head block
LOCAL = [("stacked", 3072 // n, E) for n in (2, 4)] + \
    [("stacked", E, E // n) for n in (2, 4)] + [("stacked", E, I // n) for n in (2, 4)] + \
    [("gateup", 2 * I // n, E) for n in (2, 4)] + [("flat", V // 2, E)]


@pytest.mark.parametrize("kind,N,C", LOCAL)
def test_local_shapes_w4a8(cuda, kind, N, C):
    gen = torch.Generator(device="cuda").manual_seed(N + C)
    int4 = kind != "flat"
    wfmt = wm.W_PAIRS if int4 else wm.W_INT8
    G = C // 128
    codes = _codes(gen, (2, N, C // 2 if int4 else C), int4)
    scales = torch.rand((2, N, G), generator=gen, device="cuda") * 1e-2 + 1e-3
    x = torch.randn((32, C), generator=gen, device="cuda").to(torch.bfloat16)
    x_i8, sx = wm.quantize_acts_per_token(x)
    bf = torch.bfloat16
    if kind == "stacked":
        wrapper, got = wm.matmul_stacked, wm.matmul_stacked(x_i8, codes, scales, sx, 1, wfmt, bf)
        want = wm.w4a8_plain(x_i8, codes[1], scales[1], sx, wfmt, bf,
                             splits=wrapper.last_grid[2])
    elif kind == "flat":
        wrapper, got = wm.matmul_flat, wm.matmul_flat(x_i8, codes[0], scales[0], sx, wfmt, bf)
        want = wm.w4a8_plain(x_i8, codes[0], scales[0], sx, wfmt, bf,
                             splits=wrapper.last_grid[2])
    else:
        wrapper = wm.gateup_silu
        got = wm.gateup_silu(x_i8, codes, scales, sx, 1, wfmt, "silu", bf)
        want = wm.gateup_plain(x_i8, codes[1], scales[1], sx, wfmt, "silu", bf,
                               splits=wrapper.last_grid[2])
    if kind == "gateup":
        err = (got.float() - want.float()).abs()
        assert bool((err <= want.float().abs() * 2.0 ** -7 + 1e-6).all())
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("kv", [4, 2])
def test_local_shapes_decode_attention(cuda, kv):
    """B4 with each rank's KV heads (8 / n) at r = 4, D = 64."""
    gen = torch.Generator(device="cuda").manual_seed(kv)
    B, r, D, S, pos = 32, 4, 64, 96, 70
    q = torch.randn((B, kv, r, D), generator=gen, device="cuda")
    i8 = lambda *s: torch.randint(-127, 128, s, generator=gen, device="cuda",
                                  dtype=torch.int16).to(torch.int8)
    bufs = [i8(B, kv, S, D), i8(B, kv, S, D),
            torch.rand((B, kv, S), generator=gen, device="cuda") * 0.02,
            torch.rand((B, kv, S), generator=gen, device="cuda") * 0.02]
    new = [i8(B, kv, D), i8(B, kv, D), torch.rand((B, kv), generator=gen, device="cuda") * 0.02,
           torch.rand((B, kv), generator=gen, device="cuda") * 0.02]
    p = torch.full((B,), pos, dtype=torch.int32, device="cuda")
    ref = [t.clone() for t in bufs]
    got = da.decode_attention_append(q, *new, *bufs, p, scale=D ** -0.5)
    want = da.decode_attention_append_plain(q, *new, *ref, p, scale=D ** -0.5)
    for a, b in zip(bufs, ref):
        assert torch.equal(a, b)
    err = (got - want).abs()
    ulps = 4 * torch.finfo(torch.float32).eps * want.abs() + 1e-7
    assert bool((err <= ulps + float(bufs[3].max())).all())
    assert float((err > ulps).float().mean()) <= 0.01
