"""The continuous batcher's two programs as CUDA graphs on the card: the
chunk prefill (one graph a chunk-count class, on the class's static mini
cache) and the decode step, against the eager batcher.

Run on a machine with an H100:
``python -m pytest -m gpu --noconftest tests/test_torch_batching_gpu.py``.
Here, without a card, every test skips (the check runs inside a fixture).
This file imports no JAX: the admission on static per-class caches is held
to the JAX batcher on the CPU by ``tests/test_torch_batching_graph.py``.

Config: 2 layers of W4A8 at hidden 256 (``test_torch_kernels_gpu``'s
serving model: B1, B2 and B3 in a chunk, B4 too in a decode step), an
int8 cache. Tolerances: ids, the shared cache's codes, scales and lengths,
and the launch counts bitwise equal to the eager batcher's.
"""

import numpy as np
import pytest
import torch

from test_torch_kernels_gpu import W4A8_SPEC, _same_cache, _serving_model

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (H100); the CPU runs the batcher eagerly")
    return torch.device("cuda")


def _captures(eng) -> tuple:
    """(the chunk graphs' captures, summed over the classes' caches, the
    decode graph's)."""
    return sum(m.graphs.captures for m in eng._minis.values()), eng.cache.graphs.captures


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunk_graphs_equal_eager(cuda, chunk):
    """Eleven prompts of every chunk-count class (four of class 3 at chunk
    16, more than the three slots), 8 new tokens each, through the graph
    batcher after ``warmup`` and through the eager one: the same ids, the
    same shared cache, the same launches. ``warmup`` captures one chunk
    graph a class and the decode graph; ``run`` captures nothing."""
    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.engine import ContinuousBatcher

    cfg, qcfg, p = _serving_model(W4A8_SPEC)
    rng = np.random.default_rng(chunk)
    lens = (5, 40, 17, 58, 9, 33, 36, 45, 20, 63, 34)
    prompts = [rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32) for t in lens]
    out = []
    for graph in (True, False):
        eng = ContinuousBatcher(p, cfg, batch_slots=3, max_len=64, qcfg=qcfg, quantized_kv=True,
                                prefill_chunk=chunk, graph=graph)
        eng.warmup()
        warm = _captures(eng)
        for t in prompts:
            eng.submit(t, max_new_tokens=8)
        kernels.reset_counts()
        res = eng.run()
        torch.cuda.synchronize()
        out.append((res, eng, warm, kernels.launch_counts()))
    (ga, g, g_warm, g_counts), (ea, e, e_warm, e_counts) = out
    classes = -(-63 // chunk)
    assert g.graph and g.chunk_classes == classes
    assert sorted(g._minis) == list(range(1, classes + 1))
    assert g_warm == _captures(g) == (classes, 1)
    assert e_warm == _captures(e) == (0, 0)
    assert set(ga) == set(ea) == set(range(1, len(lens) + 1))
    assert all(np.array_equal(ga[u], ea[u]) for u in ga)
    assert _same_cache(g.cache, e.cache)
    assert g_counts == e_counts and g_counts["w4a8_flat"] > 0 and g_counts["w4a8_gateup"] > 0


def test_chunk_graph_copies_rows_exactly(cuda):
    """Two prompts of one class admitted back to back, round-robin, on the
    graph batcher: each chunk replays the class's graph on the one static
    cache after the other admission's rows were copied out and this one's
    copied back in; the spliced slots equal the eager batcher's bitwise."""
    from llm_compressor_tpu_torch.engine import ContinuousBatcher

    cfg, qcfg, p = _serving_model(W4A8_SPEC)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32) for t in (45, 47)]
    engines = []
    for graph in (True, False):
        eng = ContinuousBatcher(p, cfg, batch_slots=2, max_len=64, qcfg=qcfg, quantized_kv=True,
                                prefill_chunk=16, graph=graph)
        eng.warmup()
        for t in prompts:
            eng.submit(t, max_new_tokens=1)
        eng._admit()                    # nothing decodes: both prompts, 3 chunks each
        assert not eng.pending and all(r is not None for r in eng.slot_req)
        engines.append(eng)
    g, e = engines
    assert _captures(g) == (g.chunk_classes, 1)
    assert _same_cache(g.cache, e.cache)
    assert [r.generated for r in g.slot_req] == [r.generated for r in e.slot_req]
