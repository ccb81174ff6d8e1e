"""The CUDA-graph helper's CPU side (``engine/graph.py``): asking for a graph
on CPU tensors raises instead of running the eager loop, a graph's key
changes with every buffer it bakes in, and each cache keeps its own graphs.
The graphs themselves run on the card (``tests/test_torch_kernels_gpu.py``);
so do the tests of their spans (``utils/trace.py``) at the end of this file,
marked ``gpu``: ``python -m pytest -m gpu tests/test_torch_graph.py``."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from llm_compressor_tpu_torch import kernels
from llm_compressor_tpu_torch.engine import ContinuousBatcher, decode_greedy_steps, init_cache
from llm_compressor_tpu_torch.engine import decode_step
from llm_compressor_tpu_torch.engine import graph as tgraph
from llm_compressor_tpu_torch.engine.speculative import speculative_rounds
from llm_compressor_tpu_torch.models import init_params, tiny_config
from llm_compressor_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config("llama")
    return cfg, init_params(cfg, device="cpu")


def _cache(cfg, quantized=False):
    return init_cache(cfg.num_layers, 2, 32, cfg.num_kv_heads, cfg.head_dim,
                      quantized=quantized, device="cpu")


def test_graph_true_on_cpu_raises(tiny):
    """``graph=True`` on CPU tensors raises, and leaves the cache as it was;
    the default runs the eager loop there."""
    cfg, p = tiny
    cache = _cache(cfg)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    before = [t.clone() for t in (cache.k, cache.v, cache.lengths)]
    with pytest.raises(ValueError, match="graph=True needs CUDA tensors"):
        decode_greedy_steps(p, tok, cache, n=2, cfg=cfg, graph=True)
    with pytest.raises(ValueError, match="graph=True needs CUDA tensors"):
        decode_step(p, tok, cache, cfg=cfg, graph=True)
    hist, hlen = torch.zeros((2, 16), dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="graph=True needs CUDA tensors"):
        speculative_rounds(p, hist, hlen, cache, torch.ones(2, dtype=torch.bool), rounds=1, k=2,
                           ngram=2, cfg=cfg, graph=True)
    with pytest.raises(ValueError, match="graph=True needs CUDA tensors"):
        ContinuousBatcher(p, cfg, batch_slots=2, max_len=32, graph=True)
    assert all(torch.equal(a, b) for a, b in zip((cache.k, cache.v, cache.lengths), before))
    toks, cache = decode_greedy_steps(p, tok, cache, n=2, cfg=cfg)
    assert toks.shape == (2, 2) and cache.lengths.tolist() == [2, 2]


def test_graph_run_refuses_cpu_tensors(tiny):
    cfg, p = tiny
    cache = _cache(cfg)
    with pytest.raises(ValueError, match="CUDA graph needs CUDA tensors"):
        tgraph.run(cache, "key", lambda t: t, (torch.zeros(2),), reads=p)
    assert not cache.graphs.entries and cache.graphs.captures == 0


def test_signature_follows_the_buffers(tiny):
    """The key of a graph: the same buffers give the same signature; a new
    cache of the same shapes, a view at another offset, another dtype or a
    changed leaf give another one."""
    cfg, p = tiny
    a, b = _cache(cfg), _cache(cfg)
    sig = tgraph._signature
    assert sig(a) == sig(a) and sig(p) == sig(p)
    assert sig(a) != sig(b)
    before = sig(a)
    a.graphs.entries["key"] = None                      # the graphs are not baked in
    a.graphs.captures += 1
    assert sig(a) == before
    assert sig(a.k) != sig(a.k[1:]) and sig(a.k) != sig(a.k.view(torch.uint8))
    assert sig(_cache(cfg, quantized=True)) != sig(a)
    assert sig({"x": 1, "t": a.k}) != sig({"x": 2, "t": a.k})


def test_map_clones_dataclasses(tiny):
    """A clone of a cache: every tensor cloned, the KVCache kept, and a
    store of graphs of its own, empty."""
    cfg, _ = tiny
    a = _cache(cfg, quantized=True)
    a.graphs.entries["key"] = None
    c = tgraph._map(torch.clone, (a, [a.lengths]))
    assert type(c[0]) is type(a) and c[0].quantized
    assert c[0].graphs is not a.graphs and not c[0].graphs.entries
    for n in ("k", "v", "k_scale", "v_scale", "lengths"):
        assert torch.equal(getattr(c[0], n), getattr(a, n))
        assert getattr(c[0], n).data_ptr() != getattr(a, n).data_ptr()
    assert c[1][0].data_ptr() != a.lengths.data_ptr()


def test_add_counts():
    kernels.reset_counts()
    kernels.add_counts({"w4a8_stacked": 3, "fresh_write": 2})
    kernels.add_counts({"w4a8_stacked": -1})
    counts = kernels.launch_counts()
    assert counts["w4a8_stacked"] == 2 and counts["fresh_write"] == 2
    assert sum(counts.values()) == 4
    kernels.reset_counts()
    assert not any(kernels.launch_counts().values())
    with pytest.raises(KeyError):
        kernels.add_counts({"no_such_kernel": 1})
    assert np.all(np.asarray(list(kernels.launch_counts().values())) == 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda")


def _on_card(cuda):
    cfg = tiny_config("llama")
    p = init_params(cfg, device=cuda)
    cache = init_cache(cfg.num_layers, 2, 64, cfg.num_kv_heads, cfg.head_dim, device=cuda)
    return cfg, p, cache, torch.zeros((2, 1), dtype=torch.int32, device=cuda)


PROGRAM_SPANS = ("engine.decode", "engine.check", "graph.key", "graph.inputs", "graph.replay")
CUDA = torch.autograd.DeviceType.CUDA


@pytest.mark.gpu
def test_graph_spans_of_each_call(cuda):
    """Every call for a key records ``graph.key``; the first (eager) no
    more, and each from the second on (the capture, then replays)
    ``graph.inputs`` and ``graph.replay``, all inside ``engine.decode``;
    ``decode_step`` makes the same spans without ``engine.decode``."""
    cfg, p, cache, tok = _on_card(cuda)
    graph_steps = [[], ["graph.inputs", "graph.replay"], ["graph.inputs", "graph.replay"]]
    for steps in graph_steps:
        with trace.recording() as rec:
            decode_greedy_steps(p, tok, cache, n=2, cfg=cfg)
        rec = list(rec)
        assert [s.name for s in rec] == ["engine.decode", "engine.check", "graph.key"] + steps
        call = rec[0]
        assert call.parent is None
        assert all(s.parent == call.id and s.end_ns is not None for s in rec[1:])
    for steps in graph_steps:
        with trace.recording() as rec:
            decode_step(p, tok, cache, cfg=cfg)
        assert [s.name for s in rec] == ["engine.check", "graph.key"] + steps


def _profiled_call(cfg, p, cache, tok):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode_greedy_steps(p, tok, cache, n=2, cfg=cfg)
        torch.cuda.synchronize()
    return prof.events()


@pytest.mark.gpu
def test_spans_add_no_device_event(cuda):
    """Under a profile with CUDA activity the spans of a replayed call
    enter the trace as host ops, and no CUDA-type event bears a span's
    name (the device's busy time and kernel classes stay the kernels')."""
    cfg, p, cache, tok = _on_card(cuda)
    for _ in range(2):                              # the eager call, the capture
        decode_greedy_steps(p, tok, cache, n=2, cfg=cfg)
    events = _profiled_call(cfg, p, cache, tok)
    device = [e.name for e in events if e.device_type == CUDA]
    host = {e.name for e in events if e.device_type != CUDA}
    assert device and set(PROGRAM_SPANS) <= host
    assert not [n for n in device if n.startswith(("engine.", "graph."))]


@pytest.mark.gpu
def test_replay_kernels_unchanged_by_the_tracer(cuda, monkeypatch):
    """A replay's kernel events have the same names and count with the
    tracer recording as with it off. (The profiler drops a record now and
    then: a pair that differs is taken again once.)"""
    cfg, p, cache, tok = _on_card(cuda)
    for _ in range(2):
        decode_greedy_steps(p, tok, cache, n=2, cfg=cfg)

    def kernels_of(tracing):
        with monkeypatch.context() as m:
            if not tracing:
                m.setattr(trace, "_profiler_enabled", lambda: False)
            events = _profiled_call(cfg, p, cache, tok)
        return Counter(e.name for e in events if e.device_type == CUDA)

    for _ in range(2):
        on, off = kernels_of(True), kernels_of(False)
        if on == off:
            break
    assert on == off and sum(on.values()) > 0
