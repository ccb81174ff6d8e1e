"""The CUDA-graph helper's CPU side (``engine/graph.py``): asking for a graph
on CPU tensors raises instead of running the eager loop, a graph's key
changes with every buffer it bakes in, and each cache keeps its own graphs.
The graphs themselves run on the card (``tests/test_torch_kernels_gpu.py``)."""

import numpy as np
import pytest
import torch

from llm_compressor_tpu_torch import kernels
from llm_compressor_tpu_torch.engine import ContinuousBatcher, decode_greedy_steps, init_cache
from llm_compressor_tpu_torch.engine import decode_step
from llm_compressor_tpu_torch.engine import graph as tgraph
from llm_compressor_tpu_torch.engine.speculative import speculative_rounds
from llm_compressor_tpu_torch.models import init_params, tiny_config
from torch_port_util import one_torch_thread  # noqa: F401


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
