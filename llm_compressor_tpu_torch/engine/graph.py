"""CUDA graphs: the port's counterpart of one jitted dispatch.

The JAX package runs a whole decode as one dispatch: ``n`` greedy steps as
one jitted ``lax.scan`` (``engine/generate.py:1027-1086``), the batcher's
decode step as one jitted program (``engine/batching.py:75-80``), ``R``
speculative rounds as one scan (``engine/speculative.py:110-152``). The
port captures the same work in one CUDA graph and replays it.
:func:`run` takes a function ``fn(*inputs)`` over a KV cache and:

* runs the first call for a key on that cache eagerly. It is a real call,
  and it launches every kernel the capture will record, so every kernel
  library is built and loaded (``kernels/_build.py``) and every PyTorch
  library has set itself up before a stream is captured; none of that may
  happen during a capture. A call made once on a cache thus costs what the
  eager loop costs: no capture, no copy of the cache;
* captures the second call on a side stream (``torch.cuda.graph``) and
  replays it; later calls replay. The kernel wrappers bump their launch
  counters at call time, where a capture launches nothing, so the
  capture's counts are taken back and added at each replay instead:
  :func:`~..kernels.launch_counts` counts the launches that ran;
* keeps the graphs on the cache (``KVCache.graphs``), at most
  :data:`MAX_GRAPHS`, least recently used out first, so a graph is freed
  with its cache. Each is keyed by what it bakes in: the caller's key
  (``n``, the configs, the attention mode, ...), the address, shape,
  strides and dtype of every buffer of the cache and of ``reads`` (the
  params, ...), and the inputs' shapes. New params, or buffers swapped
  into the cache, give a new key;
* copies the inputs into the graph's static inputs, replays, and returns
  the outputs as clones (the next replay overwrites the graph's pool).

Nothing falls back: CPU tensors, a failed capture or a failed replay
raise, and after a failed capture every call for its key captures again
(and so raises again) instead of running eagerly.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, NamedTuple, Sequence

import torch

from ..kernels import add_counts, launch_counts

MAX_GRAPHS = 8      # keys kept per cache: graphs, and first calls awaiting their capture


def _fields(obj):
    """A dataclass's constructor fields: ``KVCache.graphs`` is not one."""
    return [f for f in dataclasses.fields(obj) if f.init]


def _leaves(tree):
    """The tensors and other leaves of nested dicts, lists, tuples and
    dataclasses (KVCache, QTensor, ...), in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield k
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in _fields(tree):
            yield from _leaves(getattr(tree, f.name))
    else:
        yield tree


def _signature(tree) -> tuple:
    """What a graph bakes in of ``tree``: each tensor's device, address,
    shape, strides and dtype (a tuple), and every other leaf that hashes
    (never a tuple: :func:`_leaves` opens those)."""
    out = []
    for x in _leaves(tree):
        if isinstance(x, torch.Tensor):
            out.append((x.device, x.data_ptr(), tuple(x.shape), x.stride(), x.dtype))
        else:
            try:
                hash(x)
            except TypeError:
                x = repr(x)
            out.append(x)
    return tuple(out)


def _map(fn, tree):
    """``tree`` with every tensor replaced by ``fn(tensor)``; a cloned
    KVCache starts with no graphs."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(fn, getattr(tree, f.name))
                                            for f in _fields(tree)})
    return tree


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple          # static input tensors, copied into before each replay
    outputs: Any           # the capture's outputs, in the graph's pool
    counts: dict           # launches per replay, by counter


class Graphs:
    """The CUDA graphs of one KV cache (module doc): ``entries`` holds, by
    key, the captured graph, or None after the first (eager) call;
    ``captures`` counts the captures made."""

    def __init__(self):
        self.entries: "OrderedDict[tuple, _Graph | None]" = OrderedDict()
        self.captures = 0


_NEW = object()


def _capture(fn: Callable, inputs: tuple) -> _Graph:
    static = tuple(x.clone() for x in inputs)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    try:
        with torch.cuda.graph(graph):
            outputs = fn(*static)
    finally:
        after = launch_counts()
        counts = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        add_counts({k: -n for k, n in counts.items()})
    return _Graph(graph, static, outputs, counts)


def run(cache, key, fn: Callable, inputs: Sequence[torch.Tensor] = (), reads=None):
    """``fn(*inputs)``, which updates ``cache`` (a KVCache) in place, as one
    CUDA graph kept on the cache: eager at the first call for ``key`` and
    these buffers, captured at the second, replayed after (module doc).
    ``inputs`` are the tensors copied in at each call, ``reads`` what else
    ``fn`` closes over (the params, buffers it updates beside the cache).
    Returns ``fn``'s outputs: clones, where a graph ran."""
    inputs = tuple(inputs)
    baked = _signature((cache, reads))
    devices = {x[0].type for x in baked if isinstance(x, tuple)} | {x.device.type for x in inputs}
    if devices != {"cuda"}:
        raise ValueError("a CUDA graph needs CUDA tensors: on the CPU run the eager loop "
                         "(graph=False)")
    full = (key, baked, tuple((tuple(x.shape), x.dtype, x.device) for x in inputs))
    entries = cache.graphs.entries
    with torch.inference_mode():
        entry = entries.get(full, _NEW)
        if entry is None:           # a failed capture leaves None: the next call raises too
            entry = entries[full] = _capture(fn, inputs)
            cache.graphs.captures += 1
        elif entry is _NEW:
            entries[full] = None
        entries.move_to_end(full)
        while len(entries) > MAX_GRAPHS:
            entries.popitem(last=False)
        if entry is _NEW:           # the first call: eager, and the capture's warm-up
            return fn(*inputs)
        for dst, x in zip(entry.inputs, inputs):
            dst.copy_(x)
        entry.graph.replay()
        add_counts(entry.counts)
        return _map(torch.clone, entry.outputs)
