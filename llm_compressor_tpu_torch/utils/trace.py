"""Spans of the serving engine's host work, on the profiler's clock.

``span(name)`` marks a stretch of host work. The engine makes these
(``engine/generate.py``, ``engine/graph.py``):

* ``engine.decode``: a whole ``decode_greedy_steps`` call;
* ``engine.check``: the host read of the cache's lengths before a decode
  call's steps (``decode_greedy_steps``, ``decode_step``, tensor-parallel
  decode), which waits for the device's work on the cache;
* ``graph.key`` (the graph's key over every buffer it bakes in, the
  lookup, the eviction), ``graph.inputs`` (the copy into the static
  inputs) and ``graph.replay`` (the host time of the launch), made by
  every caller of ``graph.run``.

A span records its name, its id, its parent span (the innermost span open
on its thread) and its start and end. It is recorded only while tracing is
on:

* inside :func:`recording`, which yields the spans made while it is open;
* while a ``torch.profiler`` session records. :func:`last` returns the
  spans of the latest uninterrupted stretch made so: a span made with the
  profiler off ends a stretch, and the next profiled span starts a new one
  (two sessions with no span made between them are one stretch).

Off, a span allocates no record, touches no device and makes no sync: it
costs a flag check and one check of the profiler. Spans never go inside
a function that a CUDA graph captures: there they would time the capture,
not the replay.

Times are ``time.time_ns()``, the unix clock in ns on which the profiler
(Kineto) stamps host ops and device activity: a span's ``start_ns`` minus
the trace's ``trace_start_ns()`` (``prof.profiler.kineto_results``) is
its place among the trace's kernels, in ns (a trace's ``time_range`` is
in us). Under a profiler a span also enters the trace as a host op of
its name, so that an exported Chrome trace shows it beside the kernels;
it adds no device event. Spans are kept in memory only, the newest
:data:`MAX_SPANS` of each recording and of the profiled stretch.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Iterator, List, Optional

import torch

MAX_SPANS = 4096

_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclass(slots=True)
class Span:
    """One span; ``end_ns`` is None while it is open."""
    name: str
    id: int
    parent: Optional[int]
    start_ns: int = 0
    end_ns: Optional[int] = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _State:
    """The process's tracer: the open recordings, the profiled stretch and
    whether it takes more spans; each thread's stack of open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.recordings: List[deque] = []
        self.stretch: deque = deque(maxlen=MAX_SPANS)
        self.open = False

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack


_STATE = _State()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "profiled", "span", "op")

    def __init__(self, name: str, profiled: bool):
        self.name, self.profiled = name, profiled

    def __enter__(self) -> Span:
        st = _STATE
        stack = st.stack()
        self.span = s = Span(self.name, next(st.ids), stack[-1].id if stack else None)
        with st.lock:
            sinks = list(st.recordings)
            if self.profiled:
                if not st.open:
                    st.stretch, st.open = deque(maxlen=MAX_SPANS), True
                sinks.append(st.stretch)
        for sink in sinks:
            sink.append(s)
        stack.append(s)
        self.op = None
        if self.profiled:
            self.op = torch._C._profiler._RecordFunctionFast(self.name)
            self.op.__enter__()
        s.start_ns = time.time_ns()
        return s

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        if self.op is not None:
            self.op.__exit__(None, None, None)
        _STATE.stack().pop()
        return False


def span(name: str):
    """A context manager that records the span ``name`` while tracing is on
    (module doc) and yields it, and yields None while it is off."""
    profiled = _profiler_enabled()
    if not profiled:
        _STATE.open = False
        if not _STATE.recordings:
            return _OFF
    return _On(name, profiled)


@contextlib.contextmanager
def recording() -> Iterator[deque]:
    """Trace the block: yields the spans made while it is open, from every
    thread, oldest first (the newest :data:`MAX_SPANS`)."""
    rec: deque = deque(maxlen=MAX_SPANS)
    with _STATE.lock:
        _STATE.recordings.append(rec)
    try:
        yield rec
    finally:
        with _STATE.lock:      # by identity: two recordings may hold equal spans
            _STATE.recordings = [r for r in _STATE.recordings if r is not rec]


def last() -> List[Span]:
    """The spans of the latest uninterrupted stretch made while a
    ``torch.profiler`` session recorded, oldest first (module doc)."""
    with _STATE.lock:
        return list(_STATE.stretch)
