"""The port's tracer (``utils/trace.py``) on the CPU: spans record nothing
while tracing is off; inside ``recording()`` and under ``torch.profiler``
they record their nesting per thread on the profiler's clock;
``last()`` holds the latest profiled stretch; the engine's decode call
makes its spans. The graph's spans run on the card
(``tests/test_torch_graph.py``)."""

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from llm_compressor_tpu_torch.engine import decode_greedy_steps, init_cache
from llm_compressor_tpu_torch.models import init_params, tiny_config
from llm_compressor_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _end_stretch():
    """A span made with the profiler off: the profiled stretch ends."""
    with trace.span("unprofiled"):
        pass


def test_off_records_nothing():
    """Outside a recording and a profiler a span yields None, keeps no
    record and leaves the latest profiled stretch as it was."""
    with _cpu_profile():
        with trace.span("kept"):
            pass
    kept = trace.last()
    with trace.span("off") as s:
        with trace.span("off.inner") as inner:
            pass
    assert s is None and inner is None
    assert trace.last() == kept and [x.name for x in kept] == ["kept"]
    assert trace._STATE.stack() == [] and trace._STATE.recordings == []


def test_nesting_parents_and_call_ids():
    """Parents follow the nesting of the thread's open spans; each
    recording holds only the spans made while it is open."""
    with trace.span("before"):
        pass
    with trace.recording() as outer_rec:
        with trace.span("call") as call:
            with trace.span("child") as child:
                with trace.recording() as inner_rec:
                    with trace.span("grandchild") as grand:
                        assert grand.end_ns is None
            with trace.span("sibling") as sib:
                pass
        with trace.span("next") as nxt:
            pass
    with trace.span("after") as after:
        pass
    assert after is None
    assert [s.name for s in outer_rec] == ["call", "child", "grandchild", "sibling", "next"]
    assert [s.name for s in inner_rec] == ["grandchild"]
    assert call.parent is None and nxt.parent is None
    assert (child.parent, grand.parent, sib.parent) == (call.id, child.id, call.id)
    assert len({s.id for s in outer_rec}) == 5
    for s in outer_rec:
        assert s.end_ns is not None and s.duration_ns >= 0
    assert call.start_ns <= child.start_ns <= grand.start_ns <= grand.end_ns <= child.end_ns
    assert child.end_ns <= sib.start_ns <= sib.end_ns <= call.end_ns <= nxt.start_ns


def test_threads_have_their_own_stacks():
    """A span made on another thread while this one has a span open has no
    parent: each thread nests its own spans."""
    got = {}

    def work():
        with trace.span("worker") as s:
            got["span"] = s

    with trace.recording() as rec:
        with trace.span("main") as main:
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    w = got["span"]
    assert w.parent is None and main.parent is None and w.id != main.id
    assert {s.name for s in rec} == {"main", "worker"}


def test_span_closes_when_its_body_raises():
    with trace.recording() as rec:
        with pytest.raises(ValueError):
            with trace.span("fails"):
                raise ValueError("boom")
        with trace.span("then") as then:
            pass
    assert rec[0].end_ns is not None and then.parent is None
    assert trace._STATE.stack() == []


def test_profiled_stretches():
    """Under the profiler spans record themselves; ``last()`` holds only the
    latest stretch: spans made with the profiler off end a stretch, and
    the next profiled span starts a new one."""
    _end_stretch()
    with _cpu_profile():
        with trace.span("first.a"):
            with trace.span("first.b"):
                pass
    assert [s.name for s in trace.last()] == ["first.a", "first.b"]
    for _ in range(3):
        _end_stretch()
    assert [s.name for s in trace.last()] == ["first.a", "first.b"]
    with _cpu_profile():
        with trace.span("second") as second:
            pass
        assert second is not None
    got = trace.last()
    assert [s.name for s in got] == ["second"] and got[0] is second


def test_span_on_the_profilers_clock():
    """A span inside a ``record_function`` range lies within it on the
    trace's clock (``trace_start_ns`` + ``time_range``), and enters the
    trace as a host op of its own name at its place."""
    with _cpu_profile() as prof:
        with record_function("outer"):
            torch.ones(64).sum()
            with trace.span("engine.inner") as s:
                torch.ones(64).sum()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events()}
    tol = 50_000
    for name in ("outer", "engine.inner"):
        assert events[name].device_type == torch.autograd.DeviceType.CPU
    outer = events["outer"].time_range
    assert t0 + outer.start * 1e3 - tol <= s.start_ns <= s.end_ns <= t0 + outer.end * 1e3 + tol
    op = events["engine.inner"].time_range
    assert abs(t0 + op.start * 1e3 - s.start_ns) <= tol
    assert abs(t0 + op.end * 1e3 - s.end_ns) <= tol


def test_decode_call_spans_on_the_eager_loop():
    """``decode_greedy_steps`` on the CPU under the profiler: one
    ``engine.decode`` span, ``engine.check`` inside it, and no ``graph.*``
    span (the eager loop)."""
    cfg = tiny_config("llama")
    p = init_params(cfg, device="cpu")
    cache = init_cache(cfg.num_layers, 2, 16, cfg.num_kv_heads, cfg.head_dim, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    _end_stretch()
    with _cpu_profile():
        toks, cache = decode_greedy_steps(p, tok, cache, n=3, cfg=cfg)
    assert toks.shape == (2, 3)
    spans = trace.last()
    assert [s.name for s in spans] == ["engine.decode", "engine.check"]
    call, check = spans
    assert call.parent is None and check.parent == call.id
    assert call.start_ns <= check.start_ns <= check.end_ns <= call.end_ns
    with trace.recording() as rec:                  # an operator's recording, no profiler
        with pytest.raises(ValueError, match="overrun"):
            decode_greedy_steps(p, tok, cache, n=14, cfg=cfg)
    assert [s.name for s in rec] == ["engine.decode", "engine.check"]
    assert all(s.end_ns is not None for s in rec)


def test_kept_spans_are_bounded():
    """A recording and the profiled stretch keep the newest MAX_SPANS."""
    extra = 5
    with trace.recording() as rec:
        for i in range(trace.MAX_SPANS + extra):
            with trace.span(f"s{i}"):
                pass
    assert len(rec) == trace.MAX_SPANS and rec[0].name == f"s{extra}"
    _end_stretch()
    with _cpu_profile():
        for i in range(trace.MAX_SPANS + extra):
            with trace.span(f"s{i}"):
                pass
    got = trace.last()
    assert len(got) == trace.MAX_SPANS
    assert [s.name for s in got] == [f"s{i}" for i in range(extra, trace.MAX_SPANS + extra)]
