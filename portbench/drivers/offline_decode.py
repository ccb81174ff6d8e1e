"""Offline batch generation: ``batch`` prompts of ``prompt_len`` tokens
prefilled once into an int8 cache, then jobs back to back, each
``calls_per_job`` calls of ``decode_greedy_steps(n=steps_per_call)``
(CUDA graph replays) from the prompt's end.

Set-up: the prompts from the seed, prefilled by ``engine.prefill`` in
groups of ``prefill_group`` slots (each group on a cache of its own,
spliced into the shared cache slot by slot), then two calls
that build the graph (the eager first call, the capture). A job sets the
cache's lengths back to the prompt's end in place and feeds new first
tokens drawn from the seed; the rows past the prompt are written again.

Window: jobs until ``seconds`` have passed, ending at a job's end;
``decode_tok_s`` is every token generated in it over its seconds. Traced:
the first call of the second job (the next call where the trace misses
launches the counters saw) under the profiler.

Every cache is made by the family's ``init_cache`` and filled by its
``splice`` (``portbench/family.py``), so a family with state beside the
KV cache runs through this driver as it is.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import traceutil
from portbench.harness import Outcome
from portbench.reference.model import Sample

TRACE_ATTEMPTS = 2


def _prefill(ctx, prompts, cache):
    from llm_compressor_tpu_torch import engine

    t = ctx.traffic
    B, P = prompts.shape
    G = t["prefill_group"]
    for g0 in range(0, B, G):
        group = ctx.family.init_cache(ctx, G, P)
        engine.prefill(ctx.params, prompts[g0:g0 + G], group, cfg=ctx.cfg, qcfg=ctx.qcfg)
        for j in range(G):
            ctx.family.splice(cache, group, j, g0 + j)
        del group
    cache.lengths.fill_(P)


def _rows(P: int, c: int, n: int, B: int) -> int:
    """Cache rows the n steps of call c attend, summed over slots (per
    layer): step t of the call sits at position P + c n + t and covers
    rows 0..position."""
    first = P + c * n + 1
    return B * (n * first + n * (n - 1) // 2)


def run(ctx):
    from llm_compressor_tpu_torch import engine, kernels

    t = ctx.traffic
    B, P, n, calls = t["batch"], t["prompt_len"], t["steps_per_call"], t["calls_per_job"]
    spec = ctx.spec
    tok_gen = ctx.generator(1)
    prompts = torch.randint(0, spec.vocab, (B, P), generator=ctx.generator(0),
                            device=ctx.device, dtype=torch.int32)
    cache = ctx.family.init_cache(ctx, B, P + n * calls)
    _prefill(ctx, prompts, cache)

    def call(tok):
        toks, _ = engine.decode_greedy_steps(ctx.params, tok, cache, n=n, cfg=ctx.cfg,
                                             qcfg=ctx.qcfg)
        return toks

    warm = torch.zeros((B, 1), dtype=torch.int32, device=ctx.device)
    for _ in range(2):           # the eager first call, then the capture
        call(warm)
    captures = cache.graphs.captures
    ctx.setup_done()

    record, traced = None, 0
    jobs = 0
    last = None
    ctx.window_start()
    t0 = time.perf_counter()
    while True:
        with ctx.span("job"):
            cache.lengths.fill_(P)
            first = torch.randint(0, spec.vocab, (B, 1), generator=tok_gen, device=ctx.device,
                                  dtype=torch.int32)
            tok, outs = first, []
            for c in range(calls):
                if ctx.trace and jobs == 1 and record is None and traced < TRACE_ATTEMPTS:
                    traced += 1
                    before = kernels.launch_counts()
                    with ctx.profiled() as box:
                        with ctx.span("call"):
                            toks = call(tok)
                    after = kernels.launch_counts()
                    counted = sum(after[k] - before[k] for k in after)
                    traceutil.finish(box)
                    hand = traceutil.launches(box["events"])
                    if hand == counted or traced == TRACE_ATTEMPTS:
                        record = dict(box, kind="decode", steps=n, batch=B,
                                      rows=_rows(P, c, n, B), launches=counted,
                                      launches_traced=hand)
                else:
                    with ctx.span("call"):
                        toks = call(tok)
                outs.append(toks)
                tok = toks[:, -1:]
            ctx.sync()
        jobs += 1
        last = (first, outs)
        if time.perf_counter() - t0 >= ctx.seconds and (jobs >= 2 or not ctx.trace):
            break
    elapsed = time.perf_counter() - t0
    ctx.window_end()
    in_window = cache.graphs.captures - captures

    first, outs = last
    served = torch.cat(outs, dim=1).cpu()                     # (B, n * calls)
    pick = np.random.default_rng(ctx.seed).choice(B, size=min(t["check_slots"], B), replace=False)
    host_prompts, first = prompts.cpu(), first.cpu()
    samples = []
    for b in sorted(pick.tolist()):
        fed = torch.cat([host_prompts[b], first[b], served[b, :-1]])
        samples.append(Sample(tokens=fed, n_prefill=P, chunk=None, check_from=P,
                              targets=served[b]))
    tokens = jobs * calls * n * B
    info = {"jobs": jobs, "window_s": elapsed, "tokens": tokens,
            "captures_in_window": in_window, "slots_checked": sorted(pick.tolist())}
    if record is not None:
        info["launches"] = [record["launches_traced"], record["launches"]]
    return Outcome(e2e={"decode_tok_s": tokens / elapsed}, attempted=jobs * B, failed=0,
                   samples=samples, record=record, info=info)
