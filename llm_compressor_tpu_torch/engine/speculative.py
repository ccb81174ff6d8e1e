"""Speculative decoding: prompt-lookup (n-gram) drafts and a batched
verify (port of ``engine/speculative.py``).

Candidate continuations come from the sequence itself: the most recent
earlier occurrence of its trailing n-gram proposes the tokens that
followed it (prompt lookup decoding). One verify step scores ``k + 1``
positions in one forward against the KV cache (a T = k + 1 decode at
per-slot offsets):

    draft   d_1..d_k        (n-gram lookup over the slot's history)
    forward [t, d_1..d_k] -> greedy g_0..g_k
    accept the longest prefix with d_{i+1} == g_i; emit g_0..g_a (a + 1
    tokens); the cache lengths advance by a + 1. K/V written for rejected
    positions sit past ``lengths``, where the causal mask hides them until
    they are overwritten.

Each emitted token is the verify forward's argmax; acceptance decides
only how many commit per round. Over a bf16 cache that forward runs the
float attention a decode step runs, so the tokens are greedy decoding's,
up to near-ties that a (k+1)-row forward rounds otherwise than a one-row
one. Over an int8 cache the verify forward's attention is the float path
over the dequantized cache, which fake-quantizes K and V per channel over
the whole window, where the T = 1 kernel B4 quantizes per token (as in the
JAX package): its logits differ by design, and its tokens can differ from
B4's greedy decode wherever the top-2 gap is small.

:func:`speculative_rounds` runs ``R`` draft + verify + accept + append
rounds, with the history on the device: on the card one CUDA graph
(``engine/graph.py``), as the JAX package runs them in one jitted scan.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import head
from ..qformats import QuantConfig
from .generate import _forward_cached, decode_greedy_steps, prefill, use_graph
from . import graph as graphs
from .kvcache import KVCache, init_cache


def _verify(params, tokens, cache: KVCache, active, cfg: ModelConfig, qcfg):
    """The verify forward and its accept: greedy (B, k+1) int32, accepted
    (B,) int32; lengths advance by accepted + 1 on active slots."""
    h = _forward_cached(params, cfg, tokens, cache, qcfg, start=None)
    greedy = torch.argmax(head(params, cfg, h, qcfg), dim=-1).to(torch.int32)
    match = (tokens[:, 1:] == greedy[:, :-1]).to(torch.int32)
    accepted = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    cache.lengths += torch.where(active, accepted + 1, 0).to(torch.int32)
    return greedy, accepted


@torch.inference_mode()
def decode_verify_step(params, tokens: torch.Tensor, cache: KVCache, active: torch.Tensor, *,
                       cfg: ModelConfig, qcfg: Optional[QuantConfig] = None):
    """Score ``tokens`` (B, k+1) = [committed last token | k drafts] in one
    forward at per-slot offsets and accept on the device: the longest draft
    prefix that matches the greedy outputs; ``lengths`` advance by
    accepted + 1 on ``active`` (B,) bool slots, by 0 on the others (their
    verify writes land past ``lengths``). The cache is updated in place.

    Returns (greedy (B, k+1) int32, accepted (B,) int32 in [0, k], cache)."""
    greedy, accepted = _verify(params, tokens, cache, active, cfg, qcfg)
    return greedy, accepted, cache


def draft_ngram_device(hist: torch.Tensor, hlen: torch.Tensor, k: int, ngram: int = 2,
                       min_hist: int = 4) -> torch.Tensor:
    """Prompt-lookup drafts on the device, the twin of :func:`propose_ngram`:
    for the longest gram size g <= ``ngram``, the most recent earlier
    occurrence of the trailing g-gram in ``hist[:hlen]`` proposes the ``k``
    tokens that followed it (padded with the last token past the history's
    end); shorter grams next, then the last token repeated.

    hist (B, Hmax) int32, hlen (B,) int32 -> (B, k) int32."""
    B, Hmax = hist.shape
    dev = hist.device
    pos = torch.arange(Hmax, device=dev)[None, :]
    hl = hlen.long()[:, None]
    last = torch.gather(hist, 1, (hl - 1).clamp_min(0))                  # (B, 1)
    drafts = last.expand(B, k)
    for g in range(1, ngram + 1):                                        # longest g wins
        # the trailing g-gram, right-aligned: tail[:, j] = hist[hlen - g + j]
        tidx = (hl - g + torch.arange(g, device=dev)[None, :]).clamp(0, Hmax - 1)
        tail = torch.gather(hist, 1, tidx)                               # (B, g)
        S = Hmax - g
        m = torch.ones((B, S), dtype=torch.bool, device=dev)
        for j in range(g):                                               # hist[s:s+g] == tail
            m &= hist[:, j:S + j] == tail[:, j:j + 1]
        m &= (pos[:, :S] + g) < hl                                       # s + g < hlen
        m &= hl >= max(min_hist, g + 1)
        found = m.any(dim=1, keepdim=True)
        best = torch.argmax(torch.where(m, pos[:, :S], -1), dim=1, keepdim=True)  # most recent
        cidx = best + g + torch.arange(k, device=dev)[None, :]
        cont = torch.gather(hist, 1, cidx.clamp(0, Hmax - 1))
        cont = torch.where(cidx < hl, cont, last)                        # pad with the last
        drafts = torch.where(found, cont, drafts)
    return drafts.to(torch.int32)


def _round(params, hist, hlen, cache: KVCache, active, k: int, ngram: int,
           cfg: ModelConfig, qcfg):
    """One draft + verify + accept + append round, in place on ``hist``,
    ``hlen`` and the cache -> accepted (B,) int32. A slot appends
    greedy[0..accepted] at ``hlen``; an inactive one appends nothing.
    Appends past the buffer are dropped: they land on its last column
    with the value that column gets anyway."""
    B, Hmax = hist.shape
    dev = hist.device
    drafts = draft_ngram_device(hist, hlen, k, ngram)
    last = torch.gather(hist, 1, (hlen.long() - 1).clamp_min(0)[:, None])
    toks = torch.cat([last, drafts], dim=1)                              # (B, k+1)
    greedy, accepted = _verify(params, toks, cache, active, cfg, qcfg)
    lane = torch.arange(k + 1, device=dev)[None, :]
    idx = hlen.long()[:, None] + lane
    keep = (lane <= accepted[:, None]) & active[:, None] & (idx < Hmax)
    at = idx.clamp(max=Hmax - 1)
    val = torch.where(keep, greedy, torch.gather(hist, 1, at))
    to_last = keep & (idx == Hmax - 1)
    last_val = torch.where(to_last.any(1), greedy[torch.arange(B, device=dev),
                                                  to_last.int().argmax(1)], hist[:, -1])
    hist.scatter_(1, at, torch.where(idx >= Hmax, last_val[:, None], val))
    hlen += torch.where(active, accepted + 1, 0).to(torch.int32)
    return accepted


def _rounds(params, hist, hlen, cache: KVCache, active, rounds: int, k: int, ngram: int,
            cfg: ModelConfig, qcfg):
    return torch.stack([_round(params, hist, hlen, cache, active, k, ngram, cfg, qcfg)
                        for _ in range(rounds)])


@torch.inference_mode()
def speculative_rounds(params, hist: torch.Tensor, hlen: torch.Tensor, cache: KVCache,
                       active: torch.Tensor, *, rounds: int, k: int, ngram: int,
                       cfg: ModelConfig, qcfg: Optional[QuantConfig] = None,
                       graph: Optional[bool] = None):
    """``rounds`` draft + verify rounds: each drafts ``k``
    tokens from the slot's own history on the device
    (:func:`draft_ngram_device`), verifies [last | drafts] in one T = k+1
    forward, accepts the longest matching prefix, appends the accepted + 1
    greedy tokens to ``hist`` and advances ``hlen`` and the cache lengths
    (inactive slots stay frozen). ``hist``, ``hlen`` and the cache are
    updated in place; the host truncates at EOS or max_new after, so the
    buffers need rounds * (k+1) of headroom. On the card the rounds are one
    CUDA graph kept on the cache, from the second call on it (``graph`` as
    ``generate.use_graph`` says).

    Returns (hist, hlen, cache, accepted (rounds, B) int32)."""
    if not use_graph(graph, hist):
        acc = _rounds(params, hist, hlen, cache, active, rounds, k, ngram, cfg, qcfg)
        return hist, hlen, cache, acc
    acc = graphs.run(cache, ("speculative_rounds", rounds, k, ngram, cfg, qcfg),
                     lambda a: _rounds(params, hist, hlen, cache, a, rounds, k, ngram, cfg,
                                       qcfg),
                     (active,), reads=(params, hist, hlen))
    return hist, hlen, cache, acc


def propose_ngram(history: List[int], k: int, ngram: int = 2, min_hist: int = 4) -> List[int]:
    """Prompt-lookup draft on the host: the most recent earlier occurrence
    of the trailing ``ngram`` proposes the ``k`` tokens that followed it;
    shorter grams next, then the last token repeated."""
    h = history
    n = len(h)
    if n >= min_hist:
        for g in range(min(ngram, n - 1), 0, -1):
            tail = h[n - g:]
            for s in range(n - g - 1, -1, -1):          # right to left
                if h[s:s + g] == tail and s + g < n:
                    cont = h[s + g:s + g + k]
                    if cont:
                        return (cont + [h[-1]] * (k - len(cont)))[:k]
    return [h[-1]] * k


def generate_speculative(params, cfg: ModelConfig, prompt_tokens: np.ndarray,
                         max_new_tokens: int = 100, k_draft: int = 4,
                         eos_id: Optional[int] = None, qcfg: Optional[QuantConfig] = None,
                         quantized_kv: bool = False, max_len: Optional[int] = None,
                         ngram: int = 2, rounds_per_dispatch: int = 8,
                         accept_floor: Optional[float] = None, floor_window: int = 32,
                         graph: Optional[bool] = None):
    """Greedy generation with prompt-lookup speculative decoding, on the
    params' device.

    The draft -> verify -> accept -> history loop runs on the device,
    ``rounds_per_dispatch`` rounds per :func:`speculative_rounds` call, and
    the host reads the history once per call; ``graph`` as
    :func:`speculative_rounds` and ``decode_greedy_steps`` take it.

    Once ``floor_window`` live rounds have run, if the mean accepted drafts
    per live round is below ``accept_floor`` (default 0.3 * k_draft, where
    the T = k+1 verify forwards stop paying for themselves), the rest is
    decoded by ``decode_greedy_steps``; ``accept_floor=0`` keeps
    speculating. Only live rounds count: ``active`` is frozen per call, so
    a slot that reaches EOS or max_new mid-call verifies on until the
    host reads the history; its rounds after that point are found from the
    commit watermark and the per-round advances and not counted.

    Returns (per-slot token lists including the prompt, stats with
    ``mean_accepted`` in [0, k_draft], ``live_rounds``, ``rounds`` and
    ``fell_back``)."""
    dev = params["embed"]["weight"].device
    prompt_tokens = np.asarray(prompt_tokens, np.int32)
    B, T = prompt_tokens.shape
    R = rounds_per_dispatch
    if accept_floor is None:
        accept_floor = 0.3 * k_draft
    # a call may overshoot max_new by R * (k + 1) before the host truncates,
    # and every verify round writes k + 1 cache positions
    slack = R * (k_draft + 1)
    Hmax = T + max_new_tokens + slack + 1
    max_len = max(max_len or 0, Hmax + k_draft + 1)
    cache = init_cache(cfg.num_layers, B, max_len, cfg.num_kv_heads, cfg.head_dim,
                       quantized=quantized_kv, device=dev)
    prompt = torch.from_numpy(prompt_tokens).to(dev)
    logits, cache = prefill(params, prompt, cache, cfg=cfg, qcfg=qcfg)
    first = torch.argmax(logits, dim=-1).to(torch.int32)

    hist_dev = torch.zeros((B, Hmax), dtype=torch.int32, device=dev)
    hist_dev[:, :T] = prompt
    hist_dev[:, T] = first
    hlen = torch.full((B,), T + 1, dtype=torch.int32, device=dev)

    committed = [T + 1] * B        # the host's commit watermark per slot
    hist = [list(map(int, prompt_tokens[b])) for b in range(B)]
    new_counts = [0] * B
    done = [False] * B
    acc_sum, acc_n = 0.0, 0

    def _commit(b, t):
        if done[b] or new_counts[b] >= max_new_tokens:
            return
        hist[b].append(int(t))
        new_counts[b] += 1
        if (eos_id is not None and int(t) == eos_id) or new_counts[b] >= max_new_tokens:
            done[b] = True

    for b, t in enumerate(first.cpu().numpy()):
        _commit(b, t)

    n_rounds = 0
    fell_back = False
    hist_np = None
    while not all(done):
        active = torch.tensor([not d for d in done]).to(dev)
        start_marks = list(committed)
        budget_left = [max_new_tokens - new_counts[b] for b in range(B)]
        hist_dev, hlen, cache, acc = speculative_rounds(
            params, hist_dev, hlen, cache, active, rounds=R, k=k_draft, ngram=ngram,
            cfg=cfg, qcfg=qcfg, graph=graph)
        hist_np, hlen_np, acc_np = hist_dev.cpu().numpy(), hlen.cpu().numpy(), acc.cpu().numpy()
        n_rounds += R * sum(1 for d in done if not d)
        for b in range(B):
            if done[b]:
                continue
            for t in hist_np[b, committed[b]:int(hlen_np[b])]:
                _commit(b, t)
            committed[b] = int(hlen_np[b])
            # count only the rounds that began before the slot finished
            limit = start_marks[b] + budget_left[b]
            if eos_id is not None:
                seg = hist_np[b, start_marks[b]:int(hlen_np[b])]
                eos_hits = np.nonzero(seg == eos_id)[0]
                if eos_hits.size:
                    limit = min(limit, start_marks[b] + int(eos_hits[0]) + 1)
            pos = start_marks[b]
            for r in range(R):
                if pos >= limit:
                    break
                acc_sum += float(acc_np[r, b])
                acc_n += 1
                pos += int(acc_np[r, b]) + 1
        if (accept_floor > 0 and acc_n >= floor_window and acc_sum / acc_n < accept_floor
                and not all(done)):
            fell_back = True
            break

    if fell_back:
        # greedy decode from each slot's last committed token, the one at
        # hist[hlen - 1], emitted but not yet consumed; finished slots
        # decode along and are ignored at commit. The same tokens as
        # speculating on.
        hlen_np = hlen.cpu().numpy()
        used = int(cache.lengths.max())
        last = torch.tensor([int(hist_np[b, int(hlen_np[b]) - 1]) for b in range(B)],
                            dtype=torch.int32).to(dev)[:, None]
        while not all(done):
            n = min(32, max(max_new_tokens - new_counts[b] for b in range(B) if not done[b]),
                    max_len - 1 - used)
            if n <= 0:     # the cache's headroom is spent (not at the default slack)
                break
            toks, cache = decode_greedy_steps(params, last, cache, n=n, cfg=cfg, qcfg=qcfg,
                                              graph=graph)
            used += n
            for b, row in enumerate(toks.cpu().numpy()):
                for t in row:
                    if done[b]:
                        break
                    _commit(b, t)
            last = toks[:, -1:]

    stats = {"mean_accepted": acc_sum / acc_n if acc_n else 0.0, "live_rounds": acc_n,
             "rounds": n_rounds, "fell_back": fell_back}
    return hist, stats
