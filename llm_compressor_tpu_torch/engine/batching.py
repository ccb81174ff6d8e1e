"""Continuous batching: a slot-based serving loop with chunked admission
(port of ``engine/batching.py``).

Requests stream in; each prompt is prefilled into a free slot of a shared
KV cache, and one decode step advances every active slot per iteration;
a finished slot is recycled at once. Admission never stalls decode: a
prompt prefills in fixed chunks of ``prefill_chunk`` tokens on a
single-slot mini cache sized to the chunk-rounded prompt, at most one
chunk per decode step while slots decode (shortest remaining prompt
first), back to back while none does; the finished mini cache is spliced
into its slot (``kvcache.write_slot``).

Device work is two programs, as in the JAX package: the chunk prefill,
which runs eagerly here (its CUDA graph is later work, ROADMAP.md), and the
batched decode step, which on the card replays one CUDA graph over the
shared cache (``engine/graph.py``) with the tokens and the active mask as
its static inputs. Sampling runs on the host from a ``torch.Generator``
seeded from ``seed``, outside the graph, as the JAX batcher samples on the
host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import full_f32_accumulation
from ..models.config import ModelConfig
from ..models.transformer import head
from ..qformats import QuantConfig
from .generate import _forward_cached, _sample, use_graph
from . import graph as graphs
from .kvcache import KVCache, init_cache, write_slot


@dataclass
class Request:
    uid: int
    tokens: np.ndarray              # (T,) prompt
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: Optional[int] = None
    eos_id: Optional[int] = None
    # runtime state
    generated: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class _Pending:
    """A request mid-admission: its prompt prefills chunk by chunk into a
    single-slot mini cache, interleaved with decode steps."""
    req: Request
    mini: KVCache
    padded: np.ndarray              # (1, ceil(T / C) * C) zero-padded prompt
    length: int                     # true prompt length T
    offset: int = 0                 # tokens prefilled so far
    last: Optional[torch.Tensor] = None   # last-token logits (final chunk)


@torch.inference_mode()
def _prefill_chunk(params, tokens, cache1: KVCache, start: int, last_idx: int, *,
                   cfg: ModelConfig, qcfg: Optional[QuantConfig]):
    """One prompt chunk (1, C) on a single-slot cache at offset ``start``
    -> the logits (1, V) f32 at chunk row ``last_idx`` (they matter on the
    final chunk only: padding K/V past the prompt is causally masked and
    overwritten as the slot decodes). The head runs over every row of the
    chunk, as the JAX program does, so that each row takes its kernels'
    M = C plan; the matmuls accumulate in f32, as in ``prefill``."""
    with full_f32_accumulation():
        h = _forward_cached(params, cfg, tokens, cache1, qcfg, start=start)
        logits = head(params, cfg, h, qcfg)
    return logits[:, last_idx, :]


def _decode_all(params, tokens, cache: KVCache, active, *, cfg: ModelConfig,
                qcfg: Optional[QuantConfig]):
    """One decode step for every slot -> logits (B, V) f32; lengths advance
    by ``active`` (inactive slots write at their length, and advance
    nowhere)."""
    h = _forward_cached(params, cfg, tokens, cache, qcfg, start=None)
    logits = head(params, cfg, h, qcfg)
    cache.lengths += active.to(torch.int32)
    return logits[:, -1, :]


class ContinuousBatcher:
    """Slot-based continuous batching over a shared (optionally int8) KV
    cache on the params' device. Usage::

        eng = ContinuousBatcher(params, cfg, batch_slots=8, max_len=1024)
        eng.submit(prompt_tokens, max_new_tokens=64)
        results = eng.run()          # {uid: np.ndarray of generated ids}

    ``graph`` as ``generate.use_graph`` says: by default the decode step
    is one CUDA graph on the card, and eager on the CPU."""

    def __init__(self, params, cfg: ModelConfig, batch_slots: int = 8,
                 max_len: int = 1024, qcfg: Optional[QuantConfig] = None,
                 quantized_kv: bool = False, seed: int = 0,
                 prefill_chunk: int = 128, tp_mesh=None, graph: Optional[bool] = None):
        if tp_mesh is not None:
            raise NotImplementedError("tensor-parallel serving is not ported yet: ROADMAP.md "
                                      "queue A item 11 (parallel/)")
        self.params = params
        self.cfg = cfg
        self.qcfg = qcfg
        self.slots = batch_slots
        self.max_len = max_len
        self.quantized_kv = quantized_kv
        self.prefill_chunk = min(prefill_chunk, max_len)
        self.device = params["embed"]["weight"].device
        self.cache = self._new_cache(batch_slots, max_len)
        self.graph = use_graph(graph, self.cache.lengths)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.pending: Dict[int, _Pending] = {}        # slot -> mid-admission
        self.queue: List[Request] = []
        self.finished: Dict[int, np.ndarray] = {}
        self.next_token = np.zeros((batch_slots, 1), dtype=np.int32)
        self.gen = torch.Generator().manual_seed(seed)
        self.decode_steps = 0
        self._uid = 0

    def _new_cache(self, batch: int, max_len: int) -> KVCache:
        return init_cache(self.cfg.num_layers, batch, max_len, self.cfg.num_kv_heads,
                          self.cfg.head_dim, quantized=self.quantized_kv, device=self.device)

    def _chunk(self, tokens: np.ndarray, mini: KVCache, start: int, last_idx: int):
        return _prefill_chunk(self.params, torch.from_numpy(tokens).to(self.device), mini,
                              start, last_idx, cfg=self.cfg, qcfg=self.qcfg)

    def _decode(self, active: List[bool]) -> torch.Tensor:
        """One decode step over the shared cache -> logits (B, V)."""
        tokens = torch.from_numpy(self.next_token).to(self.device)
        act = torch.tensor(active, dtype=torch.bool).to(self.device)
        step = lambda tok, a: _decode_all(self.params, tok, self.cache, a, cfg=self.cfg,
                                          qcfg=self.qcfg)
        if not self.graph:
            with torch.inference_mode():
                return step(tokens, act)
        return graphs.run(self.cache, ("decode_all", self.cfg, self.qcfg), step,
                          (tokens, act), reads=self.params)

    # ------------------------------------------------------------------
    def submit(self, tokens: np.ndarray, **kw) -> int:
        tokens = np.asarray(tokens, np.int32).ravel()
        if tokens.size == 0:
            raise ValueError("empty prompt")
        if tokens.size >= self.max_len:
            raise ValueError(f"prompt ({tokens.size}) must leave room in max_len "
                             f"({self.max_len})")
        self._uid += 1
        self.queue.append(Request(self._uid, tokens, **kw))
        return self._uid

    def warmup(self) -> None:
        """Run both device programs before serving: the chunk prefill on a
        scratch mini cache, and the decode step with no slot active, twice
        with a graph (the eager first call, then the capture). Safe: the
        dummy decode writes K/V at the lengths of idle slots, which
        admission later overwrites."""
        mini = self._new_cache(1, self.prefill_chunk)
        self._chunk(np.zeros((1, self.prefill_chunk), np.int32), mini, 0, 0)
        for _ in range(2 if self.graph else 1):
            self._decode([False] * self.slots)

    def _start_pending(self) -> None:
        """Assign queued requests to free slots as chunked admissions."""
        for s in range(self.slots):
            if self.slot_req[s] is None and s not in self.pending and self.queue:
                req = self.queue.pop(0)
                T = len(req.tokens)
                C = self.prefill_chunk
                padded = np.zeros((1, -(-T // C) * C), np.int32)
                padded[0, :T] = req.tokens
                # a mini cache of the chunk-rounded prompt, not of max_len
                self.pending[s] = _Pending(req, self._new_cache(1, padded.shape[1]), padded, T)

    def _advance_pending(self, s: int) -> None:
        """Run one prompt chunk for slot ``s``; splice and activate the slot
        when its prompt is prefilled."""
        p = self.pending[s]
        C = self.prefill_chunk
        last_idx = max(0, min(p.length - 1 - p.offset, C - 1))
        p.last = self._chunk(p.padded[:, p.offset:p.offset + C], p.mini, p.offset, last_idx)
        p.offset += C
        if p.offset < p.padded.shape[1]:
            return
        m = p.mini
        with torch.inference_mode():
            write_slot(self.cache, s, m.k[:, 0], m.v[:, 0],
                       *((m.k_scale[:, 0], m.v_scale[:, 0]) if self.quantized_kv else ()))
            self.cache.lengths[s] = p.length
        self.slot_req[s] = p.req
        self.next_token[s, 0] = self._pick(p.last, p.req)
        del self.pending[s]

    def _admit(self) -> None:
        self._start_pending()
        if any(r is not None and not r.done for r in self.slot_req):
            # slots are decoding: at most one chunk of admission work per
            # decode step, shortest remaining prompt first
            if self.pending:
                s = min(self.pending, key=lambda s: (self.pending[s].padded.shape[1]
                                                     - self.pending[s].offset, s))
                self._advance_pending(s)
                self._start_pending()
        else:
            # nothing decoding: admissions back to back
            while self.pending:
                for s in list(self.pending):
                    self._advance_pending(s)
                self._start_pending()

    def _pick(self, logits: torch.Tensor, req: Request) -> int:
        """Sample the next token of ``req`` from its logits (1, V) on the
        host, and record it."""
        return self._record(req, int(_sample(logits.float().cpu(), req.temperature, req.top_k,
                                             self.gen)[0]))

    @staticmethod
    def _record(req: Request, tok: int) -> int:
        req.generated.append(tok)
        if (req.eos_id is not None and tok == req.eos_id) or \
                len(req.generated) >= req.max_new_tokens:
            req.done = True
        return tok

    def _retire(self, s: int) -> None:
        req = self.slot_req[s]
        self.finished[req.uid] = np.asarray(req.generated, np.int32)
        self.slot_req[s] = None

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """Admit, then one decode step. Returns False when all work is done."""
        for s in range(self.slots):
            r = self.slot_req[s]
            if r is not None and r.done:
                self._retire(s)
        self._admit()
        active = [r is not None and not r.done for r in self.slot_req]
        if not any(active) and not self.queue and not self.pending:
            return False
        logits = self._decode(active)
        self.decode_steps += 1
        greedy = all(r is None or r.done or r.temperature == 0.0 for r in self.slot_req)
        # at temperature 0 the pick is the argmax, taken on the device
        rows = torch.argmax(logits, -1).cpu() if greedy else logits.cpu()
        for s in range(self.slots):
            req = self.slot_req[s]
            if req is None or req.done:
                continue
            if len(req.generated) + len(req.tokens) >= self.max_len:
                req.done = True
                continue
            self.next_token[s, 0] = (self._record(req, int(rows[s])) if greedy
                                     else self._pick(rows[s:s + 1], req))
        return True

    def run(self) -> Dict[int, np.ndarray]:
        while self.step():
            pass
        for s in range(self.slots):
            if self.slot_req[s] is not None:
                self._retire(s)
        return self.finished
