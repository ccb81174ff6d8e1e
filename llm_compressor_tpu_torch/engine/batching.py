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

Device work is two programs, as in the JAX package, and on the card each
replays a CUDA graph (``engine/graph.py``), as JAX compiles each once:

* the chunk prefill, one graph for each chunk-count class (the prompt's
  chunks, ``padded / C``), as JAX compiles one program a class with
  ``start`` traced (JAX :62-72, :179-186). A graph bakes in its buffers,
  so each class keeps one static mini cache, and the chunk's tokens, its
  ``start`` and the prompt's last row ``last_idx`` are the graph's inputs
  (0-d device tensors; the row is picked inside the graph). Admissions of
  one class interleave (``_admit``), so the class's cache holds the rows
  of one of them at a time: another admission's rows are copied out when
  it takes the cache over and back in when it resumes (exact copies of
  the mini cache's few MB); a new admission starts on zeroed rows, as on
  a new cache. The captures are bounded by the classes, whatever the
  number of requests; ``warmup`` makes them all, in one memory pool
  shared by the chunk graphs (they never run at once);
* the batched decode step, one graph over the shared cache with the
  tokens and the active mask as its inputs. The splice writes the shared
  cache in place, so its buffers, and the graph, stay.

Sampling runs on the host from a ``torch.Generator`` seeded from ``seed``,
outside the graphs, as the JAX batcher samples on the host.

With ``tp_mesh`` the two programs run tensor-parallel over the mesh's
model group (``parallel.tp.tp_batch_fns``; JAX :95-140): each rank of the
group runs a batcher over its shard of the params, its caches hold its KV
heads, the slots are replicated, and every rank samples the same token
from the gathered logits with the same seeded generator. Under NCCL, with
a card a rank, both programs replay graphs, the collectives inside; over
gloo (ranks that share a card, or the CPU) they run eagerly, since a
capture cannot hold a gloo collective, which stages through the host.
"""

from __future__ import annotations

import functools
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
    """A request mid-admission: its prompt prefills chunk by chunk into the
    static mini cache of its class, interleaved with decode steps."""
    req: Request
    padded: np.ndarray              # (1, ceil(T / C) * C) zero-padded prompt
    length: int                     # true prompt length T
    offset: int = 0                 # tokens prefilled so far
    last: Optional[torch.Tensor] = None   # last-token logits (final chunk)
    # its mini cache's tensors while another admission of its class holds
    # the class's cache (None while it holds it, or before its first chunk)
    saved: Optional[List[torch.Tensor]] = None


def _kv(cache: KVCache) -> List[torch.Tensor]:
    """The K/V tensors of a cache: values or codes, and scales where kept."""
    return [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None]


@torch.inference_mode()
def _prefill_chunk(params, tokens, cache1: KVCache, start, last_idx, *,
                   cfg: ModelConfig, qcfg: Optional[QuantConfig]):
    """One prompt chunk (1, C) on a single-slot cache at offset ``start``
    -> the logits (1, V) f32 at chunk row ``last_idx`` (they matter on the
    final chunk only: padding K/V past the prompt is causally masked and
    overwritten as the slot decodes). ``start`` and ``last_idx`` are 0-d
    int64 tensors on the cache's device, so that one CUDA graph serves
    every chunk of a class, as JAX traces them. The head runs over every
    row of the chunk, as the JAX program does, so that each row takes its
    kernels' M = C plan; the matmuls accumulate in f32, as in ``prefill``."""
    with full_f32_accumulation():
        h = _forward_cached(params, cfg, tokens, cache1, qcfg, start=start)
        logits = head(params, cfg, h, qcfg)
    return logits.index_select(1, last_idx.reshape(1))[:, 0]


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

    ``graph`` as ``generate.use_graph`` says: by default the chunk prefill
    and the decode step replay CUDA graphs on the card (module doc), and
    run eagerly on the CPU; ``graph=False`` runs them eagerly on the card
    too, bitwise the same.

    ``tp_mesh``: run both programs tensor-parallel over the mesh's model
    group; ``params`` is then this rank's shard (``parallel.tp_shard_params``,
    with ``tp_fused`` for ``fuse_model(shards=n)`` params), and every rank
    of the group runs the same batcher on the same requests, in the same
    order, so that every rank captures and replays the same collectives.
    The graphs need NCCL with a card a rank (``parallel.tp.graphs_ok``):
    over gloo ``graph=None`` runs eagerly and ``graph=True`` raises
    ``ValueError``."""

    def __init__(self, params, cfg: ModelConfig, batch_slots: int = 8,
                 max_len: int = 1024, qcfg: Optional[QuantConfig] = None,
                 quantized_kv: bool = False, seed: int = 0,
                 prefill_chunk: int = 128, tp_mesh=None, tp_fused: bool = False,
                 graph: Optional[bool] = None):
        self.device = params["embed"]["weight"].device
        self._kv_heads = cfg.num_kv_heads
        group = None
        if tp_mesh is None:
            self._chunk_fn = functools.partial(_prefill_chunk, cfg=cfg, qcfg=qcfg)
            self._decode_fn = functools.partial(_decode_all, cfg=cfg, qcfg=qcfg)
        else:
            from ..parallel.mesh import axis_group, axis_size
            from ..parallel.tp import GRAPHS_NEED, graphs_ok, tp_batch_fns

            # the device first: on the CPU the mesh is not read
            ok = self.device.type == "cuda" and graphs_ok(tp_mesh)
            if graph and not ok:
                raise ValueError(GRAPHS_NEED)
            graph = graph if ok else False
            group = axis_group(tp_mesh, "model")
            self._kv_heads //= axis_size(tp_mesh, "model")
            self._chunk_fn, self._decode_fn = tp_batch_fns(params, cfg, tp_mesh, qcfg=qcfg,
                                                           fused=tp_fused)
        self.params = params
        self.cfg = cfg
        self.qcfg = qcfg
        self.slots = batch_slots
        self.max_len = max_len
        self.quantized_kv = quantized_kv
        self.prefill_chunk = min(prefill_chunk, max_len)
        self.cache = self._new_cache(batch_slots, max_len)
        self.graph = use_graph(graph, self.cache.lengths)
        # what a graph's key holds beside its buffers: the configs and, under
        # TP, the model group whose communicator its collectives bake in
        self._key = (cfg, qcfg, group)
        # chunk-count class -> its static single-slot cache, and the
        # admission whose rows that cache holds
        self._minis: Dict[int, KVCache] = {}
        self._holder: Dict[int, _Pending] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graph else None
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.pending: Dict[int, _Pending] = {}        # slot -> mid-admission
        self.queue: List[Request] = []
        self.finished: Dict[int, np.ndarray] = {}
        self.next_token = np.zeros((batch_slots, 1), dtype=np.int32)
        self.gen = torch.Generator().manual_seed(seed)
        self.decode_steps = 0
        self._uid = 0

    def _new_cache(self, batch: int, max_len: int) -> KVCache:
        return init_cache(self.cfg.num_layers, batch, max_len, self._kv_heads,
                          self.cfg.head_dim, quantized=self.quantized_kv, device=self.device)

    @property
    def chunk_classes(self) -> int:
        """The chunk-count classes a prompt can take: a prompt of at most
        ``max_len - 1`` tokens prefills in 1 .. this many chunks."""
        return -(-(self.max_len - 1) // self.prefill_chunk)

    def _mini(self, n: int, p: Optional[_Pending]) -> KVCache:
        """The static mini cache of class ``n`` (``n`` chunks), holding the
        rows of admission ``p`` (None: scratch rows, for ``warmup``). The
        admission that held it keeps a copy of its rows; ``p`` gets its own
        back, or zeroed rows before its first chunk."""
        mini = self._minis.get(n)
        if mini is None:
            mini = self._minis[n] = self._new_cache(1, n * self.prefill_chunk)
        holder = self._holder.get(n)
        if holder is not p:
            with torch.inference_mode():
                if holder is not None:
                    holder.saved = [t.clone() for t in _kv(mini)]
                if p is not None and p.saved is not None:
                    for t, rows in zip(_kv(mini), p.saved):
                        t.copy_(rows)
                else:
                    for t in _kv(mini):
                        t.zero_()
            if p is None:
                self._holder.pop(n, None)
            else:
                self._holder[n], p.saved = p, None
        return mini

    def _chunk(self, tokens: np.ndarray, mini: KVCache, start: int, last_idx: int):
        """One chunk prefill on ``mini`` -> the logits (1, V) at chunk row
        ``last_idx``: a replay of the class's graph, with ``graph``."""
        inputs = (torch.from_numpy(tokens).to(self.device),
                  torch.tensor(start, device=self.device),
                  torch.tensor(last_idx, device=self.device))
        fn = lambda tok, at, row: self._chunk_fn(self.params, tok, mini, at, row)
        if not self.graph:
            with torch.inference_mode():
                return fn(*inputs)
        return graphs.run(mini, ("chunk",) + self._key, fn, inputs, reads=self.params,
                          pool=self._pool)

    def _decode(self, active: List[bool]) -> torch.Tensor:
        """One decode step over the shared cache -> logits (B, V)."""
        tokens = torch.from_numpy(self.next_token).to(self.device)
        act = torch.tensor(active, dtype=torch.bool).to(self.device)
        step = lambda tok, a: self._decode_fn(self.params, tok, self.cache, a)
        if not self.graph:
            with torch.inference_mode():
                return step(tokens, act)
        return graphs.run(self.cache, ("decode_all",) + self._key, step, (tokens, act),
                          reads=self.params)

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
        """Run both device programs before serving: the chunk prefill (with
        a graph, of every chunk-count class on its static cache; else of
        one class) and the decode step with no slot active, twice with a
        graph (the eager first call, then the capture), so that ``run``
        captures nothing. Safe: the dummy chunks write scratch rows, which
        an admission zeroes or overwrites with its own, and the dummy
        decode writes K/V at the lengths of idle slots, which admission
        later overwrites."""
        zeros = np.zeros((1, self.prefill_chunk), np.int32)
        for _ in range(2 if self.graph else 1):
            for n in range(1, (self.chunk_classes if self.graph else 1) + 1):
                self._chunk(zeros, self._mini(n, None), 0, 0)
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
                # its class's mini cache holds the chunk-rounded prompt, not max_len
                self.pending[s] = _Pending(req, padded, T)

    def _advance_pending(self, s: int) -> None:
        """Run one prompt chunk for slot ``s``; splice and activate the slot
        when its prompt is prefilled."""
        p = self.pending[s]
        C = self.prefill_chunk
        n = p.padded.shape[1] // C
        m = self._mini(n, p)
        last_idx = max(0, min(p.length - 1 - p.offset, C - 1))
        p.last = self._chunk(p.padded[:, p.offset:p.offset + C], m, p.offset, last_idx)
        p.offset += C
        if p.offset < p.padded.shape[1]:
            return
        with torch.inference_mode():
            write_slot(self.cache, s, m.k[:, 0], m.v[:, 0],
                       *((m.k_scale[:, 0], m.v_scale[:, 0]) if self.quantized_kv else ()))
            self.cache.lengths[s] = p.length
        del self._holder[n]
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
