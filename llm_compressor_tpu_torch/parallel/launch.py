"""Spawn the ranks of a process group on one host and run a function on
each.

JAX drives every device from one process; PyTorch runs one process per
rank. :func:`run` starts ``world`` processes (``spawn``), starts their
process group from a ``file://`` store in a directory the caller gives (no
TCP port, so concurrent runs cannot clash), keeps each to one intra-op
thread, calls ``fn(rank, world, *args)`` in each and returns every rank's
result, in rank order. A rank that raises, or dies, fails the run in the
parent; the other ranks are then stopped.

``fn`` travels by import path: it must live in a module that imports no
JAX (the children import only it and what it imports), and its results
are pickled back (numpy arrays, numbers, lists and dicts of them).
"""

from __future__ import annotations

import os
import queue
import time
import traceback
import uuid
from typing import Callable, List, Optional, Sequence

import torch


def pick_backend(local_ranks: int) -> str:
    """The backend of a group of ``local_ranks`` ranks on one host, from
    the topology, before any group starts: NCCL when every rank has a card
    of its own, gloo when ranks share a card or run on the CPU."""
    own_cards = torch.cuda.is_available() and torch.cuda.device_count() >= local_ranks
    return "nccl" if own_cards else "gloo"


def _rank_main(rank: int, world: int, store: str, backend: str, device: Optional[str],
               fn: Callable, args: tuple, results) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # one host: the loopback
    try:
        if device is not None:
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=f"file://{store}", world_size=world,
                                rank=rank)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def run(fn: Callable, world: int, store_dir: str, args: Sequence = (), backend: str = "gloo",
        devices: Optional[Sequence[str]] = None, timeout: float = 600.0) -> List:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of a
    ``backend`` group -> the ranks' results in rank order. ``devices``
    gives each rank its card (``torch.cuda.set_device``), e.g. all
    "cuda:0" for ranks that share one over gloo. Raises ``RuntimeError``
    with the rank's traceback when a rank fails, or after ``timeout``
    seconds; stops every child before it returns or raises."""
    import torch.multiprocessing as mp

    if devices is not None and len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(store_dir, f"store-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, store, backend, None if devices is None else devices[r],
                               fn, tuple(args), results))
             for r in range(world)]
    out: dict = {}
    started = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
            started.append(p)
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit code "
                                       f"{procs[dead[0]].exitcode}) without a result")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"ranks {sorted(set(range(world)) - set(out))} gave no "
                                       f"result in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(world)]
