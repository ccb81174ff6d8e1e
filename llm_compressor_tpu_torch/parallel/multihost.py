"""Multi-host orchestration over ``torch.distributed`` (port of
``parallel/multihost.py``).

The JAX package runs one process per host and builds a DCN(data) x
ICI(model) mesh, so that tensor parallelism stays inside each host's
fast links and only data-parallel traffic crosses hosts. PyTorch runs one
process per rank (``torchrun --nnodes H --nproc-per-node P``); the ranks
of host h are [h * P, (h + 1) * P), and the same layout keeps "model"
inside a host (NVLink) and "data" across hosts.

Usage (the same command on every host)::

    from llm_compressor_tpu_torch.parallel import multihost
    multihost.initialize()                       # torchrun's variables, or
    multihost.initialize(coordinator="10.0.0.1:1234", num_processes=2,
                         process_id=int(os.environ["HOST_ID"]))
    mesh = multihost.make_multihost_mesh(model_axis="ici")
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .launch import pick_backend
from .mesh import mesh_device_type

LOGGER = logging.getLogger("llm_compressor_tpu_torch")


def _local_world() -> int:
    """Ranks on this host: torchrun's ``LOCAL_WORLD_SIZE``, else the whole
    world (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """``init_process_group`` from torchrun's environment (no arguments) or
    an explicit ``coordinator`` ("host:port"), ``num_processes`` and
    ``process_id``. A no-op when already initialised; a failure is logged
    at debug level and the run goes on as one process (JAX :25-42). The
    backend is picked from the topology before the group starts
    (``launch.pick_backend`` over ``LOCAL_WORLD_SIZE`` ranks a host)."""
    if dist.is_initialized():
        return
    if coordinator is not None:
        kwargs = dict(init_method=f"tcp://{coordinator}", world_size=num_processes,
                      rank=process_id)
    else:
        kwargs = dict(init_method="env://")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    try:
        dist.init_process_group(backend=pick_backend(local), **kwargs)
        LOGGER.info(f"torch.distributed: rank {dist.get_rank()} / {dist.get_world_size()}, "
                    f"{torch.cuda.device_count()} local cards")
    except (RuntimeError, ValueError) as e:   # a single-process run is fine
        LOGGER.debug(f"distributed init skipped: {e}")


def multihost_layout(world: int, n_hosts: int, model_axis: str = "ici"):
    """(rank array, axis names) of the multi-host mesh: (hosts, ranks per
    host) named ("data", "model") for "ici"; for "dcn" its transpose named
    ("model", "data"), so that "model" runs across hosts and each column
    is one host (JAX :45-64)."""
    if world % n_hosts:
        raise ValueError(f"{world} ranks do not split over {n_hosts} hosts")
    arr = np.arange(world).reshape(n_hosts, world // n_hosts)
    if model_axis == "ici":
        return arr, ("data", "model")
    return arr.T, ("model", "data")


def make_multihost_mesh(model_axis: str = "ici"):
    """The ``DeviceMesh`` of :func:`multihost_layout` over the initialised
    process group, ``LOCAL_WORLD_SIZE`` ranks per host."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    arr, names = multihost_layout(world, world // _local_world(), model_axis)
    return DeviceMesh(mesh_device_type(), torch.from_numpy(arr.copy()), mesh_dim_names=names)
