"""Tensor- and data-parallel serving over ``torch.distributed`` (port of
``parallel/``).

The JAX package drives every device from one process inside
``shard_map``; the port differs in three ways, by design:

* **One process per rank.** Each rank holds its local shard and runs the
  port's own code and kernels on it. The collectives are explicit
  ``torch.distributed`` calls on process groups: one for the "model" axis
  and one for the "data" axis, from ``init_device_mesh(...,
  mesh_dim_names=("data", "model"))`` (:func:`make_mesh`). A row-parallel
  projection all-reduces its partial sum over "model"; the per-token act
  scale of its input all-reduces the absmax (``models.layers.tp_trace``).
  :mod:`.launch` spawns the ranks of one host and starts their group;
  :mod:`.multihost` starts a group from torchrun's environment.
* **Results.** :func:`tp_serve_fns` and :func:`tp_batch_fns` return on
  every rank what the JAX global array holds: (B, vocab) logits, the vocab
  shards gathered over "model" and, for :func:`tp_serve_fns`, the batch
  gathered over "data". Caches stay local: each rank's holds its KV heads.
* **The backend is picked before launch, from the topology**
  (``launch.pick_backend``): NCCL when every rank has a card of its own,
  gloo when ranks share a card or run on the CPU. It is never changed
  after a failure. gloo takes CUDA tensors for every collective used here
  (all-reduce of a sum and of a max, all-gather) and stages them through
  the host itself.

Under NCCL (a card a rank) the TP decode step and the TP batcher's two
programs replay one CUDA graph a rank, the collectives captured inside
(``tp.graphs_ok``); over gloo they run eagerly, since a capture cannot
hold a gloo collective, and ``graph=True`` raises ``ValueError``.

The JAX GSPMD path (``shard_params``, then a plain jitted ``forward`` that
lets XLA place the collectives) has no PyTorch counterpart: here
:func:`shard_params` cuts this rank's blocks and :func:`tp_forward` runs
``forward`` through the explicit path.
"""

from .mesh import data_sharding, make_mesh, param_spec_tree, shard_params
from .tp import (
    tp_batch_fns,
    tp_forward,
    tp_init_cache,
    tp_param_specs,
    tp_serve_fns,
    tp_shard_params,
    tp_supported,
)

__all__ = [
    "make_mesh", "shard_params", "data_sharding", "param_spec_tree",
    "tp_init_cache", "tp_param_specs", "tp_serve_fns", "tp_shard_params",
    "tp_supported", "tp_batch_fns", "tp_forward",
]
