"""Process mesh and sharding specs (port of ``parallel/mesh.py``).

One ``DeviceMesh`` with named axes ("data", "model") over the process
group, Megatron-style specs per parameter, as the JAX package lays them
out:

* q/k/v/gate/up/fc1 (and BLOOM's fused qkv) shard the OUTPUT dim over
  "model": activations come out head-sharded, no collective;
* o/down/fc2 shard the INPUT dim over "model": one all-reduce each;
* embeddings and norms are replicated; a 2-D float ``lm_head`` is
  vocab-sharded;
* activations' batch dims are sharded over "data".

Weights are stored (out, in): "shard the output dim" is ``("model",
None)``, "shard the input dim" ``(None, "model")``. A spec is a tuple of
axis names, one per dim (``()`` replicates), so that it compares with the
JAX ``PartitionSpec`` leaf for leaf. A packed QTensor shards its codes,
scales and zeros along the same logical dims: N for column-parallel
slots, the group dim G (which follows the contraction) for row-parallel
ones. The port stores no transposed ``scales_t`` strip (its kernels read
``scales``), so that JAX leaf has no counterpart here.

The JAX package runs a plain jitted ``forward`` over params placed with
these specs and lets XLA place the collectives (GSPMD). PyTorch has no
such compiler: :func:`shard_params` gives this rank its local slices, and
``parallel.tp.tp_forward`` runs the model under ``models.layers.tp_trace``
with explicit collectives. A rank's product needs whole heads and, for a
row-parallel slot, whole groups, so :func:`shard_params` refuses a tree in
which such a slot would stay replicated (GSPMD replicates it and computes
globally).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..qformats.qtensor import QTensor

# column-parallel (shard the out dim) and row-parallel (shard the in dim)
_COL_SLOTS = ("q", "k", "v", "qkv", "gate", "up", "fc1")
_ROW_SLOTS = ("o", "down", "fc2")
COL, ROW = ("model", None), (None, "model")
_QT_FIELDS = ("codes", "scales", "zeros")


def mesh_device_type() -> str:
    """"cuda" over NCCL, else "cpu" (gloo: on the CPU, or ranks that share
    a card; the groups carry CUDA tensors all the same)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_data: int = 1, n_model: Optional[int] = None):
    """A ("data", "model") ``DeviceMesh`` of ``n_data`` x ``n_model`` ranks
    over the initialised process group (``n_model`` defaults to the world
    over ``n_data``)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_model is None:
        n_model = world // n_data
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(mesh_device_type(), (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, tensor)`` over a params tree: dicts and lists keep their
    structure, a QTensor becomes a dict of its array fields (``codes``,
    ``scales``, ``zeros`` where present); a path is the tuple of dict keys,
    list indices and field names down to the tensor."""
    if isinstance(tree, QTensor):
        return {f: fn(path + (f,), getattr(tree, f)) for f in _QT_FIELDS
                if getattr(tree, f) is not None}
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(path, tree)


def _linear_spec(slot) -> tuple:
    if slot in _COL_SLOTS:
        return COL
    if slot in _ROW_SLOTS:
        return ROW
    return (None, None)


def _leaf_spec(path, leaf, n_model: int = 0) -> tuple:
    """The spec of one leaf from its path (JAX :47-103)."""
    keys = list(path)
    for i, k in enumerate(keys):
        if k in ("attn", "mlp") and i + 1 < len(keys):
            slot, leafname = keys[i + 1], keys[-1]
            if slot in ("q_norm", "k_norm"):
                return ()
            spec = _linear_spec(slot)
            if leafname in _QT_FIELDS:
                # blocked (N, G, g[/2]) flat as (N, G * gp): N for a column
                # slot, the group dim for a row slot
                nd, shape = leaf.dim(), leaf.shape
                if spec == COL and (not n_model or shape[0] % n_model == 0):
                    return ("model",) + (None,) * (nd - 1)
                if spec == ROW and nd >= 2 and (not n_model or shape[1] % n_model == 0):
                    return (None, "model") + (None,) * (nd - 2)
                return ()
            if leafname == "bias":
                return ("model",) if spec == COL else ()
            return spec if leaf.dim() == 2 else ()
    if "lm_head" in keys:
        return COL if keys[-1] == "weight" and leaf.dim() == 2 else ()
    return ()


def _n_model(mesh) -> int:
    return axis_size(mesh, "model") if mesh is not None else 0


def param_spec_tree(params, cfg=None, mesh=None):
    """The spec tree of ``params`` (:func:`tree_map_with_path`'s shape).
    With ``mesh``, a packed leaf whose dim does not divide the model axis
    stays replicated, as in the JAX package."""
    n = _n_model(mesh)
    return tree_map_with_path(lambda p, leaf: _leaf_spec(p, leaf, n), params)


def _take(t: torch.Tensor, spec: tuple, coords: dict) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``; ``coords`` maps an axis
    name to (index, size). A copy, so that the global tensor can go."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        idx, n = coords[axis]
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide over {n} ranks")
        size = t.shape[dim] // n
        t = t.narrow(dim, idx * size, size)
    return t.contiguous().clone() if any(spec) else t


def _local_qtensor(qt: QTensor, fields: dict) -> QTensor:
    """A QTensor of this rank's code and scale blocks, with the logical and
    blocked shapes of the block (a 2-D weight with row-wise groups: scales
    ([L,] N, G), blocked (N, G, g))."""
    N, G = fields["scales"].shape[-2:]
    N0, G0 = qt.scales.shape[-2:]
    if (N, G) == (N0, G0):
        return replace(qt, **fields)
    if len(qt.shape) != 2 or qt.ngroups_axis != 1:
        raise ValueError("only 2-D weights with row-wise groups shard")
    g = qt.blocked_shape[2]
    if G != G0 and qt.shape[1] != G0 * g:
        raise ValueError("a padded contraction dim does not shard by groups")
    C = qt.shape[1] if G == G0 else G * g
    return replace(qt, **fields, shape=(N, C), blocked_shape=(N, G, g))


def shard_tree(params, specs, coords: dict):
    """``params`` cut to this rank's blocks under ``specs`` (a spec tree of
    the same structure), QTensors rebuilt with their local shapes."""
    if isinstance(params, QTensor):
        return _local_qtensor(params, {f: _take(getattr(params, f), specs[f], coords)
                                       for f in specs})
    if isinstance(params, dict):
        return {k: shard_tree(v, specs[k], coords) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [shard_tree(v, s, coords) for v, s in zip(params, specs)]
    if params is None:
        return None
    return _take(params, specs, coords)


def mesh_coords(mesh) -> dict:
    """axis -> (this rank's index, axis size)."""
    return {a: (axis_index(mesh, a), axis_size(mesh, a)) for a in mesh.mesh_dim_names}


def _check_explicit(params, specs, n_model: int) -> None:
    """Refuse a tree that the explicit tensor-parallel path cannot run: a
    linear of the attention or the MLP left replicated (see module doc)."""
    if n_model <= 1:
        return

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        elif isinstance(node, tuple) and path and path[-1] in ("weight", *_QT_FIELDS):
            slot = next((path[i + 1] for i, k in enumerate(path)
                         if k in ("attn", "mlp") and i + 1 < len(path)), None)
            if slot not in (None, "q_norm", "k_norm") and "model" not in node:
                raise ValueError(
                    f"{'.'.join(map(str, path))} stays replicated over {n_model} ranks: the "
                    "explicit tensor-parallel path needs whole heads and whole groups on each "
                    "rank (fused params: parallel.tp with fuse_model(shards=n) and fused=True)")

    walk(specs, ())


def shard_params(params, cfg, mesh):
    """This rank's local slices of unstacked ``params``, as the specs of
    :func:`param_spec_tree` say, with the int4 pair planes of a
    row-parallel slot turned to group halves where a rank would hold an
    odd number of groups (``parallel.tp._unpair_odd_row_shards``)."""
    from .tp import _unpair_odd_row_shards

    n = _n_model(mesh)
    params = _unpair_odd_row_shards(params, n)
    specs = param_spec_tree(params, cfg, mesh)
    _check_explicit(params, specs, n)
    return shard_tree(params, specs, mesh_coords(mesh))


def data_sharding(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a batch (dim 0 over "data"): the counterpart of
    the JAX ``NamedSharding`` that places one global array, since each rank
    here holds its own part."""
    idx, n = axis_index(mesh, "data"), axis_size(mesh, "data")
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide over {n} data ranks")
    b = x.shape[0] // n
    return x[idx * b:(idx + 1) * b]
