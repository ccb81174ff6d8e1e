"""Parameters of the JAX package, handed over as numpy, into the port's form.

The input is the JAX params tree with every array as a numpy array
(bfloat16 and the fp8 codes arrive as ``ml_dtypes`` types, which
``torch.from_numpy`` rejects: they cross as same-width integer views and
are viewed back as the torch type). A packed QTensor arrives as
a dict of its fields: ``codes``, ``scales``, ``zeros`` (or None),
``shape``, ``blocked_shape``, ``group_axis``, ``ngroups_axis``,
``pair_planes``, ``dtype`` (a name such as "float32") and ``qspec``, its
quantizer's DSL string (``qformats.config.qspec_string``). The walk is
generic: every leaf of every ported architecture's tree crosses as it is
(Qwen2's q/k/v biases, the q/k norms, Gemma2/3's attention-output and
feed-forward norms). Whoever extracts the tree from JAX does so; this
module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.params import DTYPES
from .qformats.config import parse_qspec
from .qformats.qtensor import QTensor


# ml_dtypes names -> (integer view of the same width, torch dtype)
_VIEWED = {"bfloat16": (np.int16, torch.bfloat16),
           "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
           "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy (JAX hands out read-only views)
    if a.dtype.name in _VIEWED:
        as_int, dt = _VIEWED[a.dtype.name]
        return torch.from_numpy(a.view(as_int)).view(dt).to(device)
    return torch.from_numpy(a).to(device)


def qtensor_from_numpy(d: dict, device) -> QTensor:
    return QTensor(
        codes=tensor_from_numpy(d["codes"], device),
        scales=tensor_from_numpy(d["scales"], device),
        zeros=None if d.get("zeros") is None else tensor_from_numpy(d["zeros"], device),
        quantizer=parse_qspec(d["qspec"]),
        shape=tuple(d["shape"]),
        blocked_shape=tuple(d["blocked_shape"]),
        group_axis=int(d["group_axis"]),
        ngroups_axis=int(d["ngroups_axis"]),
        dtype=DTYPES[d["dtype"]],
        pair_planes=bool(d["pair_planes"]),
    )


def params_from_numpy(tree, device=None):
    """Nested dicts / lists of numpy arrays and QTensor field dicts -> the
    port's params on ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            if "qspec" in node:
                return qtensor_from_numpy(node, dev)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return tensor_from_numpy(node, dev)

    return walk(tree)
