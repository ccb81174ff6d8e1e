"""Group reshaping (port of ``qformats/blocking.py``).

Pad the grouped axis with zeros to a multiple of the group size, then split
it into ``(n_groups, group)``. Group-size conventions: ``0`` per-tensor,
``-1`` per-token (whole last axis), ``-2`` per-channel (whole second-to-last
axis), ``> 0`` per-group along ``axes`` (-1 row-wise, -2 column-wise).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class BlockMeta:
    """Static metadata needed to undo :func:`block`."""

    axis: int            # normalized (positive) blocked axis in the original array
    orig_len: int        # original length of that axis
    group: int           # group size actually used (resolved, > 0)
    blocked_shape: tuple  # shape after blocking


def resolve_group(group_size, axes: int, shape) -> tuple[int, int]:
    """Returns ``(group, axes)`` with group > 0, or ``(0, axes)`` for per-tensor."""
    if group_size == 0:
        return 0, axes
    if group_size == -1:
        return shape[-1], -1
    if group_size == -2:
        return shape[-2], -2
    if group_size < 0:
        raise ValueError(f"Unsupported group_size {group_size}")
    return int(group_size), axes


def block(x: torch.Tensor, group: int, axes: int) -> tuple[torch.Tensor, BlockMeta]:
    """Split axis ``axes`` of ``x`` into ``(n_groups, group)``; the group
    dimension lands at index ``axes`` of the blocked array."""
    if axes not in (-1, -2):
        raise ValueError(f"axes must be -1 (row-wise) or -2 (column-wise), got {axes}")
    axis = (x.dim() + axes) % x.dim()
    orig_len = x.shape[axis]
    pad = (-orig_len) % group
    if pad:
        widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
        x = F.pad(x, widths)
    n = x.shape[axis] // group
    new_shape = tuple(x.shape[:axis]) + (n, group) + tuple(x.shape[axis + 1:])
    return x.reshape(new_shape), BlockMeta(axis=axis, orig_len=orig_len, group=group,
                                           blocked_shape=new_shape)


def unblock(y: torch.Tensor, meta: BlockMeta) -> torch.Tensor:
    """Inverse of :func:`block`: merge groups and strip padding."""
    shape = list(y.shape)
    a = meta.axis
    merged = shape[:a] + [shape[a] * shape[a + 1]] + shape[a + 2:]
    out = y.reshape(merged)
    if merged[a] != meta.orig_len:
        out = out.narrow(a, 0, meta.orig_len)
    return out
