"""Operations and bytes of a served decode step, from a configuration's
shapes and recipe alone, and the published peaks of one NVIDIA H100 SXM
(dense, no sparsity, at its 700 W limit).

Each kernel's input bytes are counted once and its output bytes once,
whatever it reads again; the same work counts the same whatever kernel
does it. A step at batch M (one token a slot), with the recipe's bits
(W4A8: int4 linears, an int8 head, int8 acts and cache):

* linears (B1, B2, B3): each projection as served (q|k|v fused, gate|up
  fused with its activation, the head): codes N K bits / 8, f32 group
  scales N K / group * 4, acts M K bits / 8 and their f32 scales M * 4,
  bf16 outputs M N * 2 (gate|up: M N / 2 * 2); operations 2 M N K;
* attention (B4), per layer: the K and V codes and f32 scales of every
  cache row the step's slots cover (2 KV D bits / 8 + 2 KV 4 bytes a row),
  the appended row written once more, q and the output in f32 (H D 4
  each, a slot); operations 4 H D a covered row (Q.K and P.V);
* the whole step: every weight read (the packed head; the embedding table
  is gathered, not read), the KV rows read, the operations of both.

Operations are held to the int8 peak. The metric readers take these
through :class:`Counters` (``of(config)``), which a family whose layers
are not attention and a dense MLP replaces with a subclass of its own.
"""

from __future__ import annotations

from typing import NamedTuple

from .reference.model import Bits
from .spec import Spec

HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12


class Counters(NamedTuple):
    """The (bytes, ops) of a configuration's served decode step, as the
    metric readers ask for them. A family file's ``Counters`` subclasses
    this and overrides what its layers change."""
    spec: Spec
    bits: Bits

    # the kernel classes (``traceutil``) that run the step's linears; the
    # trace's primary launches of these classes are the ones counted
    LINEAR_CLASSES = ("B1/B3", "B2")

    def linears(self, m: int):
        """(bytes, ops) of every launch of LINEAR_CLASSES in one step at
        batch m."""
        return w4a8_step(self.spec, self.bits, m)

    def linear_launches(self) -> int:
        """Primary launches of LINEAR_CLASSES a step: one a linear, and the
        head's."""
        return self.spec.layers * len(projections(self.spec)) + 1

    def attention(self, rows: int, slot_steps: int):
        """(bytes, ops) of the step's attention kernel over ``rows`` cache
        rows a layer and ``slot_steps`` slots times steps."""
        return attention(self.spec, self.bits, rows, slot_steps)

    def weights_bytes(self) -> int:
        """Weights one step reads."""
        return step_weights_bytes(self.spec, self.bits)


def of(config: dict) -> Counters:
    """The counters of a configuration file, its family's own or these
    (``spec, bits = of(config)`` unpacks them)."""
    from .family import of as family_of    # family.py imports this module for its default

    fam = family_of(config)
    return fam.counters(fam.spec(config), fam.bits_of(config["recipe"]))


def projections(spec: Spec):
    """(N, K, output columns) of one layer's served linears."""
    E, I, D = spec.hidden, spec.ffn, spec.head_dim
    qkv = (spec.heads + 2 * spec.kv_heads) * D
    out = [(qkv, E, qkv), (E, spec.heads * D, E)]
    if spec.gated:
        out += [(2 * I, E, I), (E, I, E)]
    else:
        out += [(I, E, I), (E, I, E)]
    return out


def linear_weight_count(spec: Spec) -> int:
    """Weights of the decoder's linears (all layers)."""
    return spec.layers * sum(n * k for n, k, _ in projections(spec))


def weight_bytes(n: int, k: int, bits: int, group: int) -> int:
    return n * k * bits // 8 + n * (k // group) * 4


def matmul(m: int, n: int, k: int, wbits: int, group: int, abits: int, cols: int):
    """(bytes, ops) of one integer matmul at M = m."""
    return (weight_bytes(n, k, wbits, group) + m * k * abits // 8 + m * 4 + m * cols * 2,
            2 * m * n * k)


def w4a8_step(spec: Spec, bits: Bits, m: int):
    """(bytes, ops) of every B1/B2/B3 launch of one step at batch m."""
    b = o = 0
    for n, k, cols in projections(spec):
        db, do = matmul(m, n, k, bits.weight, bits.group, bits.act, cols)
        b, o = b + db * spec.layers, o + do * spec.layers
    db, do = matmul(m, spec.vocab, spec.hidden, bits.head_weight, bits.head_group,
                    bits.head_act, spec.vocab)
    return b + db, o + do


def kv_row_bytes(spec: Spec, bits: Bits) -> int:
    """One cache row of one layer: K and V codes and their f32 scales."""
    return 2 * spec.kv_heads * spec.head_dim * bits.kv // 8 + 2 * spec.kv_heads * 4


def attention(spec: Spec, bits: Bits, rows: int, slot_steps: int):
    """(bytes, ops) of B4 over all layers: ``rows`` cache rows covered per
    layer (summed over slots and steps), ``slot_steps`` slots times steps."""
    per_slot = kv_row_bytes(spec, bits) + 2 * spec.heads * spec.head_dim * 4
    b = rows * kv_row_bytes(spec, bits) + slot_steps * per_slot
    return spec.layers * b, spec.layers * 4 * spec.heads * spec.head_dim * rows


def step_weights_bytes(spec: Spec, bits: Bits) -> int:
    """Weights one step reads: the packed linears and the packed head."""
    return (spec.layers * sum(weight_bytes(n, k, bits.weight, bits.group)
                              for n, k, _ in projections(spec))
            + weight_bytes(spec.vocab, spec.hidden, bits.head_weight, bits.head_group))


def bound_s(nbytes: float, ops: float) -> float:
    """The least time: bytes at the HBM peak or int8 ops at theirs."""
    return max(nbytes / HBM_BYTES_S, ops / INT8_OPS_S)
