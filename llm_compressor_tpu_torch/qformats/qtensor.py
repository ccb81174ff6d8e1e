"""QTensor — packed quantized tensors (port of ``qformats/qtensor.py``).

Storage matches the JAX package byte for byte, so a packed checkpoint
moves between the two unchanged:

* ``codes`` keeps the logical shape except that the group axis is halved
  for int4 (two values per byte). Codes are biased nibbles, value + 8.
  int4 defaults to the "pair planes" layout: byte j of group pair t holds
  element j of group 2t in its low nibble and element j of group 2t+1 in
  its high nibble. Odd group counts keep the "group halves" layout: byte i
  of a group holds elements (i, i + g/2).
* fp8 codes are ``torch.float8_e4m3fn`` / ``torch.float8_e5m2`` (one value
  per byte).
* Storage is flat: codes for an (N, C) weight are (N, C/2) uint8 or (N, C)
  int8 / fp8; ``scales`` / ``zeros`` are (N, G) float32. The stacked
  serving form adds a leading layer axis to every array.
* fp4 e2m1 codes (the fp, MX and NVFP4 formats) are 4-bit sign /
  exponent / mantissa fields, ``sign << 3 | index on FP4_GRID``, two per
  byte in the group-halves layout; MX-int4 and MX-int8 codes are the grid
  values times ``2**(mbits - 2)`` (int4 biased by +8 in group halves,
  int8 as is).
* ``zeros``: the int formats keep them only with a zero point (in the
  quantized domain, subtracted); the fp, MX and NVFP formats always keep
  them (a real-domain midpoint, added; all zero without a zero point), as
  the JAX package does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Optional

import torch

from .blocking import BlockMeta, unblock
from .formats import ElemFormat
from .numerics import quantize_elemwise
from .quantize import Quantizer, block_for, find_params_blocked

FP8_DTYPES = {ElemFormat.fp8_e4m3: torch.float8_e4m3fn, ElemFormat.fp8_e5m2: torch.float8_e5m2}
# positive fp4 e2m1 values, index == 3-bit magnitude code (exp << 1 | mant)
FP4_GRID = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)


@dataclass
class QTensor:
    codes: torch.Tensor                   # packed values (uint8 / int8)
    scales: torch.Tensor                  # per-group scales, flat (.., N, G)
    zeros: Optional[torch.Tensor]         # per-group zero points (or None)
    quantizer: Quantizer
    shape: tuple                          # logical shape
    blocked_shape: tuple
    group_axis: int                       # intra-group axis in the blocked array
    ngroups_axis: int = 0                 # n_groups axis in the blocked array
    dtype: torch.dtype = torch.bfloat16
    pair_planes: bool = False             # int4 nibble layout (see module doc)

    @property
    def fmt(self) -> ElemFormat:
        return self.quantizer.fmt

    @property
    def nbytes(self) -> int:
        """Bytes of the codes, scales and zeros (JAX
        ``qformats/qtensor.py:81-86``): what a checkpoint writes for this
        tensor, and what a matmul over it reads."""
        n = self.codes.numel() * self.codes.element_size()
        n += self.scales.numel() * self.scales.element_size()
        if self.zeros is not None:
            n += self.zeros.numel() * self.zeros.element_size()
        return n

    @property
    def scales_t(self) -> Optional[torch.Tensor]:
        """(.., G, N) transposed scale strip of a 2-D row-wise symmetric int
        weight (the JAX kernels' layout; the CUDA kernels read ``scales``)."""
        return scale_strip(self.quantizer, self.shape, self.scales)

    def layer(self, i: int) -> "QTensor":
        """Layer ``i`` of a stacked QTensor: views, no copy."""
        return replace(self, codes=self.codes[i], scales=self.scales[i],
                       zeros=None if self.zeros is None else self.zeros[i])


def _pack_nibbles(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Group-halves layout: byte i of a group holds elements (i, i + g/2)."""
    v = v.to(torch.uint8)
    n = v.shape[axis]
    if n % 2:
        raise ValueError("group axis must be even to pack nibbles")
    lo, hi = v.narrow(axis, 0, n // 2), v.narrow(axis, n // 2, n // 2)
    return lo | (hi << 4)


def _unpack_nibbles(p: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.cat([p & 0x0F, p >> 4], dim=axis)


def _pack_nibbles_pairs(v: torch.Tensor, ngroups_axis: int) -> torch.Tensor:
    """Pair-planes layout: byte j of group pair (2t, 2t+1) holds element j
    of group 2t (low nibble) and element j of group 2t+1 (high nibble)."""
    v = v.to(torch.uint8)
    G = v.shape[ngroups_axis]
    if G % 2:
        raise ValueError("pair-planes packing needs an even group count")
    idx = torch.arange(0, G, 2, device=v.device)
    lo = v.index_select(ngroups_axis, idx)
    hi = v.index_select(ngroups_axis, idx + 1)
    return lo | (hi << 4)


def _unpack_nibbles_pairs(p: torch.Tensor, ngroups_axis: int) -> torch.Tensor:
    """(.., G/2, g, ..) packed -> (.., G, g, ..) values (interleave the
    even/odd group planes)."""
    stacked = torch.stack([p & 0x0F, p >> 4], dim=ngroups_axis + 1)
    s = stacked.shape
    merged = tuple(s[:ngroups_axis]) + (s[ngroups_axis] * 2,) + tuple(s[ngroups_axis + 2:])
    return stacked.reshape(merged)


def pair_planes_for(q: Quantizer, n_groups: int, group: int) -> bool:
    """True when a tensor packs in the pair-planes int4 layout: symmetric
    int4 with an even group count and 2*group <= 2048."""
    return (q.qtype == "int" and q.fmt == ElemFormat.int4
            and n_groups % 2 == 0 and 2 * group <= 2048)


def scale_strip(q: Quantizer, shape: tuple, scales: torch.Tensor):
    """(.., G, N) transposed scale strip for 2-D row-wise-grouped symmetric
    int tensors; None otherwise."""
    if (len(shape) == 2 and q.eff_axes == -1 and q.qtype == "int"
            and not q.zero_point):
        return scales.transpose(-1, -2)
    return None


def _flatten_groups(arr: torch.Tensor, a: int) -> torch.Tensor:
    s = arr.shape
    return arr.reshape(tuple(s[:a]) + (s[a] * s[a + 1],) + tuple(s[a + 2:]))


def _check_packable(q: Quantizer) -> None:
    if q.qtype not in ("int", "fp", "mx", "nvfp"):
        raise ValueError(f"cannot pack qtype {q.qtype}")


def _encode_fp4(x32: torch.Tensor) -> torch.Tensor:
    """4-bit codes (sign << 3 | magnitude index) of values already on the
    fp4 grid."""
    sign = (x32 < 0).to(torch.uint8)
    grid = torch.tensor(FP4_GRID[1:], dtype=torch.float32, device=x32.device)
    idx = (torch.abs(x32)[..., None] >= grid).sum(-1).to(torch.uint8)
    return (sign << 3) | idx


@lru_cache(maxsize=None)
def _fp4_values(device: torch.device) -> torch.Tensor:
    """The 16 fp4 values by code, made once per device: a copy to the card
    cannot run while a CUDA graph is being captured."""
    return torch.tensor(FP4_GRID + tuple(-v for v in FP4_GRID), dtype=torch.float32,
                        device=device)


def _decode_fp4(codes4: torch.Tensor) -> torch.Tensor:
    """f32 values of 4-bit fp4 codes (code 8 is -0.0)."""
    return _fp4_values(codes4.device)[codes4.long()]


def quantize_pack(q: Quantizer, x: torch.Tensor, scales: Optional[torch.Tensor] = None,
                  zeros: Optional[torch.Tensor] = None) -> QTensor:
    """Quantize ``x`` into a packed :class:`QTensor`. The group parameters
    are solved from ``x`` unless ``scales`` (and ``zeros``) are given in
    the blocked shape ``find_params`` returns — a calibration algorithm's
    own parameters, which make packing its output lossless."""
    _check_packable(q)
    xb, meta, axes = block_for(q, x)
    if meta is None:
        raise NotImplementedError("per-tensor packing: use group_size=-1/-2/N")
    if scales is None:
        scales, zeros = find_params_blocked(q, xb, axes)
    intra_axis = axes % xb.dim()
    pairs = pair_planes_for(q, xb.shape[meta.axis], xb.shape[intra_axis])
    z = zeros if zeros is not None else 0.0
    p = q.params
    if q.qtype != "int":
        qv = quantize_elemwise((xb.float() - z) / scales, p, round="nearest",
                               saturate_normals=True)
        if q.fmt in FP8_DTYPES:
            codes = qv.to(FP8_DTYPES[q.fmt])
        elif q.fmt == ElemFormat.fp4_e2m1:
            codes = _pack_nibbles(_encode_fp4(qv), intra_axis)
        else:  # MX int4 / int8: the grid in [-max_norm, max_norm] * 2**(mbits - 2)
            iv = qv * 2.0 ** (p.mbits - 2)
            if q.fmt == ElemFormat.int8:
                codes = iv.to(torch.int8)
            else:
                codes = _pack_nibbles((iv + 8.0).to(torch.uint8), intra_axis)
    else:
        qmax = float(p.int_max)
        qv = torch.clamp(torch.round(xb.float() / scales + z), -qmax, qmax)
        if q.fmt == ElemFormat.int8:
            codes = qv.to(torch.int8)
        elif pairs:
            codes = _pack_nibbles_pairs((qv + 8.0).to(torch.uint8), meta.axis)
        else:
            codes = _pack_nibbles((qv + 8.0).to(torch.uint8), intra_axis)

    scales32 = scales.float()
    keep_zeros = zeros is not None and (q.qtype != "int" or q.zero_point)
    zeros32 = zeros.float() if keep_zeros else None
    a = meta.axis
    return QTensor(
        codes=_flatten_groups(codes, a).contiguous(),
        scales=_flatten_groups(scales32, a).contiguous(),
        zeros=None if zeros32 is None else _flatten_groups(zeros32, a).contiguous(),
        quantizer=q,
        shape=tuple(x.shape),
        blocked_shape=tuple(xb.shape),
        group_axis=intra_axis,
        ngroups_axis=a,
        dtype=x.dtype,
        pair_planes=pairs,
    )


def to_group_halves(qt: QTensor) -> QTensor:
    """The same int4 QTensor in the group-halves layout (a byte permutation)
    when it is in pair planes; any other QTensor as it is."""
    if not qt.pair_planes:
        return qt
    cs = qt.codes.shape
    G = qt.scales.shape[-1]
    gp = cs[-1] // G
    a = len(cs) - 1
    vals = _unpack_nibbles_pairs(qt.codes.reshape(tuple(cs[:-1]) + (G // 2, 2 * gp)), a)
    legacy = _pack_nibbles(vals, a + 1)
    return replace(qt, codes=legacy.reshape(cs).contiguous(), pair_planes=False)


def unpack_int_codes(qt: QTensor) -> torch.Tensor:
    """Signed integer values (int8 tensor, blocked ``(.., G, g, ..)`` view
    along the packed axis) of an int4/int8 QTensor (integer or MX grid
    codes)."""
    a = qt.ngroups_axis
    G = qt.scales.shape[a]
    cs = qt.codes.shape
    gp = cs[a] // G
    if qt.fmt == ElemFormat.int8:
        return qt.codes.reshape(tuple(cs[:a]) + (G, gp) + tuple(cs[a + 1:]))
    if qt.pair_planes:
        pb = qt.codes.reshape(tuple(cs[:a]) + (G // 2, 2 * gp) + tuple(cs[a + 1:]))
        vals = _unpack_nibbles_pairs(pb, a)
    else:
        vals = _unpack_nibbles(qt.codes.reshape(tuple(cs[:a]) + (G, gp) + tuple(cs[a + 1:])),
                               a + 1)
    return (vals.to(torch.int16) - 8).to(torch.int8)


def dequantize(qt: QTensor) -> torch.Tensor:
    """Plain dequantization: (code - z) * s for the int formats, value * s
    + z for the fp, MX and NVFP formats (an MX integer code's value is
    ``code / 2**(mbits - 2)``), in f32, cast to ``qt.dtype`` (the kernels
    fuse this into the matmul with their own roundings)."""
    q = qt.quantizer
    _check_packable(q)
    a = qt.ngroups_axis
    ss = qt.scales.shape
    G = ss[a]
    grouped = lambda t: t.reshape(tuple(ss[:a]) + (G, -1) + tuple(ss[a + 1:]))
    scales_b = grouped(qt.scales)
    z = 0.0 if qt.zeros is None else grouped(qt.zeros)
    if q.qtype == "int":
        vals = (unpack_int_codes(qt).float() - z) * scales_b
    else:
        if q.fmt in FP8_DTYPES:
            qv = grouped(qt.codes).float()
        elif q.fmt == ElemFormat.fp4_e2m1:
            qv = _decode_fp4(_unpack_nibbles(grouped(qt.codes), a + 1))
        else:
            qv = unpack_int_codes(qt).float() / 2.0 ** (q.params.mbits - 2)
        vals = qv * scales_b + z
    blocked = tuple(vals.shape)
    padded = math.prod(qt.blocked_shape) != math.prod(qt.shape)
    orig_len = qt.shape[a] if padded else blocked[a] * blocked[a + 1]
    meta = BlockMeta(axis=a, orig_len=orig_len, group=blocked[a + 1], blocked_shape=blocked)
    return unblock(vals, meta).to(qt.dtype)
