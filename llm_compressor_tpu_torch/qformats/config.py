"""Quantization-config DSL and per-op-class slots (port of
``qformats/config.py``).

The compact string DSL ``<fmt>-g[<gs>]-[zp-]<rw|cw>`` (e.g.
``int4-g[128]-rw``, ``int8-g[-1]-rw``) parses into immutable
:class:`Quantizer` specs grouped into the linear / matmul / head slots. The
mixed-precision override registry is not ported yet (ROADMAP.md); the
``overrides`` field and :meth:`QuantConfig.for_op` keep its lookup so that
op names resolve as in the JAX package.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional

from .formats import ElemFormat
from .quantize import Quantizer

_PATTERN = re.compile(
    r"(?P<format>[^-]+)"
    r"-g\[(?P<group>-?\d+)\]"
    r"-(?:(?P<zp>zp)-)?"
    r"(?P<wise>rw|cw)$"
)


def parse_qspec(s: Optional[str]) -> Quantizer:
    """Parse one DSL string into a :class:`Quantizer` (None -> dummy)."""
    if s is None or s in ("", "none", "None"):
        return Quantizer(qtype="dummy")
    m = _PATTERN.match(s)
    if not m:
        raise ValueError(f"Cannot parse quant config {s!r} "
                         "(expected e.g. 'int4-g[128]-zp-rw')")
    fmt_str = m.group("format")
    if fmt_str.startswith("mx"):
        qtype, fmt_str = "mx", fmt_str[2:]
    elif fmt_str.startswith("nvfp"):
        qtype, fmt_str = "nvfp", fmt_str[2:]
    elif fmt_str.startswith("fp"):
        qtype = "fp"
    elif fmt_str.startswith("int"):
        qtype = "int"
    else:
        raise ValueError(f"Invalid format {fmt_str!r} in {s!r}")
    alias = {"fp4": "fp4_e2m1", "fp8": "fp8_e4m3"}
    fmt = ElemFormat.from_any(alias.get(fmt_str, fmt_str))
    return Quantizer(
        qtype=qtype,
        fmt=fmt,
        group_size=int(m.group("group")),
        axes=-1 if m.group("wise") == "rw" else -2,
        zero_point=m.group("zp") == "zp",
    )


def qspec_string(q: Quantizer) -> Optional[str]:
    """Inverse of :func:`parse_qspec` (None for a dummy quantizer)."""
    if q.qtype == "dummy":
        return None
    prefix = {"int": "", "fp": "", "mx": "mx", "nvfp": "nv"}[q.qtype]
    zp = "zp-" if q.zero_point else ""
    return f"{prefix}{q.fmt.value}-g[{q.group_size}]-{zp}{'rw' if q.axes == -1 else 'cw'}"


@dataclass(frozen=True)
class OpQuantConfig:
    """Quantizers for one op class (weight + input/output activations)."""

    weight: Quantizer = Quantizer(qtype="dummy")
    act_in: Quantizer = Quantizer(qtype="dummy")
    act_out: Quantizer = Quantizer(qtype="dummy")


@dataclass(frozen=True)
class QuantConfig:
    """Per-op-class slots: ``linear`` (every decoder projection),
    ``matmul`` (QK^T and SV inside attention — where KV quantization
    lives) and ``head`` (the lm_head), plus per-op overrides."""

    linear: OpQuantConfig = OpQuantConfig()
    matmul: OpQuantConfig = OpQuantConfig()
    head: OpQuantConfig = OpQuantConfig()
    overrides: Dict[str, OpQuantConfig] = field(default_factory=dict)

    def for_op(self, op_name: str, op_class: str = "linear") -> OpQuantConfig:
        """Resolve the effective config for a named op."""
        if op_name in self.overrides:
            return self.overrides[op_name]
        return getattr(self, op_class)

    def __hash__(self):
        return hash((self.linear, self.matmul, self.head,
                     tuple(sorted(self.overrides.items(), key=lambda kv: kv[0]))))


def build_quant_config(
    weight: Optional[str] = None,
    act_in: Optional[str] = None,
    act_out: Optional[str] = None,
    head: Optional[str] = None,
    head_act: Optional[str] = None,
) -> QuantConfig:
    """Build the three-slot config from CLI-style DSL strings. ``head_act``
    adds an input-activation quantizer on the lm_head: with int8 per-token
    acts the packed head runs through the integer W4A8 kernel."""
    w = parse_qspec(weight)
    ai = parse_qspec(act_in)
    ao = parse_qspec(act_out)
    return QuantConfig(
        linear=OpQuantConfig(weight=w, act_in=ai, act_out=ao),
        matmul=OpQuantConfig(weight=Quantizer(qtype="dummy"), act_in=ai, act_out=ao),
        head=OpQuantConfig(weight=parse_qspec(head),
                           act_in=parse_qspec(head_act)),
    )
