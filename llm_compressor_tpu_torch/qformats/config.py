"""Quantization-config DSL and per-op-class slots (port of
``qformats/config.py``).

The compact string DSL ``<fmt>-g[<gs>]-[zp-]<rw|cw>`` (e.g.
``int4-g[128]-rw``, ``int8-g[-1]-rw``, ``mxfp8_e4m3-g[32]-rw``,
``nvfp4_e2m1-g[16]-rw``) parses into immutable :class:`Quantizer` specs
grouped into the linear / matmul / head slots, plus the mixed-precision
(MPQ) override registry keyed by op names (``register_4_to_8bit``,
``register_8_to_4bit``, ``register_org_config``), which
:meth:`QuantConfig.for_op` resolves.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from typing import Dict, Optional

from .formats import ElemFormat
from .quantize import Quantizer

_PATTERN = re.compile(
    r"(?P<format>[^-]+)"
    r"-g\[(?P<group>-?\d+)\]"
    r"-(?:(?P<zp>zp)-)?"
    r"(?P<wise>rw|cw)$"
)


def parse_qspec(s: Optional[str], mse: bool = False) -> Quantizer:
    """Parse one DSL string into a :class:`Quantizer` (None -> dummy);
    ``mse`` turns on the MSE clip search."""
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
        mse=mse,
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
    w_mse: bool = False,
    head_act: Optional[str] = None,
) -> QuantConfig:
    """Build the three-slot config from CLI-style DSL strings. ``w_mse``
    turns on the MSE clip search on the weight quantizers (linears and
    head). ``head_act`` adds an input-activation quantizer on the lm_head:
    with int8 per-token acts the packed head runs through the integer W4A8
    kernel."""
    w = parse_qspec(weight, mse=w_mse)
    ai = parse_qspec(act_in)
    ao = parse_qspec(act_out)
    return QuantConfig(
        linear=OpQuantConfig(weight=w, act_in=ai, act_out=ao),
        matmul=OpQuantConfig(weight=Quantizer(qtype="dummy"), act_in=ai, act_out=ao),
        head=OpQuantConfig(weight=parse_qspec(head, mse=w_mse),
                           act_in=parse_qspec(head_act)),
    )


# ---------------------------------------------------------------------------
# The mixed-precision (MPQ) override registry
# ---------------------------------------------------------------------------


def _bump_fmt_up(qz: Quantizer) -> Quantizer:
    """int4 -> int8, fp4 -> fp8 e4m3; anything else as it is."""
    if qz.qtype == "dummy" or qz.fmt is None:
        return qz
    name = qz.fmt.value
    if name.startswith("int"):
        return replace(qz, fmt=ElemFormat.int8)
    if name.startswith("fp4"):
        return replace(qz, fmt=ElemFormat.fp8_e4m3)
    return qz


def _bump_fmt_down(qz: Quantizer) -> Quantizer:
    """int8 -> int4, fp8 -> fp4 e2m1; anything else as it is."""
    if qz.qtype == "dummy" or qz.fmt is None:
        return qz
    name = qz.fmt.value
    if name.startswith("int"):
        return replace(qz, fmt=ElemFormat.int4)
    if name.startswith("fp8"):
        return replace(qz, fmt=ElemFormat.fp4_e2m1)
    return qz


def _strip_suffix(name: str, suffix: str) -> str:
    return name[: -len(suffix)] if name.endswith(suffix) else name


def register_4_to_8bit(cfg: QuantConfig, layer_names) -> QuantConfig:
    """Promote the weights of the named ops to 8 bits (``<op>.weight``;
    names without "weight" are skipped)."""
    overrides = dict(cfg.overrides)
    for name in layer_names:
        if "weight" not in name:
            continue
        op = _strip_suffix(name, ".weight")
        base = overrides.get(op, cfg.linear)
        overrides[op] = replace(base, weight=_bump_fmt_up(base.weight))
    return replace(cfg, overrides=overrides)


def _act_slot(name: str):
    """(op, slot) of an activation name, ``<op>.input`` or ``<op>.output``;
    None for any other name."""
    if name.endswith(".input"):
        return _strip_suffix(name, ".input"), "act_in"
    if name.endswith(".output"):
        return _strip_suffix(name, ".output"), "act_out"
    return None


def _override_acts(cfg: QuantConfig, layer_names, new) -> QuantConfig:
    overrides = dict(cfg.overrides)
    for name in layer_names:
        found = _act_slot(name)
        if found is None:
            continue
        op, slot = found
        base = overrides.get(op, cfg.matmul if "matmul" in name else cfg.linear)
        overrides[op] = replace(base, **{slot: new(getattr(base, slot))})
    return replace(cfg, overrides=overrides)


def register_8_to_4bit(cfg: QuantConfig, layer_names) -> QuantConfig:
    """Demote the named activations to 4 bits (``<op>.input`` /
    ``<op>.output``; an op whose name holds "matmul" starts from the matmul
    slot)."""
    return _override_acts(cfg, layer_names, _bump_fmt_down)


def register_org_config(cfg: QuantConfig, layer_names) -> QuantConfig:
    """Turn off quantization of the named activations (kept in the model's
    dtype), named as for :func:`register_8_to_4bit`."""
    return _override_acts(cfg, layer_names, lambda q: Quantizer(qtype="dummy"))
