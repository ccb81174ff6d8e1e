"""The traced window: device events and the harness's spans from
``torch.profiler``, the device's busy time, the classes of the port's hand
kernels, and the breakdown a traced result line carries.

The classes are the ten below and one more for each file
``kernel_classes/<name>.json``: ``{"fragment": ..., "class": ...,
"primary": ...}``, a part of the kernel's name as a trace gives it, its
class, and the name part of the first kernel of each counted wrapper call
(null where the fragment's kernels are further launches of a call, as a
split-K reduce is). A file whose fragment would class another class's
kernel is refused when the files are read.
"""

from __future__ import annotations

import contextlib
import functools
import json
import time
from pathlib import Path
from types import MappingProxyType
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch

# a device op whose name holds one of these is a hand kernel of the port
# (csrc/*.cu, with their split-K reduces and B9's quantizer); every other
# device op of a step is PyTorch's
HAND_KERNELS = {
    "w4a8_gateup": "B2",             # w4a8_gateup_kernel and its reduce
    "w4a8_mma_kernel": "B1/B3",
    "w4a8_reduce_kernel": "B1/B3",
    "w4a8_act_quant_kernel": "B9",
    "decode_attention_append": "B4",
    "decode_attention_stats": "B6",
    "decode_attention_kernel": "B7",
    "fresh_write": "B8",
    "dequant_matmul": "B5",          # the kernel and its reduce
    "hadamard": "B10",
}


# the first kernel of each counted wrapper call, as a trace names it (a
# split-K reduce or B9's quantizer is a further launch of the same call)
PRIMARY = ("w4a8_mma_kernel", "w4a8_gateup_kernel", "decode_attention_append_kernel",
           "decode_attention_stats_kernel", "decode_attention_kernel", "fresh_write_kernel",
           "dequant_matmul_kernel", "hadamard_kernel")


CLASS_FILES = Path(__file__).resolve().parent / "kernel_classes"
CLASS_KEYS = ("fragment", "class", "primary")


def _class_in(hand: Mapping[str, str], name: str) -> str:
    for key, cls in hand.items():
        if key in name:
            return cls
    return "glue"


@functools.lru_cache(maxsize=None)
def _classes(directory: Path) -> Tuple[Mapping[str, str], Tuple[str, ...]]:
    hand, primary = dict(HAND_KERNELS), list(PRIMARY)
    for path in sorted(directory.glob("*.json")):
        with open(path) as f:
            d = json.load(f)
        if sorted(d) != sorted(CLASS_KEYS):
            raise ValueError(f"{path.name}: keys {sorted(d)}, not {list(CLASS_KEYS)}")
        frag, cls, first = d["fragment"], d["class"], d["primary"]
        clash = [k for k, c in hand.items() if c != cls and (frag in k or k in frag)]
        clash += [p for p in primary if _class_in(hand, p) != cls and frag in p]
        if not frag or clash:
            raise ValueError(f"{path.name}: fragment {frag!r} matches the kernels of "
                             f"other classes: {clash}")
        hand[frag] = cls
        if first is not None:
            if _class_in(hand, first) != cls:
                raise ValueError(f"{path.name}: primary {first!r} is not of class {cls!r}")
            primary.append(first)
    return MappingProxyType(hand), tuple(primary)


def classes() -> Tuple[Mapping[str, str], Tuple[str, ...]]:
    """(fragment -> class, primary kernels): the ten above and the
    ``kernel_classes/`` files'."""
    return _classes(CLASS_FILES)


def launches(events, of: Optional[Iterable[str]] = None) -> int:
    """Counted wrapper calls that a trace holds: its primary kernels (those
    of the classes ``of`` only, where given)."""
    hand, primary = classes()
    if of is not None:
        want = set(of)
        primary = tuple(p for p in primary if _class_in(hand, p) in want)
    return sum(any(p in name for p in primary) for name, _, _ in events)


def kernel_class(name: str) -> str:
    """The hand kernel a device op belongs to, or "glue"."""
    return _class_in(classes()[0], name)


def union_s(intervals) -> float:
    """Seconds covered by the union of (start_us, end_us) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


@contextlib.contextmanager
def profiled(sync):
    """Profile the block (CPU and CUDA activities). The yielded dict gets
    ``window_s``, the host seconds of the block (ended by a device sync),
    and ``profile``, which :func:`finish` reads once the measured window
    has closed (reading a trace takes seconds)."""
    from torch.profiler import ProfilerActivity, profile

    box: dict = {}
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield box
        sync()
        box["window_s"] = time.perf_counter() - t0
    box["profile"] = prof


def finish(box: dict) -> dict:
    """``events`` [(name, start_us, end_us)] of the device (the harness's
    ranges, which the profiler also marks on the device, left out),
    ``spans`` [(name, start_us, end_us)] of the harness's ``portbench.*``
    ranges on the host, and ``busy_s``, the device's busy seconds, from
    the profile of :func:`profiled`."""
    prof = box.pop("profile", None)
    if prof is None:
        return box
    events, spans = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith("portbench."):
            if e.device_type != torch.autograd.DeviceType.CUDA:
                spans.append((e.name[len("portbench."):], a, b))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            events.append((e.name, a, b))
    box["events"], box["spans"] = events, spans
    box["busy_s"] = union_s((a, b) for _, a, b in events)
    return box


def device_s_by_class(events) -> Dict[str, float]:
    hand = classes()[0]
    out: Dict[str, float] = {}
    for name, a, b in events:
        k = _class_in(hand, name)
        out[k] = out.get(k, 0.0) + (b - a) / 1e6
    return out


def _label(spans, t: float) -> str:
    """The innermost harness span open at ``t`` (us), or "no span"."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "no span"


def breakdown(record: dict, top: int = 10) -> Dict[str, List[Tuple[str, float]]]:
    """The device ops that took most time, and the longest idle gaps
    between device work labelled by what the harness was doing."""
    by_name: Dict[str, float] = {}
    for name, a, b in record["events"]:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], None
    for _, a, b in sorted(record["events"], key=lambda e: e[1]):
        if end is not None and a > end:
            gaps.append((_label(record["spans"], (a + end) / 2), (a - end) / 1e6))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps[:top]]}
