"""Phase stamps of a CUDA kernel, shared by the ``tools/*_phases.py`` scripts.

A source under ``csrc/`` that includes ``phase_stamps.cuh`` records, when
it is built with -DLLMC_CLOCKS, per CTA its SM, the global timer (ns) at
entry and exit, and SM clocks at its phase boundaries, as thread 0 sees
them. :func:`build_stamped` builds that library beside the normal one,
:func:`stamped_launch` launches once to warm up and once after an L2 flush,
:func:`read` fetches that launch's stamps by name and :func:`summarize`
gives what every phases tool prints of them.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llm_compressor_tpu_torch.kernels import _build  # noqa: E402

MAX_STAMPED = 1 << 16  # phase_stamps.cuh
MAX_STAMPS = 16


def build_stamped(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with -DLLMC_CLOCKS, loaded."""
    return ctypes.CDLL(str(_build.build((name,), defines=("LLMC_CLOCKS",))[name]))


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def stamped_launch(launch: Callable[[], None]) -> None:
    """Launch once to warm up, flush the L2 cache, launch the stamped run."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    launch()
    flush.fill_(1)
    torch.cuda.synchronize()
    launch()
    torch.cuda.synchronize()


def read(lib: ctypes.CDLL, names: Sequence[str], ctas: int) -> Dict[str, np.ndarray]:
    """The last launch's stamps of its first ``ctas`` CTAs, by name (the
    names in the order of the source's ``enum Stamp``)."""
    ctas = min(ctas, MAX_STAMPED)
    st = np.zeros((ctas, MAX_STAMPS), np.int64)
    if lib.llmc_stamps(ctypes.c_void_p(st.ctypes.data), ctas):
        raise RuntimeError("reading the stamps failed")
    return {k: st[:, i] for i, k in enumerate(names)}


def summarize(col: Dict[str, np.ndarray]) -> Tuple[dict, Callable[[np.ndarray], float]]:
    """The launch's span on the global timer, the SMs used, the most CTAs
    resident on one SM at once, the mean µs of a CTA and the SM clock; and
    a function from SM cycles per CTA to mean µs."""
    span_ns = col["t1"].max() - col["t0"].min()
    cyc_per_ns = float(np.mean((col["end"] - col["entry"]) / np.maximum(col["t1"] - col["t0"], 1)))
    most, sms = 0, np.unique(col["sm"])
    for sm in sms:  # sweep each SM's entry and exit events
        sel = col["sm"] == sm
        ev = sorted([(t, 1) for t in col["t0"][sel]] + [(t, -1) for t in col["t1"][sel]],
                    key=lambda e: (e[0], e[1]))
        cur = 0
        for _, d in ev:
            cur += d
            most = max(most, cur)
    summary = {"launch_span_us": span_ns / 1e3, "ctas": len(col["sm"]), "sms_used": len(sms),
               "most_ctas_on_one_sm_at_once": most,
               "cta_us": float(np.mean(col["t1"] - col["t0"])) / 1e3, "sm_ghz": cyc_per_ns}
    return summary, lambda cyc: float(np.mean(cyc)) / cyc_per_ns / 1e3
