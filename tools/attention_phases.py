"""Where the time of the int8-KV decode attention goes, phase by phase.

    python3 tools/attention_phases.py

Builds ``csrc/decode_attention.cu`` a second time with -DLLMC_CLOCKS
(``tools/phase_stamps.py``: each CTA then stamps its SM, the global timer
at entry and exit, and SM clocks at its phase boundaries), launches B4 at the flagship decode shape
(B=128 KV=8 r=4 D=64 S=256, pos 144) and at the long-window case (B=4,
S=32768, the last position) after an L2 flush, and prints one JSON line
per case: the launch's span on the global timer, the SMs used and the
most CTAs resident on one SM at once, the SM clock, and the mean microseconds of a CTA in each
phase: prologue (q staged, the position read and the token appended —
"to_window" —, the first copies issued, q quantised), Q.K
(of which waiting for chunks), softmax, P.V (of which waiting) and tail.
Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import phase_stamps as ps  # noqa: E402
from llm_compressor_tpu_torch.kernels import decode_attention as da  # noqa: E402

STAMPS = ("sm", "t0", "t1", "entry", "window", "issued", "prologue", "qk", "qk_wait", "softmax",
          "pv", "pv_wait", "end")


def inputs(gen, B, KV=8, r=4, D=64, S=256):
    i8 = lambda *shp: torch.randint(-127, 128, shp, generator=gen, device="cuda",
                                    dtype=torch.int16).to(torch.int8)
    sc = lambda *shp: torch.rand(shp, generator=gen, device="cuda") * 0.02
    q = torch.randn((B, KV, r, D), generator=gen, device="cuda")
    return q, [i8(B, KV, D), i8(B, KV, D), sc(B, KV), sc(B, KV)], \
        [i8(B, KV, S, D), i8(B, KV, S, D), sc(B, KV, S), sc(B, KV, S)]


def run_case(lib, gen, label, B, S, pos):
    q, new, cache = inputs(gen, B, S=S)
    B, KV, r, D = q.shape
    p = da.plan(r, D, S)
    scratch = torch.empty(B * KV * r * S, device="cuda") if p.scratch else None
    posv = torch.full((B,), pos, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    fn = lib.llmc_decode_attention_append
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 + \
        [ctypes.c_int, ctypes.c_void_p]

    def launch():
        err = fn(q.data_ptr(), *(t.data_ptr() for t in new), *(t.data_ptr() for t in cache),
                 posv.data_ptr(), out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
                 B, KV, r, D, S, 0, p.cap, p.smem, 1, D ** -0.5, 0.0, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    ps.stamped_launch(launch)
    col = ps.read(lib, STAMPS, B * KV)
    summary, us = ps.summarize(col)
    return {"case": label, "plan": p._asdict(), **summary,
            "phase_us": {"prologue": us(col["prologue"] - col["entry"]),
                         "of_which_to_window": us(col["window"] - col["entry"]),
                         "of_which_issue": us(col["issued"] - col["window"]),
                         "qk": us(col["qk"] - col["prologue"]), "qk_wait": us(col["qk_wait"]),
                         "softmax": us(col["softmax"] - col["qk"]),
                         "pv": us(col["pv"] - col["softmax"]), "pv_wait": us(col["pv_wait"]),
                         "tail": us(col["end"] - col["pv"])}}


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("attention_phases: needs a CUDA card", file=sys.stderr)
        return 2
    lib = ps.build_stamped("decode_attention")
    print(ps.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, B, S, pos in (("flagship B=128 S=256 pos=144", 128, 256, 144),
                             ("long B=4 S=32768 pos=32767", 4, 32768, 32767)):
        print(json.dumps(run_case(lib, gen, label, B, S, pos)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
