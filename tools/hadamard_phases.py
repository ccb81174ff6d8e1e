"""Where the time of the fast Hadamard transform (B10) goes, phase by phase.

    python3 tools/hadamard_phases.py

Builds ``csrc/hadamard.cu`` a second time with -DLLMC_CLOCKS
(``tools/phase_stamps.py``: each CTA then stamps its SM, the global timer
at entry and exit, and SM clocks at its phase boundaries), launches B10 at
``chip_smoke.py``'s bf16 cases and the R1 draw after an L2 flush, and
prints one JSON line per case: the launch's span on the global timer, the
SMs used and the most CTAs resident on one SM at once, the SM clock, and
the mean microseconds of a CTA in each phase: pass 1 (loads, register and
shuffle stages, the row into shared memory), the barrier after it, pass 2
with its barrier (two-pass rows), and the end (the 16-byte stores, or the
H_K contraction). Needs one card.
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
from llm_compressor_tpu_torch.kernels import hadamard as hd  # noqa: E402

STAMPS = ("sm", "t0", "t1", "entry", "pass1", "sync1", "pass2", "end")


def run_case(lib, gen, label, rows, n, dtype, diagonal=False):
    if diagonal:
        x = torch.diag(torch.randint(0, 2, (n,), generator=gen, device="cuda").float() * 2 - 1)
        x = x.to(dtype)
    else:
        x = torch.randn((rows, n), generator=gen, device="cuda").to(dtype)
    p = hd.plan(n)
    out = torch.empty_like(x)
    signs = hd._signs(p.K, x.device) if p.K > 1 else None
    fn = lib.llmc_hadamard
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int,
                                                                  ctypes.c_void_p]

    def launch():
        err = fn(x.data_ptr(), out.data_ptr(), None if signs is None else signs.data_ptr(),
                 rows, n, p.m, p.K, p.E, p.threads, p.rows, p.passes, p.smem, 1,
                 hd.default_scale(n), 0 if dtype == torch.float32 else 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    launch()
    if not torch.equal(out, hd.hadamard_transform_plain(x)):
        raise AssertionError(f"{label}: the stamped build disagrees with the plain version")
    ps.stamped_launch(launch)
    col = ps.read(lib, STAMPS, -(-rows // p.rows))
    summary, us = ps.summarize(col)
    two = p.passes == 2
    return {"case": label, "plan": p._asdict(), **summary,
            "phase_us": {"pass1": us(col["pass1"] - col["entry"]),
                         "barrier": us(col["sync1"] - col["pass1"]),
                         "pass2": us(col["pass2"] - col["sync1"]) if two else 0.0,
                         "end": us(col["end"] - col["pass2"])}}


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("hadamard_phases: needs a CUDA card", file=sys.stderr)
        return 2
    lib = ps.build_stamped("hadamard")
    print(ps.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for args in (("R1 draw: +-1 diagonal 2048 f32", 2048, 2048, torch.float32, True),
                 ("4096 x 2048 bf16", 4096, 2048, torch.bfloat16),
                 ("4096 x 8192 bf16", 4096, 8192, torch.bfloat16),
                 ("4096 x 2560 bf16 (K = 20)", 4096, 2560, torch.bfloat16)):
        print(json.dumps(run_case(lib, gen, *args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
