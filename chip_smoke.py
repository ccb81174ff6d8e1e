"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed 0]

Phases (each prints a line; any failure exits non-zero):
1. device — card name, count, and nvidia-smi's name and power limit;
2. build — compile every kernel of ``llm_compressor_tpu_torch/csrc`` (one
   nvcc per source, all at once) and print ptxas register / smem use;
3. kernels — each of the ten kernels against its plain PyTorch version on
   the card at the flagship shapes, with its device time (CUDA events, L2
   flushed before each launch, host work queued ahead of the window), the
   plain version's time, one PyTorch library call's time for the same
   function, and the bound: max(bytes / 3.35 TB/s, ops / the peak of the
   kernel's own arithmetic) from the published H100 SXM peaks — int8 at
   1979 TOP/s for B1-B4 and B6-B9, dense bf16 at 989.4 TFLOP/s for B5,
   float32 outside the tensor cores at 67 TFLOP/s for B10; bytes count the
   rows this run's masks keep. Each B1, B2, B3, B5 and B9 case also gives
   the K-splits and CTAs of the grid its wrapper launched and the split-K
   reduce kernel's share of its time (``torch.profiler``); B1 and B3 must
   equal their plain version summed in the launched splits bitwise, B2 to
   one bf16 ulp (its f32 activation), and two launches must give the same
   bits; B9 gives its act quantizer's share and B3's time on
   host-quantised acts; a log line adds the earlier design's time, a
   constant with its source. B2 runs the decode and the prefill gate|up,
   B3 the int8 head and the prefill qkv and o projections (M = 16384);
   B4, B6 and B7 also run a long window: 4 slots over a cache of 32K rows
   at its last position (the first design could not launch it). An empty
   launch (``torch.cuda._sleep(0)``) is timed the same way, the launch
   floor, and printed beside B8 and the R2 draw of B10;
4. token checks — at 2 layers, full width, the kernel path's greedy tokens
   must equal the plain path's wherever the plain logits' top-2 gap exceeds
   the stated tolerance: W4A8 (in-place B4 decode, and the side-block
   "two_part" and "hybrid" decodes, which also count their agreement with
   the B4 path's tokens and merged cache codes), weight-only with
   zero-point int4 and with fp8 e4m3 weights, and the SpinQuant-Hadamard +
   GPTQ pipeline (calibrated once on each path, B10 or its plain version
   drawing the rotations, then served W4A8); that pipeline's layer 0 must
   then beat RTN on every linear, ||(W - Q) X||_F on its own calibration
   inputs at most 0.9 x RTN's (GPTQ without its error feedback would give
   1.0). Then ``prefill`` of the 2-layer weight-only zp-int4 model runs
   twice on the same tokens, once with bf16 reduced-precision reduction
   allowed and once as it runs, under ``full_f32_accumulation``: how many
   logits and argmax tokens differ is reported, and fails nothing;
5. slices — full-width, full-depth Llama-3.2-1B (random weights from
   ``--seed``): RTN -> pack -> fuse -> stack, prefill 128 prompts of 128
   tokens into a cache of 256 positions, then 32 greedy decode steps as
   one CUDA graph (``engine/graph.py``), for two serving configs: W4A8 over
   an int8 cache (B1-B4), and weight-only zero-point int4-g128 with an
   int8-g128 head over a bf16 cache (B5, 65 launches per decode step). The
   W4A8 params, each time after a fresh prefill, also decode in the
   side-block modes: ``w4a8_two_part`` (B7 and B8, 16 each per step) and
   ``w4a8_hybrid`` (B6 and B8); every W4A8 slice must launch 48 B1, 16 B2
   and 1 B3 per step, and ``w4a8`` 16 B4 and none of B6-B8. With the
   counts set to 0 just before, each slice prefills (TTFT) and decodes
   three times from that prefilled state on one cache (counts read just
   after; each of its kernels must have launched): the first call runs
   eagerly (its seconds), the second captures the graph (its seconds),
   the third replays it (decode tok/s, launches per step). The eager loop
   then decodes from a copy of the same prefilled cache (its tok/s):
   tokens, int8 cache codes, scales and lengths of all three calls must
   equal its own bitwise, and their launches its launches. One more
   replay runs under ``torch.profiler`` for the device time by kernel and
   the idle share, and its traced launches of each kernel must equal what
   the replay added to the counters;
   for ``w4a8``, one more prefill too, its device time by kernel family
   (B2, B3, attention, bf16 matmul, other). The
   weight-only params then repeat the prefill
   comparison above at full depth (TTFT both ways, reported), and serve one
   ``generate`` call with top-k sampling from a fixed seed, twice, which
   must agree.
   The third slice, ``spinquant_gptq``, calibrates the model instead of
   RTN: ``spinquant(mode="hadamard")`` on 128 x 512 synthetic tokens (17 B10
   launches and no other kernel; seconds by phase, peak memory), packs it
   losslessly with GPTQ's scale book (bitwise against the GPTQ'd weights),
   checks that its layer 0 equals the 2-layer run's bitwise, and serves it
   W4A8 as above (B1-B4, no B10).
6. B9 entry point — ``w4a8_matmul(..., act_inside=True)`` on the ``w4a8``
   slice's int8-g128 head and layer-0 qkv at M = 128 (counts set to 0 just
   before); each output must equal the host-quantised B3 path's bitwise.
7. checkpoint — Llama-3.2-1B at full depth, random weights from
   ``--seed``: written as an HF directory (``config.json``, bf16
   ``model.safetensors``) and read back by ``load_hf_checkpoint``
   (bitwise), RTN W4A8 as in step 5, served (16 prompts of 32 tokens, 8
   greedy steps, int8 cache: B1-B4, counts set to 0 just before and the
   per-step launches asserted); ``save_compressed`` -> ``load_compressed``
   -> ``pack_model`` (the tied head, which is not written) must give every
   QTensor bitwise, then the same tokens, cache codes and scales bitwise;
   ``generate_text`` (chat template, a byte-level stand-in tokenizer) must
   give ``generate``'s new ids. Seconds of each save and load, bytes on
   disk, peak memory; both directories live under ``$TMPDIR`` and are
   removed.
8. serving_engine — on the ``w4a8`` slice's params (it runs after phase 6,
   before the weight-only slice), full width and depth, int8 KV cache
   (B1-B4): continuous batching, 32 slots, ``max_len`` 512, chunks of 128,
   96 requests with prompts of 16-384 tokens from ``--seed``, 32 greedy
   new tokens each, one request ending on an EOS id that it reaches; the
   decode step as one CUDA graph and eagerly: ids bitwise equal, launches
   as the steps and chunks ask; requests/s, tok/s, ms per decode step and
   per chunk prefill, peak memory, and how many of 8 requests equal
   ``generate`` alone. Then speculative decoding: 16 prompts, a 16-token
   motif from ``--seed`` repeated 8 times, k_draft 4, 8 rounds a dispatch,
   64 new tokens: three dispatches of rounds through the graph path
   (eager, capture, replay) and eagerly, history, accept counts and cache
   bitwise equal after each; ``generate_speculative`` with
   ``accept_floor=0``, one call with graphs and one eager (ids and stats
   equal; tok/s and added peak memory of each) against greedy decode of
   the same prompts (tok/s at its first call, eager, and replayed; tokens
   that agree); then random prompts with the default floor and with a
   floor above k_draft, which must fall back. The 8 ``generate`` calls are
   each timed with the graph and with ``graph=False`` (ids equal).
9. formats — the rest of the quantizer formats, after the checkpoint
   phase. At 2 layers, full width: ``mxfp8_weight_only``'s kernel path
   against its plain path (tokens as in step 4), and ``nvfp4_w4a4``
   packed against the same RTN output kept as fake-quantized dense
   weights, prefill and 8 teacher-forced decode steps under
   ``full_f32_accumulation`` (tokens equal where the fake model's top-2
   gap > 0.1, logits within 0.05 relative L2 at every step). Then four
   slices at full width and depth, served as in step 5 (TTFT, graph and
   eager-loop tok/s, bitwise equal, device busy and idle, launches per
   step asserted), each RTN'd with a scale book (seconds, peak memory)
   and packed losslessly (``dequantize`` equal to RTN's weights bitwise on
   every linear; the head, which has no book entry, packs again, and its
   largest difference is printed): ``w4a8_mse`` (the flagship with
   ``w_mse=True`` and ``rtn(mse=True)``; B1-B4; layer 0's MSE objective
   per group never above plain RTN's, and ||W - Q|| against RTN's by
   linear), ``mxfp8_weight_only`` (B5's fp8 body, 65 a step),
   ``nvfp4_w4a4`` (NVFP4 weights and acts on every linear and on the
   attention matmuls, dequantize-then-matmul; B5 for the int8 head, 1 a
   step) and ``mpq_w4a8`` (layers 0 and 15 promoted to int8 weights by
   ``register_4_to_8bit``, served unstacked: B3 on every projection, 65 a
   step, and 16 B4).
10. archs — the other architectures, after the formats phase, each from
   its published config.json (``ARCH_CONFIGS``) through
   ``from_hf_config``, random bf16 weights from ``--seed``, W4A8 as in
   step 5. ``gemma2_2b_w4a8``: Gemma-2-2B at full width and depth (26
   layers, 8 / 4 heads, head_dim 256, windows of 4096 on even layers,
   softcaps 50 and 30, gelu-tanh), served as the slices of step 5 (78 B1,
   26 B2, 1 B3 and 26 B4 a step asserted, equal to the replay's trace).
   The window check, Gemma-2-2B at 2 layers: 4 slots, prompts of 4064
   tokens, 64 steps over a cache of 4224 rows, so layer 0's window drops
   keys from position 4096 on; kernel path against plain path in the
   three decode modes (tokens as in step 4); then the kernel path without
   the window, fed the same tokens, must give the windowed logits bitwise
   before position 4096 and other logits from there on. The families at 2
   layers of their published widths (Qwen2.5-1.5B with q/k/v biases,
   Qwen3-1.7B with q/k norms, Gemma-2B at r = 8, Gemma-3-1B with group-
   half int4 weights, a window of 512 and a local rope theta, its prompt
   past the window): kernel path against plain path, and graph and eager
   decode bitwise equal (``run_slice``). Step 3 adds the kernels at
   Gemma's shapes: B1 qkv 4096 x 2304, B2 gelu-tanh 2·9216 x 2304, B3
   head 256000 x 2304, B4 at D = 256 (r = 2 with softcap 50, window 0
   and 4096; r = 8), B6 and B7 at r = 2, D = 256 with a window.
11. archs_b — OPT, BLOOM and Phi, after the archs phase, the same way.
   ``phi_2_w4a8``: Phi-2 at full width and depth (32 layers, 32 / 32
   heads, head_dim 80, partial rotary 0.4, an untied head with its bias),
   served as the slices of step 5 (128 B1, 1 B3 and 32 B4 at r = 1, D = 80
   a step asserted, equal to the replay's trace). The families at 2
   layers of their published widths, in the three decode modes: kernel
   path against plain path (tokens as in step 4) and graph decode bitwise
   equal to the eager loop, each replay launching its mode's kernels:
   OPT-1.3B (its query pre-scaled, scale 1.0 into B4, B7, B6 at r = 1,
   D = 64; its 50272-row head, which neither B3 nor B5 takes, runs
   dequantize + matmul and is timed), OPT-350m (project_in / project_out,
   post-norm), BLOOM-560m (ALiBi: the float attention path in every mode,
   so its modes decode alike and are checked against plain once; fused
   qkv on B1, a 250880-row head on B3), Phi-2 (B7 and B6 at D = 80). Step
   3 adds the kernels at Phi-2's shapes: B1 qkv 7680 x 2560, o, fc1 10240
   x 2560, fc2 2560 x 10240, B3 head 51200 x 2560, B4 at r = 1, D = 80 and
   D = 64 with scale 1.0, B6 and B7 at r = 1, D = 80.
12. calibration_b — the calibration and pruning algorithms, after the
   archs_b phase. ``wanda_awq_w4a8``: Llama-3.2-1B at full width and depth
   (random weights from ``--seed``) in the CLI's order: ``wanda(0.5)`` on
   128 x 512 synthetic C4 tokens (seed + 2000), then ``awq`` W4A8 with a
   scale book on the pile-val stream (seed + 1000), ``pack_model`` with the
   book, fuse, stack; served as the slices of step 5 (48 B1, 16 B2, 1 B3
   and 16 B4 a step asserted, equal to the replay's trace). Wanda's and
   AWQ's seconds (AWQ's by ``PhaseTimer`` phase: taps, scale search, clip
   search, rtn) and peak memory. It fails unless every linear is at least
   50 % zeros after Wanda, every packed code at a position Wanda zeroed is
   the zero code, packing is lossless against AWQ's RTN output on every
   linear, every scale search's best loss is at most its loss at ratio 0
   (s = 1, plain RTN) and every clip group's chosen error at most its
   unclipped error, and the calibration launched no kernel. Then at 2
   layers, full width, 128 x 512 tokens of each algorithm's corpus, each
   with its seconds and peak memory, packed losslessly with its scale book
   and served W4A8, kernel path against plain path (tokens as in step 4,
   ``check_reduced_depth(build=...)``): ``smoothquant`` (alpha 0.8) on
   Llama and on BLOOM-560m (B1, B3: ALiBi keeps its attention off the
   kernels), ``awq_plus``, ``gptaq`` (layer 0's ||(W - Q)X||_F over RTN's,
   beside GPTQ's on the same weights: reported), and ``sparsegpt``, ``ria``
   and ``magnitude`` at 0.5 sparsity (checked), each followed by RTN.
The ``kernels`` JSON object, nvidia-smi's name and power limit and the
slices' and serving engine's numbers (TTFT, decode tok/s over the graph,
first-call and capture seconds, the eager loop's tok/s, peak memory; calibration seconds
for ``spinquant_gptq``, RTN seconds for the formats slices; the formats phase's 2-layer
checks; the archs, archs_b and calibration_b phases' checks; Wanda's and
AWQ's seconds for ``wanda_awq_w4a8``) come on the three lines before the
last; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak, same source
BF16_OPS_PER_S = 989.4e12      # dense bf16 tensor-core peak, same source
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores, same source
# the slices: Llama-3.2-1B at full depth, the serving shape of the flagship bench
LAYERS, BATCH, PROMPT, MAX_LEN, STEPS = 16, 128, 128, 256, 32
# serving configs: build_quant_config arguments, head_act, an int8 KV cache?
W4A8 = (("int4-g[128]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw"), "int8-g[-1]-rw", True)
WEIGHT_ONLY = (("int4-g[128]-zp-rw", None, None, "int8-g[128]-rw"), None, False)
WEIGHT_ONLY_FP8 = (("fp8_e4m3-g[128]-rw", None, None, "int8-g[128]-rw"), None, False)
B5_PER_STEP = 4 * LAYERS + 1   # qkv, o, gate|up, down per layer + the head
_JAX_KERNELS = "llm_compressor_tpu/kernels/"
_CSRC = "llm_compressor_tpu_torch/csrc/"
# name: (TPU kernel it replaces, CUDA source, launch counter), in table order
KERNELS = {
    "B1_w4a8_stacked": ("w4a8_matmul.py:405", "w4a8_matmul.cu", "w4a8_stacked"),
    "B2_w4a8_gateup_silu": ("w4a8_matmul.py:517", "w4a8_matmul.cu", "w4a8_gateup"),
    "B3_w4a8_flat": ("w4a8_matmul.py:353", "w4a8_matmul.cu", "w4a8_flat"),
    "B4_decode_attention_append": ("decode_attention.py:469", "decode_attention.cu",
                                   "decode_attention_append"),
    "B5_dequant_matmul": ("dequant_matmul.py:216", "dequant_matmul.cu", "dequant_matmul"),
    "B6_decode_attention_stats": ("decode_attention.py:225", "decode_attention.cu",
                                  "decode_attention_stats"),
    "B7_decode_attention": ("decode_attention.py:605", "decode_attention.cu",
                            "decode_attention"),
    "B8_fresh_write": ("decode_attention.py:308", "decode_attention.cu", "fresh_write"),
    "B9_w4a8_actq": ("w4a8_matmul.py:621", "w4a8_matmul.cu", "w4a8_actq"),
    "B10_hadamard": ("hadamard.py:271", "hadamard.cu", "hadamard"),
}
TPU_KERNELS = {k: _JAX_KERNELS + v[0] for k, v in KERNELS.items()}
SOURCES = {k: _CSRC + v[1] for k, v in KERNELS.items()}
COUNTER_OF = {k: v[2] for k, v in KERNELS.items()}
# the run whose launch count the kernels line reports: (slice or phase, field)
SLICE_OF = {k: ("w4a8", "counts") for k in TPU_KERNELS} | {
    "B5_dequant_matmul": ("weight_only", "counts"),
    "B6_decode_attention_stats": ("w4a8_hybrid", "counts"),
    "B7_decode_attention": ("w4a8_two_part", "counts"),
    "B8_fresh_write": ("w4a8_two_part", "counts"),
    "B9_w4a8_actq": ("actq_entry", "counts"),
    "B10_hadamard": ("spinquant_gptq", "calib_counts")}
LAUNCHES_FROM = {
    "w4a8": "slice w4a8: prefill + 3 calls of 32 decode steps (eager, capture, replay)",
    "weight_only": "slice weight_only: prefill + 3 calls of 32 decode steps",
    "w4a8_hybrid": "slice w4a8_hybrid: prefill + 3 calls of 32 decode steps",
    "w4a8_two_part": "slice w4a8_two_part: prefill + 3 calls of 32 decode steps",
    "actq_entry": "entry point w4a8_matmul(..., act_inside=True): the w4a8 slice's int8 "
                  "head and layer-0 qkv, M = 128",
    "spinquant_gptq": "slice spinquant_gptq: calibration"}
W4A8_MATMULS = ["B1_w4a8_stacked", "B2_w4a8_gateup_silu", "B3_w4a8_flat"]
W4A8_KERNELS = W4A8_MATMULS + ["B4_decode_attention_append"]
# decode attention of the W4A8 slices: mode, its kernels, their launches per step
SIDE_KERNELS = {"two_part": ["B7_decode_attention", "B8_fresh_write"],
                "hybrid": ["B6_decode_attention_stats", "B8_fresh_write"]}
W4A8_PER_STEP = {"w4a8_stacked": 3 * LAYERS, "w4a8_gateup": LAYERS, "w4a8_flat": 1}
W4A8_APPEND_PER_STEP = W4A8_PER_STEP | {"decode_attention_append": LAYERS}
# the long-window case of B4, B6 and B7: a cache of 32K rows (4 slots),
# its last position attending to the whole window
LONG_S = 32768
# SpinQuant + GPTQ calibration: the CLI's defaults (samples x tokens)
CALIB_SAMPLES, CALIB_LEN = 128, 512
# B10 launches while calibrating: R1, then one R2 per layer
B10_PER_CALIBRATION = 1 + LAYERS
# per-case fields beyond the contract's: B9's B3 time and its act quantizer's
# share, the launched grid of B1, B2, B3, B5 and B9 and their reduce kernel's
# share; then the earlier design's time, a constant, on the log line only
EXTRA_METRICS = ("b3_ms", "quant_ms", "splits", "ctas", "reduce_ms", "launch_floor_ms")
LOG_ONLY = ("earlier_ms",)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_FLUSH = None
_SPIN_CYCLES = 1 << 20   # ~0.5 ms at the H100's clock; doubled where too short


def time_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call,
    with the 50 MB L2 cache overwritten before each call (a decode step
    finds each layer's weights cold).

    A spin kernel is queued between the flush and the start event, so the
    host has queued all of ``fn``'s launches (wrapper checks, allocation,
    ctypes call) while the card spins: the window holds device work only.
    A call whose start event has already passed when ``fn`` returns on the
    host is not counted; it runs again with a spin twice as long."""
    global _FLUSH, _SPIN_CYCLES
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    while len(times) < reps:
        _FLUSH.fill_(1)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        if a.query():  # the spin ended before the host had queued fn
            b.synchronize()
            if _SPIN_CYCLES >= 1 << 32:
                raise RuntimeError("time_ms: the host cannot queue fn within a 2 s spin")
            _SPIN_CYCLES *= 2
            continue
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, ops: float, ops_per_s: float):
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the peak of their type, and which bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the flagship shapes
# ---------------------------------------------------------------------------


def _rand_codes(gen, shape, wfmt):
    if wfmt == 0:
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int16).to(torch.int8)
    # int4: random biased nibbles 1..15 in both halves of every byte
    lo = torch.randint(1, 16, shape, generator=gen, device="cuda", dtype=torch.int16)
    hi = torch.randint(1, 16, shape, generator=gen, device="cuda", dtype=torch.int16)
    return (lo | (hi << 4)).to(torch.uint8)


# B1, B2, B3 and B9 before the tensor-core redesign (the dp4a design), ms,
# measured by this script on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md
# section 6; the prefill gate|up on the last tree that had the dp4a B2)
W4A8_EARLIER_MS = {"decode qkv": 0.0597, "decode o": 0.0595, "decode down": 0.2286,
                   "decode gate|up": 0.1246, "prefill gate|up 128x128 rows": 13.1083,
                   "decode int8 head": 0.7504, "prefill qkv 128x128 rows": 2.4344,
                   "int8 head, raw bf16 acts": 2.7975,
                   "flat qkv int4-g128 pair planes, raw bf16 acts": 0.0966}


def _grid_fields(wrapper, run, label, reduce="w4a8_reduce"):
    """The launched grid (splits, CTAs), the split-K reduce kernel's share
    of the time and the earlier design's time (log line only)."""
    tiles_n, tiles_m, splits = wrapper.last_grid
    out = {"splits": splits, "ctas": tiles_n * tiles_m * splits,
           "reduce_ms": _profiled_ms(run, reduce)}
    if label in W4A8_EARLIER_MS:
        out["earlier_ms"] = W4A8_EARLIER_MS[label]
    return out


def check_w4a8(gen, label, kind, M, N, C, wfmt, act="silu"):
    """One W4A8 case; ``kind`` is 'stacked', 'flat' or 'gateup' (N = 2I,
    activation ``act``).
    Each is held against the plain version summed in the splits the
    wrapper launched: B1 and B3 bitwise, B2 to one bf16 ulp (its f32
    activation); two launches must give the same bits."""
    from llm_compressor_tpu_torch.kernels import w4a8_matmul as wm

    G = C // 128
    L = 2 if kind != "flat" else 1
    cb = C if wfmt == 0 else C // 2
    codes = _rand_codes(gen, (L, N, cb), wfmt)
    scales = torch.rand((L, N, G), generator=gen, device="cuda") * 1e-2 + 1e-3
    x = torch.randn((M, C), generator=gen, device="cuda").to(torch.bfloat16)
    x_i8, sx = wm.quantize_acts_per_token(x)
    bf = torch.bfloat16
    if kind == "stacked":
        wrapper = wm.matmul_stacked
        run = lambda: wm.matmul_stacked(x_i8, codes, scales, sx, 1, wfmt, bf)
        plain = lambda: wm.w4a8_plain(x_i8, codes[1], scales[1], sx, wfmt, bf,
                                      splits=wrapper.last_grid[2])
        n_out = N
    elif kind == "flat":
        wrapper = wm.matmul_flat
        c0, s0 = codes[0], scales[0]
        run = lambda: wm.matmul_flat(x_i8, c0, s0, sx, wfmt, bf)
        plain = lambda: wm.w4a8_plain(x_i8, c0, s0, sx, wfmt, bf, splits=wrapper.last_grid[2])
        n_out = N
    else:
        wrapper = wm.gateup_silu
        run = lambda: wm.gateup_silu(x_i8, codes, scales, sx, 1, wfmt, act, bf)
        plain = lambda: wm.gateup_plain(x_i8, codes[1], scales[1], sx, wfmt, act, bf,
                                        splits=wrapper.last_grid[2])
        n_out = N // 2
    got = run()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if kind == "gateup":
        # f32 activation epilogue: expf and torch's exp may round one bf16
        # ulp apart
        ok = bool((err <= want.float().abs() * 2.0 ** -7 + 1e-6).all())
        tol = "1 bf16 ulp at the launched split count; bitwise launch to launch"
    else:
        ok = bool((err == 0).all())
        tol = "bitwise at the launched split count; bitwise launch to launch"
    if ok and not torch.equal(run(), got):
        raise AssertionError(f"{label}: two launches on the same inputs differ")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with plain (max err {float(err.max())})")
    wbytes = codes[0].numel() + scales[0].numel() * 4
    nbytes = x_i8.numel() + sx.numel() * 4 + wbytes + M * n_out * 2
    ops = 2.0 * M * N * C
    b_ms, b_by = bound(nbytes, ops, INT8_OPS_PER_S)
    w_bf = torch.randn((N, C), generator=gen, device="cuda").to(bf)
    case = {
        "case": label, "M": M, "N": N, "C": C, "tolerance": tol,
        "max_abs_err": float(err.max()),
        "ms": time_ms(run), "plain_ms": time_ms(plain, reps=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.matmul(x, w_bf.t())),
    }
    case.update(_grid_fields(wrapper, run, label,
                             "w4a8_gateup_reduce" if kind == "gateup" else "w4a8_reduce"))
    del codes, scales, w_bf
    return case


def check_decode_attention(gen, B=128, KV=8, r=4, D=64, S=256, pos=144, window=0,
                           softcap=None, scale=None):
    """One B4 case (``scale`` D ** -0.5 unless given: OPT's pre-scaled
    query takes 1.0)."""
    from llm_compressor_tpu_torch.kernels import decode_attention as da

    q = torch.randn((B, KV, r, D), generator=gen, device="cuda")
    kc = torch.randint(-127, 128, (B, KV, S, D), generator=gen, device="cuda",
                       dtype=torch.int16).to(torch.int8)
    vc = torch.randint(-127, 128, (B, KV, S, D), generator=gen, device="cuda",
                       dtype=torch.int16).to(torch.int8)
    ks = torch.rand((B, KV, S), generator=gen, device="cuda") * 0.02
    vs = torch.rand((B, KV, S), generator=gen, device="cuda") * 0.02
    nk, nv = kc[:, :, 0].clone(), vc[:, :, 1].clone()
    nks, nvs = ks[:, :, 0].clone(), vs[:, :, 1].clone()
    p = torch.full((B,), pos, dtype=torch.int32, device="cuda")
    label_scale = "" if scale is None else f" scale={scale}"
    scale = D ** -0.5 if scale is None else scale
    bufs = [t.clone() for t in (kc, vc, ks, vs)]
    kw = dict(window=window, scale=scale, softcap=softcap)
    got = da.decode_attention_append(q, nk, nv, nks, nvs, *bufs, p, **kw)
    ref_bufs = [t.clone() for t in (kc, vc, ks, vs)]
    want = da.decode_attention_append_plain(q, nk, nv, nks, nvs, *ref_bufs, p, **kw)
    torch.cuda.synchronize()
    for a, b in zip(bufs, ref_bufs):
        if not torch.equal(a, b):
            raise AssertionError("B4: written cache differs from the plain version")
    err = (got - want).abs()
    ulps = 4 * torch.finfo(torch.float32).eps * want.abs() + 1e-7
    flip = float(vs.max())  # one flipped prob code moves an output by <= max v_scale
    if not bool((err <= ulps + flip).all()) or float((err > ulps).float().mean()) > 0.01:
        raise AssertionError(f"B4: kernel disagrees with plain (max err {float(err.max())})")
    n = pos + 1 if window <= 0 else min(pos + 1, window)   # kept rows of a slot
    nbytes = (q.numel() * 4 + 2 * B * KV * (D + 4)          # q, new token
              + 2 * B * KV * n * (D + 4)                   # K/V window codes + scales
              + 2 * B * KV * (D + 4) + got.numel() * 4)    # token written, out
    ops = 2.0 * 2 * B * KV * r * n * D
    b_ms, b_by = bound(nbytes, ops, INT8_OPS_PER_S)
    kd = (kc.float() * ks[..., None]).to(torch.bfloat16)   # dequantized (B, KV, S, D)
    vd = (vc.float() * vs[..., None]).to(torch.bfloat16)
    qh = q.reshape(B, KV * r, 1, D).to(torch.bfloat16)
    s_ids = torch.arange(S, device="cuda")
    mask = ((s_ids <= pos) & ((window <= 0) | (s_ids > pos - window)))[None, None, None, :]
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=mask, enable_gqa=True)
    run = lambda: da.decode_attention_append(q, nk, nv, nks, nvs, *bufs, p, **kw)
    plain = lambda: da.decode_attention_append_plain(q, nk, nv, nks, nvs, *ref_bufs, p, **kw)
    cap = "" if softcap is None else f" softcap={softcap}"
    win = "" if window <= 0 else f" window={window}"
    return {"case": f"decode B={B} KV={KV} r={r} D={D} S={S} pos={pos}{win}{cap}{label_scale}",
            "tolerance": "codes bitwise; f32 ulps + one prob code on <= 1% of outputs",
            "max_abs_err": float(err.max()), "ms": time_ms(run),
            "plain_ms": time_ms(plain, reps=3, warmup=1), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": time_ms(lib)}


# B4, B6 and B7 in their first design (shared memory growing with S, dp4a
# scores and a serial byte-load P.V), ms, measured by this script on the
# parent tree of the redesign, NVIDIA H100 80GB HBM3, 700.00 W (PERF.md
# section 6, PR 9); the long-window cases did not launch then
ATTENTION_EARLIER_MS = {
    "decode B=128 KV=8 r=4 D=64 S=256 pos=144": 0.0408,
    "main part B=128 KV=8 r=4 D=64 S=256 len0=128 t=16": 0.0320,
    "main part B=128 KV=8 r=4 D=64 S=256 len0=128 t=16 window=64 softcap=50.0": 0.0206,
    "two-part B=128 KV=8 r=4 D=64 S=256 len0=128 t=16 W=32": 0.0406,
    "two-part B=128 KV=8 r=4 D=64 S=256 len0=128 no side block": 0.0335,
    "two-part B=128 KV=8 r=4 D=64 S=256 len0=128 t=16 W=32 window=64 softcap=50.0": 0.0288}


def _attention_inputs(gen, B, KV, r, D, S, W):
    i8 = lambda *shp: torch.randint(-127, 128, shp, generator=gen, device="cuda",
                                    dtype=torch.int16).to(torch.int8)
    sc = lambda *shp: torch.rand(shp, generator=gen, device="cuda") * 0.02
    q = torch.randn((B, KV, r, D), generator=gen, device="cuda")
    return q, (i8(B, KV, S, D), i8(B, KV, S, D), sc(B, KV, S), sc(B, KV, S)), \
        (i8(B, KV, W, D), i8(B, KV, W, D), sc(B, KV, W), sc(B, KV, W))


def _attention_close(got, want, vmax, label):
    err = (got - want).abs()
    ulps = 4 * torch.finfo(torch.float32).eps * want.abs() + 1e-7
    if not bool((err <= ulps + vmax).all()) or float((err > ulps).float().mean()) > 0.01:
        raise AssertionError(f"{label}: kernel disagrees with plain (max err {float(err.max())})")
    return float(err.max())


def _sdpa_yardstick(q, parts, keep):
    """One SDPA call on the dequantized bf16 K/V of ``parts`` (concatenated
    along the sequence) under the kept-lane mask ``keep`` (B, S_total)."""
    B, KV, r, D = q.shape
    kd = torch.cat([(k.float() * ks[..., None]).to(torch.bfloat16) for k, _, ks, _ in parts], 2)
    vd = torch.cat([(v.float() * vs[..., None]).to(torch.bfloat16) for _, v, _, vs in parts], 2)
    qh = q.reshape(B, KV * r, 1, D).to(torch.bfloat16)
    mask = keep[:, None, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=mask, enable_gqa=True)


def check_two_part(gen, side: bool, window=0, softcap=None, B=128, KV=8, r=4, D=64, S=256,
                   len0=128, t=16, W=32):
    """One B7 case: slots with ``len0`` main rows, the step-``t`` side block
    of W lanes (or none), position len0 + t. Tolerance as B4's."""
    from llm_compressor_tpu_torch.kernels import decode_attention as da

    q, main, fresh = _attention_inputs(gen, B, KV, r, D, S, W)
    mlen = torch.full((B,), len0, dtype=torch.int32, device="cuda")
    pos = mlen + t
    fr = fresh if side else None
    scale = D ** -0.5
    run = lambda: da.decode_attention(q, *main, mlen, pos, window, t, fr, scale=scale,
                                      softcap=softcap)
    plain = lambda: da.decode_attention_plain(q, *main, mlen, pos, window, t, fr, scale=scale,
                                              softcap=softcap)
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = _attention_close(got, want, float(max(main[3].max(), fresh[3].max())), "B7")
    keep = da._keep_main(S, mlen, pos, window)
    parts = [main]
    if side:
        keep = torch.cat([keep, da._keep_side(W, mlen, pos, window, t)], 1)
        parts.append(fresh)
    n = int(keep.sum())                              # kept rows of all slots
    nbytes = q.numel() * 4 + 2 * B * 4 + 2 * KV * n * (D + 4) + got.numel() * 4
    b_ms, b_by = bound(nbytes, 2.0 * 2 * KV * r * n * D, INT8_OPS_PER_S)
    cap = "" if softcap is None else f" softcap={softcap}"
    win = "" if window <= 0 else f" window={window}"
    return {"case": (f"two-part B={B} KV={KV} r={r} D={D} S={S} len0={len0} "
                     + (f"t={t} W={W}" if side else "no side block") + win + cap),
            "tolerance": "f32 ulps + one prob code on <= 1% of outputs",
            "max_abs_err": err, "ms": time_ms(run), "plain_ms": time_ms(plain, reps=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(_sdpa_yardstick(q, parts, keep))}


def check_stats(gen, window=0, softcap=None, B=128, KV=8, r=4, D=64, S=256, len0=128, t=16,
                W=32):
    """One B6 case on the side statistics of a real side block (as the
    hybrid decode computes them). Tolerance: m, a, sum_main to rtol 1e-5;
    o32 equal but for flipped prob codes on at most 1 % of entries."""
    from llm_compressor_tpu_torch.kernels import decode_attention as da

    q, main, fresh = _attention_inputs(gen, B, KV, r, D, S, W)
    mlen = torch.full((B,), len0, dtype=torch.int32, device="cuda")
    pos = mlen + t
    scale = D ** -0.5
    qi, qs = da.row_quant_i8(q)
    s_f = da._masked(da._scores(qi, qs, fresh[0], fresh[2], scale, softcap),
                     da._keep_side(W, mlen, pos, window, t))
    m_f = torch.amax(s_f, -1, keepdim=True)
    wfm = torch.amax(torch.exp(s_f - m_f) * fresh[3][:, :, None, :], -1, keepdim=True)
    run = lambda: da.decode_attention_stats(qi, qs, m_f, wfm, *main, mlen, pos, window,
                                            scale=scale, softcap=softcap)
    plain = lambda: da.decode_attention_stats_plain(qi, qs, m_f, wfm, *main, mlen, pos, window,
                                                    scale=scale, softcap=softcap)
    got, want = run(), plain()
    torch.cuda.synchronize()
    keep = da._keep_main(S, mlen, pos, window)
    n = int(keep.sum())                              # kept main rows of all slots
    rel = {k: float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
           for k, a, b in zip(("m", "a", "sum"), got[1:], want[1:])}
    d = (got[0] - want[0]).abs()
    # an ulp of a softcapped score (tanhf against torch's tanh) moves
    # e = exp(s - m) by |s - m| ulps: rtol 1e-5 holds m, a and sum_main
    if max(rel.values()) > 1e-5 or float((d > 0).float().mean()) > 0.01:
        raise AssertionError(f"B6: kernel disagrees with plain (relative errors {rel}, max o32 "
                             f"err {float(d.max())})")
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    nbytes = (qi.numel() + 3 * qs.numel() * 4 + 2 * B * 4 + 2 * KV * n * (D + 4)
              + got[0].numel() * 4 + 3 * qs.numel() * 4)
    b_ms, b_by = bound(nbytes, 2.0 * 2 * KV * r * n * D, INT8_OPS_PER_S)
    cap = "" if softcap is None else f" softcap={softcap}"
    win = "" if window <= 0 else f" window={window}"
    return {"case": f"main part B={B} KV={KV} r={r} D={D} S={S} len0={len0} t={t}{win}{cap}",
            "tolerance": "m, a, sum rtol 1e-5; o32 exact on >= 99% of entries",
            "max_abs_err": err, "ms": time_ms(run), "plain_ms": time_ms(plain, reps=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(_sdpa_yardstick(q, [main], keep))}


# B8 and B10 in their first design (B8 a CTA of 64 byte copies per (slot,
# head); B10 every butterfly stage through shared memory), ms, measured by
# this script on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 6, the
# kernel table's earlier times)
B8_B10_EARLIER_MS = {
    "one token, layer 7 lane 16 of L=16 B=128 KV=8 W=32 D=64": 0.0066,
    "R1 draw: +-1 diagonal 2048 f32": 0.0283, "R2 draw: +-1 diagonal 64 f32": 0.0065,
    "4096 x 2048 bf16": 0.0473, "4096 x 8192 bf16": 0.1828,
    "4096 x 2560 bf16 (K = 20)": 0.1273}


def launch_floor_ms() -> float:
    """Device time of an empty launch, timed as every kernel is."""
    return time_ms(lambda: torch.cuda._sleep(0))


def check_fresh_write(gen, L=LAYERS, B=128, KV=8, W=32, D=64, layer=7, t=16):
    """B8: one token into a layer's side block, bitwise. Bound: the token's
    bytes read once and written once; library: the same four indexed
    copies as single PyTorch calls."""
    from llm_compressor_tpu_torch.kernels import decode_attention as da

    i8 = lambda *shp: torch.randint(-127, 128, shp, generator=gen, device="cuda",
                                    dtype=torch.int16).to(torch.int8)
    fresh = (i8(L, B, KV, W, D), i8(L, B, KV, W, D),
             torch.rand((L, B, KV, W), generator=gen, device="cuda"),
             torch.rand((L, B, KV, W), generator=gen, device="cuda"))
    new = (i8(B, KV, D), i8(B, KV, D), torch.rand((B, KV), generator=gen, device="cuda"),
           torch.rand((B, KV), generator=gen, device="cuda"))
    ref = da.fresh_write_plain(tuple(a.clone() for a in fresh), new, layer, t)
    got = da.fresh_write(fresh, new, layer, t)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError("B8: kernel disagrees with plain")
    views = [a[layer, :, :, t] for a in ref]
    b_ms, b_by = bound(2.0 * 2 * B * KV * (D + 4), 0.0, INT8_OPS_PER_S)
    return {"case": f"one token, layer {layer} lane {t} of L={L} B={B} KV={KV} W={W} D={D}",
            "tolerance": "bitwise", "max_abs_err": 0.0,
            "ms": time_ms(lambda: da.fresh_write(fresh, new, layer, t)),
            "plain_ms": time_ms(lambda: da.fresh_write_plain(ref, new, layer, t), reps=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: [v.copy_(n) for v, n in zip(views, new)])}


def check_w4a8_actq(gen, label, M, N, C, wfmt):
    """One B9 case: raw bf16 acts, bitwise against the act quantizer + B3's
    plain version at the launched split count; ``b3_ms`` times B3 on
    host-quantised acts at the same shape and ``quant_ms`` B9's act
    quantizer kernel (``torch.profiler``), so ms - quant_ms is its core."""
    from llm_compressor_tpu_torch.kernels import w4a8_matmul as wm

    cb = C if wfmt == 0 else C // 2
    codes = _rand_codes(gen, (N, cb), wfmt)
    scales = torch.rand((N, C // 128), generator=gen, device="cuda") * 1e-2 + 1e-3
    x = torch.randn((M, C), generator=gen, device="cuda").to(torch.bfloat16)
    bf = torch.bfloat16
    run = lambda: wm.matmul_actq(x, codes, scales, wfmt, bf)
    plain = lambda: wm.actq_plain(x, codes, scales, wfmt, bf, splits=wm.matmul_actq.last_grid[2])
    got = run()
    want = plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"B9 {label}: kernel disagrees with plain "
                             f"(max err {float((got.float() - want.float()).abs().max())})")
    x_i8, sx = wm.quantize_acts_per_token(x)
    nbytes = x.numel() * 2 + codes.numel() + scales.numel() * 4 + M * N * 2
    b_ms, b_by = bound(nbytes, 2.0 * M * N * C, INT8_OPS_PER_S)
    w_bf = torch.randn((N, C), generator=gen, device="cuda").to(bf)
    case = {"case": label, "M": M, "N": N, "C": C, "tolerance": "bitwise", "max_abs_err": 0.0,
            "ms": time_ms(run), "plain_ms": time_ms(plain, reps=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.matmul(x, w_bf.t())),
            "b3_ms": time_ms(lambda: wm.matmul_flat(x_i8, codes, scales, sx, wfmt, bf)),
            "quant_ms": _profiled_ms(run, "w4a8_act_quant"),
            **_grid_fields(wm.matmul_actq, run, label)}
    del codes, scales, w_bf
    return case


# B5's times before the split-K redesign, ms at M = 128, measured by this
# script on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 6)
B5_EARLIER_MS = {"decode qkv int4-g128 zp": 0.1660, "decode o int4-g128 zp": 0.1669,
                 "decode gate|up int4-g128 zp": 0.1766, "decode down int4-g128 zp": 0.6524,
                 "decode qkv int4-g128 symmetric": 0.1667, "decode int8-g128 head": 1.1377,
                 "decode qkv fp8-e4m3-g128": 0.1340}


def _profiled_ms(fn, name: str, reps: int = 5) -> float:
    """Median device time (ms) of the kernels whose name holds ``name``
    per call of ``fn``, from a ``torch.profiler`` trace of ``reps`` calls,
    each after an L2 flush; 0 where ``fn`` launches no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            _FLUSH.fill_(1)
            fn()
        torch.cuda.synchronize()
    d = sorted((e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name)
    return d[len(d) // 2] if d else 0.0


def check_dequant_matmul(gen, label, M, N, C, fmt, zeros: bool, g=128):
    """One B5 case: random packed codes, scales (and zero points) of an
    (N, C) weight, x (M, C) bf16, bf16 out. Tolerance: one bf16 ulp of the
    output plus the f32 summation term 2 * C * 2**-24 * (|x| @ |W|^T) —
    kernel and plain version build the same bf16 weight and differ only in
    the order of the f32 sums (split-K included). Two launches must give
    the same bits."""
    from llm_compressor_tpu_torch.kernels import dequant_matmul as dm

    G = C // g
    if fmt in (dm.F_INT4_PAIRS, dm.F_INT4_HALVES):
        codes = _rand_codes(gen, (N, C // 2), 1)
        zs = torch.randint(-4, 5, (N, G), generator=gen, device="cuda").float()
    elif fmt == dm.F_INT8:
        codes = _rand_codes(gen, (N, C), 0)
        zs = torch.zeros((N, G), device="cuda")
    else:  # fp8 codes of normal values; zeros are real-domain midpoints, added
        codes = torch.randn((N, C), generator=gen, device="cuda").to(torch.float8_e4m3fn)
        zs = torch.randn((N, G), generator=gen, device="cuda") * 1e-2
    zs = zs if zeros else None
    scales = torch.rand((N, G), generator=gen, device="cuda") * 1e-2 + 1e-3
    x = torch.randn((M, C), generator=gen, device="cuda").to(torch.bfloat16)
    bf = torch.bfloat16
    run = lambda: dm.dequant_matmul_codes(x, codes, scales, zs, fmt, bf)
    plain = lambda: dm.dequant_matmul_plain(x, codes, scales, zs, fmt, bf)
    got, want = run(), plain()
    tiles_n, tiles_m, splits = dm.dequant_matmul_codes.last_grid
    torch.cuda.synchronize()
    w = dm.dequant_weight_bf16(codes, scales, zs, fmt)
    mag = x.float().abs() @ w.float().abs().t()
    err = (got.float() - want.float()).abs()
    if not bool((err <= 2.0 ** -7 * want.float().abs() + 2 * C * 2.0 ** -24 * mag).all()):
        raise AssertionError(f"B5 {label}: kernel disagrees with plain (max err {float(err.max())})")
    if not torch.equal(run(), got):
        raise AssertionError(f"B5 {label}: two launches on the same inputs differ")
    del mag
    nbytes = (x.numel() * 2 + codes.numel() * codes.element_size() + scales.numel() * 4
              + (0 if zs is None else zs.numel() * 4) + M * N * 2)
    b_ms, b_by = bound(nbytes, 2.0 * M * N * C, BF16_OPS_PER_S)
    case = {"case": label, "M": M, "N": N, "C": C,
            "tolerance": "1 bf16 ulp + 2*C*2^-24*(|x|@|W|^T); bitwise launch to launch",
            "max_abs_err": float(err.max()), "ms": time_ms(run),
            "plain_ms": time_ms(plain, reps=3, warmup=1), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": time_ms(lambda: torch.matmul(x, w.t())),
            "splits": splits, "ctas": tiles_n * tiles_m * splits,
            "reduce_ms": _profiled_ms(run, "dequant_matmul_reduce"),
            "earlier_ms": B5_EARLIER_MS[label]}
    del codes, scales, zs, w
    return case


def check_hadamard(gen, label, rows, n, dtype, diagonal=False):
    """One B10 case: x (rows, n) normal values, or a +-1 diagonal (n, n)
    (a rotation draw, rows = n). Kernel and plain version take the same
    float32 adds in the same order: bitwise. Bound: each value read and
    written once; the log2(m) butterfly adds, K base adds and one scale per
    value run on the float32 units."""
    from llm_compressor_tpu_torch.kernels import hadamard as hd

    K, m = hd.decompose(n)
    if diagonal:
        signs = torch.randint(0, 2, (n,), generator=gen, device="cuda").float() * 2 - 1
        x = torch.diag(signs).to(dtype)
    else:
        x = torch.randn((rows, n), generator=gen, device="cuda").to(dtype)
    run = lambda: hd.hadamard_transform(x)
    plain = lambda: hd.hadamard_transform_plain(x)
    got, want = run(), plain()
    torch.cuda.synchronize()
    if got.dtype != dtype or not torch.equal(got, want):
        raise AssertionError(f"B10 {label}: kernel disagrees with plain "
                             f"(max err {float((got.float() - want.float()).abs().max())})")
    if diagonal:  # the draw is orthonormal
        eye = torch.eye(n, device="cuda")
        if float((got.double() @ got.double().t() - eye).abs().max()) > 1e-6:
            raise AssertionError(f"B10 {label}: the signed Hadamard draw is not orthonormal")
    h_n = hd.hadamard_transform_plain(torch.eye(n, device="cuda", dtype=dtype))
    b_ms, b_by = bound(2.0 * x.numel() * x.element_size(),
                       x.numel() * (math.log2(m) + K + 1), FP32_OPS_PER_S)
    case = {"case": label, "rows": rows, "n": n, "K": K, "dtype": str(dtype).split(".")[-1],
            "tolerance": "bitwise", "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": time_ms(run), "plain_ms": time_ms(plain, reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.matmul(x, h_n))}
    del x, h_n, got, want
    return case


def kernel_cases(gen):
    """Each kernel's cases at the shapes of the main path, by kernel name:
    a function that runs them in order (inputs drawn from ``gen``), each
    held against its plain version, and returns their records."""
    from llm_compressor_tpu_torch.kernels import dequant_matmul as dm

    E, I, V = 2048, 8192, 128256
    # Gemma-2-2B (the archs phase's slice): hidden, intermediate, vocab
    gE, gI, gV = 2304, 9216, 256000
    # Phi-2 (the archs_b phase's slice)
    pE, pI, pV = 2560, 10240, 51200
    return {
        "B1_w4a8_stacked": lambda: [
            check_w4a8(gen, "decode qkv", "stacked", 128, 3072, E, 1),
            check_w4a8(gen, "decode o", "stacked", 128, E, E, 1),
            check_w4a8(gen, "decode down", "stacked", 128, E, I, 1),
            check_w4a8(gen, "gemma-2-2b decode qkv", "stacked", 128, 4096, gE, 1),
            check_w4a8(gen, "phi-2 decode qkv", "stacked", 128, 3 * pE, pE, 1),
            check_w4a8(gen, "phi-2 decode o", "stacked", 128, pE, pE, 1),
            check_w4a8(gen, "phi-2 decode fc1", "stacked", 128, pI, pE, 1),
            check_w4a8(gen, "phi-2 decode fc2", "stacked", 128, pE, pI, 1)],
        "B2_w4a8_gateup_silu": lambda: [
            check_w4a8(gen, "decode gate|up", "gateup", 128, 2 * I, E, 1),
            check_w4a8(gen, "prefill gate|up 128x128 rows", "gateup", 128 * 128, 2 * I, E, 1),
            check_w4a8(gen, "gemma-2-2b decode gate|up gelu_tanh", "gateup", 128, 2 * gI, gE,
                       1, act="gelu_tanh")],
        "B3_w4a8_flat": lambda: [
            check_w4a8(gen, "decode int8 head", "flat", 128, V, E, 0),
            check_w4a8(gen, "prefill qkv 128x128 rows", "flat", 128 * 128, 3072, E, 1),
            check_w4a8(gen, "prefill o 128x128 rows", "flat", 128 * 128, E, E, 1),
            check_w4a8(gen, "gemma-2-2b decode int8 head", "flat", 128, gV, gE, 0),
            check_w4a8(gen, "phi-2 decode int8 head", "flat", 128, pV, pE, 0)],
        "B4_decode_attention_append": lambda: [
            check_decode_attention(gen),
            check_decode_attention(gen, B=4, S=LONG_S, pos=LONG_S - 1),
            check_decode_attention(gen, KV=4, r=2, D=256, softcap=50.0),
            check_decode_attention(gen, KV=4, r=2, D=256, window=4096, softcap=50.0),
            check_decode_attention(gen, KV=1, r=8, D=256),
            check_decode_attention(gen, KV=32, r=1, D=80),
            check_decode_attention(gen, KV=32, r=1, D=64, scale=1.0)],
        "B5_dequant_matmul": lambda: [
            check_dequant_matmul(gen, "decode qkv int4-g128 zp", 128, 3072, E, dm.F_INT4_PAIRS, True),
            check_dequant_matmul(gen, "decode o int4-g128 zp", 128, E, E, dm.F_INT4_PAIRS, True),
            check_dequant_matmul(gen, "decode gate|up int4-g128 zp", 128, 2 * I, E,
                                 dm.F_INT4_PAIRS, True),
            check_dequant_matmul(gen, "decode down int4-g128 zp", 128, E, I, dm.F_INT4_PAIRS, True),
            check_dequant_matmul(gen, "decode qkv int4-g128 symmetric", 128, 3072, E,
                                 dm.F_INT4_PAIRS, False),
            check_dequant_matmul(gen, "decode int8-g128 head", 128, V, E, dm.F_INT8, False),
            check_dequant_matmul(gen, "decode qkv fp8-e4m3-g128", 128, 3072, E,
                                 dm.F_FP8_E4M3, True)],
        "B6_decode_attention_stats": lambda: [
            check_stats(gen), check_stats(gen, window=64, softcap=50.0),
            check_stats(gen, B=4, S=LONG_S, len0=LONG_S - 17),
            check_stats(gen, window=64, softcap=50.0, KV=4, r=2, D=256),
            check_stats(gen, KV=32, r=1, D=80)],
        "B7_decode_attention": lambda: [
            check_two_part(gen, True), check_two_part(gen, False),
            check_two_part(gen, True, window=64, softcap=50.0),
            check_two_part(gen, True, B=4, S=LONG_S, len0=LONG_S - 17),
            check_two_part(gen, True, window=64, softcap=50.0, KV=4, r=2, D=256),
            check_two_part(gen, True, KV=32, r=1, D=80)],
        "B8_fresh_write": lambda: [check_fresh_write(gen)],
        "B9_w4a8_actq": lambda: [
            check_w4a8_actq(gen, "int8 head, raw bf16 acts", 128, V, E, 0),
            check_w4a8_actq(gen, "flat qkv int4-g128 pair planes, raw bf16 acts", 128, 3072, E,
                            1)],
        "B10_hadamard": lambda: [
            check_hadamard(gen, "R1 draw: +-1 diagonal 2048 f32", E, E, torch.float32, True),
            check_hadamard(gen, "R2 draw: +-1 diagonal 64 f32", 64, 64, torch.float32, True),
            check_hadamard(gen, "4096 x 2048 bf16", 4096, E, torch.bfloat16),
            check_hadamard(gen, "4096 x 8192 bf16", 4096, I, torch.bfloat16),
            check_hadamard(gen, "4096 x 2560 bf16 (K = 20)", 4096, 2560, torch.bfloat16)],
    }


def phase_kernels(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = {name: run() for name, run in kernel_cases(gen).items()}
    floor = launch_floor_ms()
    log(f"kernel launch floor: empty launch ms={floor:.4f}")
    cases["B8_fresh_write"][0]["launch_floor_ms"] = floor
    cases["B10_hadamard"][1]["launch_floor_ms"] = floor
    earlier = ATTENTION_EARLIER_MS | B8_B10_EARLIER_MS
    for name, cs in cases.items():
        for c in cs:
            if c["case"] in earlier:
                c["earlier_ms"] = earlier[c["case"]]
            log(f"kernel {name} [{c['case']}]: max_abs_err={c['max_abs_err']} "
                f"({c['tolerance']}) ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
                f"bound_ms={c['bound_ms']:.4f} ({c['bound_by']}) "
                f"library_ms={c['library_ms']:.4f}"
                + "".join(f" {k}={c[k]}" for k in EXTRA_METRICS + LOG_ONLY if k in c))
    return cases


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------


def flagship_cfg(layers: int):
    from llm_compressor_tpu_torch.models import ModelConfig, RopeScaling

    return ModelConfig(
        arch="llama", vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_layers=layers, num_heads=32, num_kv_heads=8, head_dim=64,
        max_position_embeddings=4096, rope_theta=500000.0,
        rope_scaling=RopeScaling(kind="llama3", factor=32.0, low_freq_factor=1.0,
                                 high_freq_factor=4.0, original_max_position=8192),
        tie_word_embeddings=True, dtype="bfloat16")


def build_model(layers: int, seed: int, serving, cfg=None):
    """RTN -> pack -> fuse -> stack of random full-width weights for a
    serving config (``W4A8``, ``WEIGHT_ONLY``, ...): the flagship at
    ``layers`` layers, or ``cfg``."""
    from llm_compressor_tpu_torch.algorithms import pack_model, rtn
    from llm_compressor_tpu_torch.models import fuse_model, init_params, stack_model
    from llm_compressor_tpu_torch.qformats import build_quant_config

    qargs, head_act, _ = serving
    cfg = cfg or flagship_cfg(layers)
    qcfg = build_quant_config(*qargs, head_act=head_act)
    params = init_params(cfg, seed=seed)
    rtn(params, cfg, qcfg)
    pack_model(params, cfg, qcfg)
    params = stack_model(fuse_model(params, cfg, qcfg))
    return cfg, qcfg, params


@contextlib.contextmanager
def plain_kernels():
    """Route the kernel wrappers of the model paths to their plain versions
    (CUDA tensors included) — the reference run of the reduced-depth
    checks."""
    import importlib

    from llm_compressor_tpu_torch.kernels import decode_attention as da
    from llm_compressor_tpu_torch.kernels import dequant_matmul as dm
    from llm_compressor_tpu_torch.kernels import hadamard as hd
    from llm_compressor_tpu_torch.kernels import w4a8_matmul as wm

    gen_mod = importlib.import_module("llm_compressor_tpu_torch.engine.generate")
    kv_mod = importlib.import_module("llm_compressor_tpu_torch.engine.kvcache")
    plain = [
        (wm, "matmul_stacked", lambda x, c, s, sx, layer, f, dt: wm.w4a8_plain(
            x, c[layer], s[layer], sx, f, dt)),
        (wm, "matmul_flat", wm.w4a8_plain),
        (wm, "gateup_silu", lambda x, c, s, sx, layer, f, act, dt: wm.gateup_plain(
            x, c[layer], s[layer], sx, f, act, dt)),
        (gen_mod, "decode_attention_append", da.decode_attention_append_plain),
        (gen_mod, "decode_attention", da.decode_attention_plain),
        (da, "decode_attention_stats", da.decode_attention_stats_plain),
        (kv_mod, "fresh_write", da.fresh_write_plain),
        (dm, "dequant_matmul_codes", dm.dequant_matmul_plain),
        (hd, "hadamard_transform", hd.hadamard_transform_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in plain]
    # the decodes under the switch run eagerly (graph=False): a graph would
    # bake in the kernels it captured
    for mod, name, fn in plain:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def new_cache(cfg, batch, max_len, serving):
    from llm_compressor_tpu_torch.engine import init_cache

    return init_cache(cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim,
                      quantized=serving[2])


def _host_cache(cache):
    return {n: None if getattr(cache, n) is None else getattr(cache, n).cpu()
            for n in ("k", "v", "k_scale", "v_scale", "lengths")}


def _zero_cache(cache) -> None:
    for n in ("k", "v", "k_scale", "v_scale", "lengths"):
        if getattr(cache, n) is not None:
            getattr(cache, n).zero_()


def _cache_from_host(host):
    from llm_compressor_tpu_torch.engine import KVCache

    return KVCache(**{n: None if a is None else a.cuda() for n, a in host.items()})


def _same_cache(a, b) -> bool:
    return all((getattr(a, n) is None and getattr(b, n) is None)
               or torch.equal(getattr(a, n), getattr(b, n))
               for n in ("k", "v", "k_scale", "v_scale", "lengths"))


def _timed_decode(params, cfg, qcfg, tok, cache, steps, attention, graph):
    """``decode_greedy_steps`` -> (tokens, host ms ended by ``synchronize``)."""
    from llm_compressor_tpu_torch.engine import decode_greedy_steps

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = decode_greedy_steps(params, tok, cache, n=steps, cfg=cfg, qcfg=qcfg,
                                 attention=attention, graph=graph)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _restore_cache(cache, host) -> None:
    """``cache`` set back in place (its buffers, so its graphs, kept) to a
    host copy (``_host_cache``)."""
    for n, a in host.items():
        if a is not None:
            getattr(cache, n).copy_(a)


def _key_us(params, cache) -> float:
    """Host microseconds of one graph key (``engine/graph.py``: the address,
    shape, strides and dtype of every params and cache buffer), the work
    each graphed call adds before its replay; the mean of 100."""
    from llm_compressor_tpu_torch.engine.graph import _signature

    t0 = time.perf_counter()
    for _ in range(100):
        _signature((cache, params))
    return (time.perf_counter() - t0) / 100 * 1e6


def run_slice(params, cfg, qcfg, serving, batch, prompt, steps, max_len, seed,
              attention="append"):
    """Prefill ``batch`` random prompts of ``prompt`` tokens (from ``seed``)
    into a new cache (TTFT: the second prefill, with the cache zeroed, the
    launch counts set to 0 and the peak memory reset just before), then
    ``steps`` greedy steps in the ``attention`` mode, three times from that
    prefilled state (set back in place between calls): the first call on
    the cache runs eagerly (``first_call_s``), the second captures the
    steps as one CUDA graph (``capture_s``), the third replays it (decode
    ms, peak memory; ``replay_counts`` are its launches; ``counts`` those of
    the prefill and the three calls). Then the eager loop (``graph=False``) from a copy of the same
    prefilled state must give the graph's tokens, cache codes, scales and
    lengths bitwise, with the launches of one replay (``loop_ms``); so must
    the first call and the capture's."""
    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.engine import prefill

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device="cuda",
                         dtype=torch.int32)
    cache = new_cache(cfg, batch, max_len, serving)
    prefill(params, toks, cache, cfg=cfg, qcfg=qcfg)
    # as new again: the float attention of prefill quantizes K and V per
    # channel over the whole window (as the JAX package does), so rows past
    # the prompt would change its numbers
    _zero_cache(cache)
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, toks, cache, cfg=cfg, qcfg=qcfg)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    start = _host_cache(cache)
    calls = []
    for captures in (0, 1, 1):
        _restore_cache(cache, start)
        before = kernels.launch_counts()
        out, ms = _timed_decode(params, cfg, qcfg, tok, cache, steps, attention, True)
        if cache.graphs.captures != captures:
            raise AssertionError(f"{attention} decode: {cache.graphs.captures} captures after "
                                 f"call {len(calls) + 1} on one cache, not {captures}")
        after = kernels.launch_counts()
        calls.append((out, ms, {k: after[k] - before[k] for k in after}, _host_cache(cache)))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    loop_cache = _cache_from_host(start)
    kernels.reset_counts()
    loop_out, loop_ms = _timed_decode(params, cfg, qcfg, tok, loop_cache, steps, attention,
                                      False)
    loop_counts = kernels.launch_counts()
    loop_host = _host_cache(loop_cache)
    for name, (o, _, c, host) in zip(("first call", "capture", "replay"), calls):
        if not torch.equal(o, loop_out) or any(
                not (a is None or torch.equal(a, loop_host[n])) for n, a in host.items()):
            raise AssertionError(f"{attention} decode: the {name}'s tokens or cache differ "
                                 "from the eager loop's")
        if c != loop_counts:
            raise AssertionError(f"{attention} decode: the {name} counted {c}, the eager "
                                 f"loop launched {loop_counts}")
    del loop_cache
    return {"logits": logits, "out": calls[2][0], "cache": cache, "ttft_ms": ttft_ms,
            "decode_ms": calls[2][1], "first_call_s": calls[0][1] / 1e3,
            "capture_s": calls[1][1] / 1e3, "loop_ms": loop_ms, "counts": counts,
            "replay_counts": calls[2][2], "peak": peak, "allocated_before": allocated,
            "key_us": _key_us(params, cache)}


def _side_block_decode(params, cfg, qcfg, cache, tok, steps, attention, feed):
    """The side-block decode of ``decode_greedy_steps`` step by step, so that
    the reference's tokens can be fed in and every step's logits kept:
    B8 writes, B7 (or B6) attends, one merge after the steps."""
    import importlib

    from llm_compressor_tpu_torch.models import head

    gen_mod = importlib.import_module("llm_compressor_tpu_torch.engine.generate")
    kv_mod = importlib.import_module("llm_compressor_tpu_torch.engine.kvcache")
    len0 = cache.lengths.clone()
    fresh = kv_mod.init_fresh(cfg.num_layers, cache.batch, steps, cfg.num_kv_heads,
                              cfg.head_dim, device=cache.k.device)
    all_logits = []
    with torch.inference_mode():
        for t in range(steps):
            if feed is not None:
                tok = feed[t]
            h = gen_mod._forward_decode_fresh(params, cfg, tok, cache, fresh, t, len0, qcfg,
                                              attention)
            logits = head(params, cfg, h, qcfg)[:, -1, :]
            all_logits.append(logits)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        kv_mod.merge_fresh(cache, fresh, len0, steps)
    return all_logits


def teacher_forced(model, serving, toks, steps: int, max_len: int, mode="append", feed=None):
    """Prefill ``toks`` into a new cache of ``max_len`` rows, then ``steps``
    greedy decode steps in the ``mode`` (eagerly, step by step), fed the
    tokens of ``feed`` where given -> (the logits of the prefill and of each
    step, the cache)."""
    from llm_compressor_tpu_torch.engine import decode_step, prefill

    cfg, qcfg, params = model
    cache = new_cache(cfg, toks.shape[0], max_len, serving)
    logits, cache = prefill(params, toks, cache, cfg=cfg, qcfg=qcfg)
    all_logits = [logits]
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    if mode != "append":
        return all_logits + _side_block_decode(params, cfg, qcfg, cache, tok, steps, mode,
                                               feed), cache
    for i in range(steps):
        if feed is not None:
            tok = feed[i]
        logits, cache = decode_step(params, tok, cache, cfg=cfg, qcfg=qcfg, graph=False)
        all_logits.append(logits)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    return all_logits, cache


def check_reduced_depth(seed: int, serving, kernel_names, gap_tol: float = 0.1, build=None,
                        attention="append", model=None, shape=(16, 32, 8, 64)):
    """2 layers, full width: teacher-force the plain path's greedy tokens
    through both paths; where the plain logits' top-2 gap exceeds
    ``gap_tol`` the kernel path's argmax must be the same token. The kernel
    run must launch every kernel of ``kernel_names`` and no other.
    ``build(layers)`` makes the model, by default RTN (``build_model``),
    once for both paths; a given ``build`` runs once on each path (under
    ``plain_kernels`` for the reference), as part of that path's run; a
    given ``model`` (cfg, qcfg, params) serves both paths. ``shape`` is
    (slots, prompt tokens, decode steps, cache rows). ``attention`` is the
    decode mode; a side-block mode also runs the kernel path's in-place B4
    decode on the same tokens and returns how many of its tokens and how
    many merged-cache codes differ from that."""
    from llm_compressor_tpu_torch import kernels

    kernels.reset_counts()
    if model is not None:
        ref_model = model
    elif build is None:
        ref_model = build_model(2, seed, serving)
    else:
        with plain_kernels():
            ref_model = build(2)
    cfg = ref_model[0]
    B, T, steps, max_len = shape
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device="cuda",
                         dtype=torch.int32)

    def run(model, feed=None, mode=attention):
        return teacher_forced(model, serving, toks, steps, max_len, mode, feed)

    with plain_kernels():
        ref, _ = run(ref_model)
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"the plain run launched kernels: {kernels.launch_counts()}")
    feed = [torch.argmax(lg, -1).to(torch.int32)[:, None] for lg in ref[:-1]]
    model = ref_model if build is None or model is not None else build(2)
    del ref_model
    got, got_cache = run(model, feed)
    counts = kernels.launch_counts()
    used = {COUNTER_OF[k] for k in kernel_names}
    if any((v > 0) != (k in used) for k, v in counts.items()):
        raise AssertionError(f"the kernel run's launches {counts} are not those of {kernel_names}")
    checked = agree = 0
    for a, b in zip(ref, got):
        if not bool(torch.isfinite(b).all()):
            raise AssertionError("non-finite logits on the kernel path")
        top2 = torch.topk(a, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > gap_tol
        same = torch.argmax(a, -1) == torch.argmax(b, -1)
        checked += int(sure.sum())
        agree += int((same & sure).sum())
    max_err = max(float((a - b).abs().max()) for a, b in zip(ref, got))
    if agree != checked or checked == 0:
        raise AssertionError(f"reduced-depth check: {agree}/{checked} confident tokens agree")
    vs_b4 = None
    if attention != "append":
        b4, b4_cache = run(model, feed, "append")
        w = T + steps
        vs_b4 = {"tokens_equal": sum(int((torch.argmax(a, -1) == torch.argmax(b, -1)).sum())
                                     for a, b in zip(got, b4)),
                 "codes_differ_by_layer": [
                     sum(int((getattr(got_cache, n)[layer, :, :, :w]
                              != getattr(b4_cache, n)[layer, :, :, :w]).sum())
                         for n in ("k", "v")) for layer in range(cfg.num_layers)],
                 "codes": 2 * got_cache.k[:, :, :, :w].numel()}
    del model
    return checked, (steps + 1) * B, max_err, vs_b4


def compare_prefill_reduction(model, serving, batch, prompt, seed):
    """``prefill`` of one set of tokens, with bf16 reduced-precision
    reduction allowed (PyTorch's default, prefill's own context lifted) and
    as prefill runs, under ``full_f32_accumulation``; in turns allowed,
    f32, f32, allowed. Reports how many logits and last-position argmax
    tokens differ and the host time of each way (ms, mean of two); fails
    nothing."""
    import importlib

    from llm_compressor_tpu_torch.engine import prefill

    gen_mod = importlib.import_module("llm_compressor_tpu_torch.engine.generate")
    cfg, qcfg, params = model
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device="cuda",
                         dtype=torch.int32)
    cm = torch.backends.cuda.matmul
    real = gen_mod.full_f32_accumulation

    def run(allow: bool):
        cache = new_cache(cfg, batch, prompt, serving)
        prev = cm.allow_bf16_reduced_precision_reduction
        cm.allow_bf16_reduced_precision_reduction = True
        if allow:
            gen_mod.full_f32_accumulation = contextlib.nullcontext
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = prefill(params, toks, cache, cfg=cfg, qcfg=qcfg)
            torch.cuda.synchronize()
            return logits, (time.perf_counter() - t0) * 1e3
        finally:
            gen_mod.full_f32_accumulation = real
            cm.allow_bf16_reduced_precision_reduction = prev

    runs = [run(a) for a in (True, False, False, True)]
    a, b = runs[0][0], runs[1][0]
    d = (a - b).abs()
    return {"batch": batch, "prompt": prompt, "logits": d.numel(),
            "logits_differ": int((d > 0).sum()), "max_abs_diff": float(d.max()),
            "argmax_differ": int((a.argmax(-1) != b.argmax(-1)).sum()),
            "repeats_bitwise": torch.equal(runs[0][0], runs[3][0])
            and torch.equal(runs[1][0], runs[2][0]),
            "ms_bf16_reduction": (runs[0][1] + runs[3][1]) / 2,
            "ms_f32_accumulation": (runs[1][1] + runs[2][1]) / 2}


def _clone_tree(node):
    if isinstance(node, dict):
        return {k: _clone_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_clone_tree(v) for v in node]
    return node.clone()


def calibrate_and_pack(layers: int, seed: int, keep_layer0: bool = False):
    """Llama-3.2-1B at ``layers`` layers, random weights from ``seed``:
    ``spinquant(mode="hadamard")`` (R1 / R2 draws through B10, then GPTQ)
    on CALIB_SAMPLES x CALIB_LEN synthetic tokens with the W4A8 config ->
    ``pack_model`` with GPTQ's scale book -> fuse -> stack. Checks that
    packing is lossless: ``dequantize`` of every packed weight equals the
    GPTQ'd bf16 weight bitwise. Returns (cfg, qcfg, params, info): info
    holds the calibration's seconds (total and by phase), peak memory and
    launch counts (set to 0 just before it), and layer 0's GPTQ'd weights;
    with ``keep_layer0`` also the rotated layer 0 and its calibration
    inputs, as GPTQ received them."""
    import importlib

    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.algorithms import PhaseTimer, pack_model, spinquant
    from llm_compressor_tpu_torch.algorithms.common import get_weight
    from llm_compressor_tpu_torch.capture import CalibContext
    from llm_compressor_tpu_torch.models import fuse_model, init_params, stack_model
    from llm_compressor_tpu_torch.models.transformer import arch_slots
    from llm_compressor_tpu_torch.qformats import build_quant_config, dequantize
    from llm_compressor_tpu_torch.utils import synthetic_tokens

    qargs, head_act, _ = W4A8
    cfg = flagship_cfg(layers)
    qcfg = build_quant_config(*qargs, head_act=head_act)
    params = init_params(cfg, seed=seed)
    calib = synthetic_tokens(CALIB_SAMPLES, CALIB_LEN, cfg.vocab_size, seed)
    info: dict = {}
    sq_mod = importlib.import_module("llm_compressor_tpu_torch.algorithms.spinquant")
    real_gptq = sq_mod.gptq

    def gptq_keeping_layer0(params, cfg, ctx, qcfg, **kw):
        info["layer0"] = _clone_tree(params["layers"][0])
        info["ctx"] = CalibContext(cfg=ctx.cfg, hidden=ctx.hidden.clone(),
                                   positions=ctx.positions, chunk=ctx.chunk)
        return real_gptq(params, cfg, ctx, qcfg, **kw)

    book, timer = {}, PhaseTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    if keep_layer0:
        sq_mod.gptq = gptq_keeping_layer0
    try:
        cfg = spinquant(params, cfg, calib, qcfg, seed=seed, scale_book=book, timings=timer)
    finally:
        sq_mod.gptq = real_gptq
    torch.cuda.synchronize()
    info.update(calib_s=time.perf_counter() - t0, phases=timer.seconds,
                calib_counts=kernels.launch_counts(),
                calib_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    gptq_w = {(i, s): get_weight(lp, s) for i, lp in enumerate(params["layers"])
              for s in arch_slots(cfg)}
    info["gptq_layer0"] = {s: w for (i, s), w in gptq_w.items() if i == 0}
    pack_model(params, cfg, qcfg, scale_book=book)
    for (i, s), w in gptq_w.items():
        if not torch.equal(dequantize(get_weight(params["layers"][i], s)), w):
            raise AssertionError(f"packing layer {i} {s} after GPTQ is not lossless")
    del gptq_w
    return cfg, qcfg, stack_model(fuse_model(params, cfg, qcfg)), info


# GPTQ without its error feedback rounds exactly as RTN does (act order
# moves whole groups and the scales are solved on W), a ratio of 1.0; sound
# runs measured 0.52-0.81 at full width (PERF.md, PR 3).
GPTQ_OVER_RTN_MAX = 0.9


def check_gptq_beats_rtn(info, cfg, qcfg):
    """For every linear of layer 0:
    ||(W - Q_gptq) X||_F <= GPTQ_OVER_RTN_MAX * ||(W - Q_rtn) X||_F,
    W the rotated weight, the same quantizer, X the inputs its sequential
    group saw (earlier groups GPTQ'd), through GPTQ's own Hessian
    H = 2/n X X^T: ||dW X||_F^2 = n/2 tr(dW H dW^T). Returns the ratios."""
    from llm_compressor_tpu_torch.algorithms.common import (
        get_weight, sequential_groups, set_weight, slot_tap, weight_quantizer_for)
    from llm_compressor_tpu_torch.capture import accumulate_hessian
    from llm_compressor_tpu_torch.device import full_f32_matmul
    from llm_compressor_tpu_torch.models import layer_ops
    from llm_compressor_tpu_torch.qformats import quantize_dequant

    lp, ctx, gptq_w = info["layer0"], info["ctx"], info["gptq_layer0"]
    ops, n = layer_ops(cfg, qcfg, 0), ctx.hidden.shape[0]
    ratios = {}
    for group in sequential_groups(cfg):
        tap = slot_tap(group[0])
        H = accumulate_hessian(ctx, lp, 0, (tap,), ops)[tap]
        with full_f32_matmul():
            for slot in group:
                W = get_weight(lp, slot)
                rtn_w = quantize_dequant(weight_quantizer_for(cfg, qcfg, 0, slot), W) * (W != 0)

                def err(Q):
                    d = W.float() - Q.float()
                    return math.sqrt(n / 2 * float(((d @ H) * d).sum()))

                e_gptq, e_rtn = err(gptq_w[slot]), err(rtn_w)
                if not e_gptq <= GPTQ_OVER_RTN_MAX * e_rtn:
                    raise AssertionError(f"layer 0 {slot}: GPTQ's output error {e_gptq} is not "
                                         f"below {GPTQ_OVER_RTN_MAX} x RTN's {e_rtn}")
                ratios[slot] = e_gptq / e_rtn
        for slot in group:
            set_weight(lp, slot, gptq_w[slot])
    return ratios


def _kernel_class(name: str) -> str:
    if "decode_attention_append" in name:
        return "B4"
    if "decode_attention_stats" in name:
        return "B6"
    if "decode_attention_kernel" in name:
        return "B7"
    if "fresh_write" in name:
        return "B8"
    if "dequant_matmul" in name:   # the main kernel and the split-K reduce
        return "B5"
    if "w4a8_gateup" in name:   # the fused gate|up on the core, and its split-K reduce
        return "B2"
    if "w4a8_mma_kernel" in name or "w4a8_reduce" in name:   # the core and its split-K reduce
        return "B1/B3"
    return "other"


def _union_us(spans) -> float:
    """Length of the union of (start, end) device intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_calibration_pass(info):
    """Device time by kernel (the eight largest, and the rest) and the idle
    share of one calibration pass: layer 0 (GPTQ'd) over the calibration
    inputs, accumulating the 8192 x 8192 down-proj Hessian, under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from llm_compressor_tpu_torch.capture import accumulate_hessian
    from llm_compressor_tpu_torch.models import layer_ops

    cfg, qcfg, ctx = info["cfg"], info["qcfg"], info["ctx"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        accumulate_hessian(ctx, info["layer0"], 0, ("down_in",), layer_ops(cfg, qcfg, 0))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy_us = _union_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms if spans else "not measured",
            "device_ms_by_kernel": {k[:90]: round(v, 3) for k, v in top[:8]},
            "device_ms_other": round(sum(v for _, v in top[8:]), 3)}


# the first kernel each counted wrapper launches, as a trace names it, and
# the counters of the wrappers that launch it (a split-K reduce, or B9's
# act quantizer, is a further launch of the same counted call)
TRACED_KERNELS = {"w4a8_mma_kernel": ("w4a8_stacked", "w4a8_flat", "w4a8_actq"),
                  "w4a8_gateup_kernel": ("w4a8_gateup",),
                  "decode_attention_append_kernel": ("decode_attention_append",),
                  "decode_attention_stats_kernel": ("decode_attention_stats",),
                  "decode_attention_kernel": ("decode_attention",),
                  "fresh_write_kernel": ("fresh_write",),
                  "dequant_matmul_kernel": ("dequant_matmul",),
                  "hadamard_kernel": ("hadamard",)}


def _traced_launches(names) -> dict:
    """Kernel launches of a trace by :data:`TRACED_KERNELS` name (found in
    the demangled or the mangled name; none of those names holds another)."""
    out = dict.fromkeys(TRACED_KERNELS, 0)
    for n in names:
        for k in TRACED_KERNELS:
            out[k] += k in n
    return out


def profile_decode(params, cfg, qcfg, cache, token, steps: int, attention="append"):
    """Device time per decode step by kernel class, and the device's idle
    share of the wall-clock window, from a ``torch.profiler`` trace of one
    replay of the ``steps``-step graph already captured for this cache
    (none may be captured inside the window). The trace's launches of each
    kernel (``launches_traced``) must equal what the replay added to the
    launch counters. Where the trace holds no kernel of the graph, "not
    measured"."""
    from torch.profiler import ProfilerActivity, profile

    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.engine import decode_greedy_steps

    captures = cache.graphs.captures
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_greedy_steps(params, token, cache, n=steps, cfg=cfg, qcfg=qcfg,
                            attention=attention)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    after = kernels.launch_counts()
    if cache.graphs.captures != captures:
        raise AssertionError("the profiled decode captured a graph")
    spans, by_class, names = [], {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        names.append(e.name)
        k = _kernel_class(e.name)
        by_class[k] = by_class.get(k, 0.0) + (b - a) / 1e3 / steps
    busy_us = _union_us(spans)
    if not any(k != "other" for k in by_class):
        return {"device_ms_per_step": "not measured", "idle_share": "not measured",
                "launches_traced": "not measured", "wall_ms_per_step": wall_ms / steps}
    traced = _traced_launches(names)
    counted = {k: sum(after[c] - before[c] for c in cs) for k, cs in TRACED_KERNELS.items()}
    if traced != counted:
        raise AssertionError(f"{attention} decode: the replay's trace launched {traced}, its "
                             f"counters added {counted}")
    return {"wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "device_ms_per_step": {k: round(v, 4) for k, v in sorted(by_class.items())},
            "launches_traced": {k: v for k, v in traced.items() if v}}


ATTENTION_MARK = "chip_smoke.prefill_attention"
MATMUL_OPS = ("aten::mm", "aten::matmul", "aten::addmm", "aten::linear")
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def profile_prefill(cfg, qcfg, params, serving, seed: int):
    """Device ms by kernel family of one ``prefill`` of BATCH x PROMPT
    tokens under ``torch.profiler``, with the device's busy time and idle
    share of the window. Families: B2, B3 (the core and its reduce: qkv,
    o), attention (every kernel of ``_float_attention``: the cache read,
    both einsums, softmax), bf16 matmul (a matmul kernel outside attention:
    down, after its dequantization), other. ``_float_attention`` runs
    inside a ``record_function`` range; a kernel is attention if it lies
    inside one of the range's device spans or its launching CPU op lies
    inside the range, and a bf16 matmul if its CPU op is a matmul or, where
    the profiler links it to no op, its name is a GEMM's. ``attribution``
    says which links the trace had."""
    import importlib

    from torch.profiler import ProfilerActivity, profile, record_function

    from llm_compressor_tpu_torch.engine import prefill

    gen_mod = importlib.import_module("llm_compressor_tpu_torch.engine.generate")
    inner = gen_mod._float_attention

    def marked(*args, **kw):
        with record_function(ATTENTION_MARK):
            return inner(*args, **kw)

    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda",
                         dtype=torch.int32)
    cache = new_cache(cfg, BATCH, MAX_LEN, serving)
    torch.cuda.synchronize()
    gen_mod._float_attention = marked
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill(params, toks, cache, cfg=cfg, qcfg=qcfg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        gen_mod._float_attention = inner
    del cache
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    marks = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == CUDA and ATTENTION_MARK in e.name)
    kernels = [e for e in events if e.device_type == CUDA and ATTENTION_MARK not in e.name
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return {"wall_ms": wall_ms, "device_ms_by_family": "not measured"}

    def ops_of(op):
        names = []
        while op is not None:
            names.append(op.name)
            op = op.cpu_parent
        return names

    # (name, duration) of each kernel the profiler links to a CPU op, with
    # that op's chain
    linked = {}
    for e in events:
        if e.device_type == CPU and getattr(e, "kernels", None):
            chain = ops_of(e)
            for k in e.kernels:
                linked.setdefault((k.name, round(k.duration, 3)), []).append(chain)
    fam, used = {}, {"device spans": 0, "cpu ops": 0, "names": 0}
    for e in kernels:
        a, b = e.time_range.start, e.time_range.end
        cls = _kernel_class(e.name)
        chains = linked.get((e.name, round(b - a, 3)))
        chain = chains.pop() if chains else None
        if cls in ("B2", "B1/B3"):
            f = "B2" if cls == "B2" else "B3"
        elif any(s <= a and b <= t for s, t in marks):
            f, used["device spans"] = "attention", used["device spans"] + 1
        elif chain is not None:
            used["cpu ops"] += 1
            f = ("attention" if ATTENTION_MARK in chain
                 else "bf16 matmul" if any(op in MATMUL_OPS for op in chain) else "other")
        else:
            used["names"] += 1
            f = "bf16 matmul" if any(n in e.name.lower() for n in GEMM_NAMES) else "other"
        fam[f] = fam.get(f, 0.0) + (b - a) / 1e3
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "device_ms_by_family": {k: round(v, 3) for k, v in sorted(fam.items())},
            "kernels": len(kernels), "attention_spans": len(marks), "attribution": used}


def phase_slice(seed: int, serving, kernel_names, model=None, attention="append",
                per_step=None):
    """The full-depth slice of one serving config, RTN-built unless a
    ``model`` (cfg, qcfg, params) is given, decoding in the ``attention``
    mode; every kernel of ``kernel_names`` must launch during it (counts
    set to 0 just before, read just after) and no other kernel may, and the
    decode steps must launch ``per_step`` (counter: launches per step)."""
    from llm_compressor_tpu_torch import kernels

    cfg, qcfg, params = model or build_model(LAYERS, seed, serving)
    r = run_slice(params, cfg, qcfg, serving, batch=BATCH, prompt=PROMPT, steps=STEPS,
                  max_len=MAX_LEN, seed=seed, attention=attention)
    logits, out, cache, counts = r["logits"], r["out"], r["cache"], r["counts"]
    if not bool(torch.isfinite(logits).all()) or logits.shape != (BATCH, cfg.vocab_size):
        raise AssertionError("prefill logits are not finite (batch, vocab)")
    if out.shape != (BATCH, STEPS) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError("decoded tokens out of range")
    if not bool((cache.lengths == PROMPT + STEPS).all()):
        raise AssertionError("cache lengths did not advance")
    used = {COUNTER_OF[k] for k in kernel_names}
    missing = [k for k in used if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    stray = {k: v for k, v in counts.items() if v and k not in used}
    if stray:
        raise AssertionError(f"kernels of another path launched: {stray}")
    measured = {k: r["replay_counts"][k] / STEPS for k in sorted(used)}
    if per_step is not None and any(measured[k] != v for k, v in per_step.items()):
        raise AssertionError(f"launches per decode step {measured}, not {per_step}")
    prof = profile_decode(params, cfg, qcfg, cache, out[:, -1:], STEPS, attention=attention)
    del cache, r["cache"]
    return {"cfg": cfg, "qcfg": qcfg, "params": params, "counts": counts,
            "per_step": measured, "ttft_ms": r["ttft_ms"], "decode_ms": r["decode_ms"],
            "decode_tok_s": BATCH * STEPS / (r["decode_ms"] / 1e3),
            "capture_s": r["capture_s"], "first_call_s": r["first_call_s"],
            "key_us": r["key_us"],
            "loop_decode_tok_s": BATCH * STEPS / (r["loop_ms"] / 1e3),
            "peak_mem_gib": r["peak"] / 2 ** 30,
            "allocated_before_gib": r["allocated_before"] / 2 ** 30, "profile": prof}


def check_generate(params, cfg, qcfg, seed: int):
    """``generate`` on the card: 4 prompts of 16 tokens, 8 new tokens with
    top-k 50 sampling at temperature 0.8, twice from one seed."""
    import numpy as np

    from llm_compressor_tpu_torch.engine import generate

    prompts = np.random.default_rng(seed + 3).integers(0, cfg.vocab_size, (4, 16))
    run = lambda: generate(params, cfg, prompts, max_new_tokens=8, temperature=0.8, top_k=50,
                           qcfg=qcfg, seed=seed)
    a, b = run(), run()
    if a.shape != (4, 24) or not (a[:, :16] == prompts).all():
        raise AssertionError(f"generate returned {a.shape}, not the prompts + 8 tokens")
    if int(a.min()) < 0 or int(a.max()) >= cfg.vocab_size or not (a == b).all():
        raise AssertionError("generate: tokens out of range, or one seed gave two outputs")
    return a[:, 16:].tolist()


def _slice_numbers(s):
    prof = s["profile"]
    out = {"ttft_ms": s["ttft_ms"], "decode_tok_s": s["decode_tok_s"],
           "first_call_s": s["first_call_s"], "capture_s": s["capture_s"],
           "key_us": s["key_us"], "loop_decode_tok_s": s["loop_decode_tok_s"],
           "peak_mem_gib": s["peak_mem_gib"], "allocated_before_gib": s["allocated_before_gib"],
           "device_busy_ms_per_step": prof.get("device_busy_ms_per_step"),
           "wall_ms_per_step": prof["wall_ms_per_step"], "idle_share": prof["idle_share"]}
    if "prefill_profile" in s:
        out["prefill_device_ms_by_family"] = s["prefill_profile"].get("device_ms_by_family")
    if "prefill_reduction" in s:
        pr = s["prefill_reduction"]
        out.update(ttft_ms_f32_accumulation=pr["ms_f32_accumulation"],
                   ttft_ms_bf16_reduction=pr["ms_bf16_reduction"])
    if "calib_s" in s:
        out.update(calib_s=s["calib_s"], calib_s_by_phase=s["phases"],
                   calib_peak_mem_gib=s["calib_peak_gib"])
    if "rtn_s" in s:
        out.update(rtn_s=s["rtn_s"], rtn_peak_mem_gib=s["rtn_peak_gib"],
                   head_max_abs_diff=s["head_max_abs_diff"], launches_per_step=s["per_step"])
    if "mse_vs_rtn_layer0" in s:
        out["mse_vs_rtn_layer0"] = s["mse_vs_rtn_layer0"]
    if "awq_s" in s:
        out.update({k: s[k] for k in (
            "wanda_s", "wanda_peak_gib", "sparsity", "awq_s", "awq_s_by_phase", "awq_peak_gib",
            "awq_pairs", "awq_best_over_rtn_max", "awq_best_over_rtn_median",
            "awq_chosen_ratio_mean", "clip_groups", "clip_groups_clipped")},
                   launches_per_step=s["per_step"])
    return out


def phase_spinquant(seed: int, layer0_at_2_layers):
    """The ``spinquant_gptq`` slice: calibrate and pack Llama-3.2-1B at full
    depth (B10 must launch 1 + LAYERS times and no other kernel), check that
    layer 0 came out bitwise as in the 2-layer run (whose layer 0 was held
    against RTN), then serve it on the W4A8 path (B1-B4, and not B10)."""
    cfg, qcfg, params, info = calibrate_and_pack(LAYERS, seed)
    counts = info["calib_counts"]
    if counts["hadamard"] != B10_PER_CALIBRATION or any(
            v for k, v in counts.items() if k != "hadamard"):
        raise AssertionError(f"calibration launched {counts}, not {B10_PER_CALIBRATION} x B10 "
                             "and nothing else")
    for slot, w in info["gptq_layer0"].items():
        if not torch.equal(w.cpu(), layer0_at_2_layers[slot]):
            raise AssertionError(f"layer 0 {slot}: GPTQ at {LAYERS} layers differs from the "
                                 "2-layer run")
    del info["gptq_layer0"]
    s = phase_slice(seed, W4A8, W4A8_KERNELS, model=(cfg, qcfg, params),
                    per_step=W4A8_APPEND_PER_STEP)
    del params
    return s | info


def phase_actq(cfg, qcfg, params, seed: int):
    """B9 through its entry point, ``w4a8_matmul(..., act_inside=True)``, on
    the int8-g128 head and layer 0's flat qkv (int4 pair planes) at M = 128
    raw bf16 rows; each output must equal the host-quantised B3 path's
    bitwise. Counts set to 0 just before, read just after."""
    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.kernels.w4a8_matmul import w4a8_matmul

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    x = torch.randn((BATCH, cfg.hidden_size), generator=gen, device="cuda").to(torch.bfloat16)
    weights = (params["lm_head"]["weight"],
               params["layers_stacked"]["attn"]["qkv_cat"]["weight"].layer(0))
    kernels.reset_counts()
    outs = [w4a8_matmul(x, qt, act_inside=True) for qt in weights]
    counts = kernels.launch_counts()
    for qt, y in zip(weights, outs):
        if not torch.equal(y, w4a8_matmul(x, qt)):
            raise AssertionError("B9 through w4a8_matmul(act_inside=True) differs from B3")
    if counts["w4a8_actq"] != len(weights) or any(
            v for k, v in counts.items() if k != "w4a8_actq"):
        raise AssertionError(f"the B9 entry point launched {counts}")
    return {"counts": counts}


# ---------------------------------------------------------------------------
# phase 7: checkpoints
# ---------------------------------------------------------------------------

# the checkpoint phase serves 16 prompts of 32 tokens, then 8 greedy steps
CKPT_BATCH, CKPT_PROMPT, CKPT_STEPS, CKPT_MAX_LEN = 16, 32, 8, 64


class ByteTokenizer:
    """A byte-level stand-in for a HF tokenizer, the interface
    ``generate_text`` takes: UTF-8 bytes in; out, each id as one character
    from U+4E00 on, where no id decodes to whitespace that ``strip`` drops."""
    eos_token_id = None
    BASE = 0x4E00

    def encode(self, text):
        return list(text.encode())

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(self.BASE + i) for i in ids)


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in path.iterdir() if f.is_file())


def _timed(fn):
    """(fn(), host seconds ended by a device synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def write_hf_dir(params, cfg, path):
    """An HF Llama directory of ``params`` without ``transformers``:
    ``config.json`` and ``model.safetensors`` in bfloat16 under the HF
    names (a tied model has no ``lm_head`` entry), as HF ships Llama-3.2-1B."""
    from llm_compressor_tpu_torch.models import to_hf_config
    from llm_compressor_tpu_torch.models.params import _hf_key_map, _hf_top_map
    from llm_compressor_tpu_torch.utils import safetensors_io

    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(to_hf_config(cfg), indent=2))
    sd = {}
    for mapping, tree in [(_hf_top_map(cfg), params)] + [
            (_hf_key_map(cfg, i), lp) for i, lp in enumerate(params["layers"])]:
        for name, keys in mapping.items():
            node = tree
            for k in keys:
                node = node[k]
            sd[f"{name}.weight"] = node["weight"].to(torch.bfloat16)
    safetensors_io.save_file(sd, path / "model.safetensors", metadata={"format": "pt"})


def _qtensors(params):
    from llm_compressor_tpu_torch.qformats import QTensor

    return {k: v for k, v in _flat_leaves(params) if isinstance(v, QTensor)}


def _qtensor_on_host(qt):
    return {"codes": qt.codes.cpu(), "scales": qt.scales.cpu(),
            "zeros": None if qt.zeros is None else qt.zeros.cpu(),
            "meta": (qt.quantizer, qt.shape, qt.blocked_shape, qt.group_axis, qt.ngroups_axis,
                     qt.dtype, qt.pair_planes)}


def _same_qtensor(qt, want) -> bool:
    got = _qtensor_on_host(qt)
    return (got["meta"] == want["meta"] and torch.equal(got["codes"], want["codes"])
            and torch.equal(got["scales"], want["scales"])
            and (got["zeros"] is None) == (want["zeros"] is None)
            and (got["zeros"] is None or torch.equal(got["zeros"], want["zeros"])))


def serve_checkpointed(params, cfg, qcfg, seed):
    """fuse -> stack (of a structural copy: ``params`` stays unfused) ->
    ``run_slice`` with the launch counts set to 0 just before it. Returns
    the stacked params, the tokens and the int8 cache's codes and scales on
    the host, the launch counts and the launches per decode step."""
    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.models import fuse_model, stack_model

    copy = dict(params, layers=[{k: dict(v) if isinstance(v, dict) else v
                                 for k, v in lp.items()} for lp in params["layers"]])
    stacked = stack_model(fuse_model(copy, cfg, qcfg))
    del copy
    r = run_slice(stacked, cfg, qcfg, W4A8, CKPT_BATCH, CKPT_PROMPT, CKPT_STEPS, CKPT_MAX_LEN,
                  seed)
    counts = r["counts"]
    used = {COUNTER_OF[k] for k in W4A8_KERNELS}
    if any((v > 0) != (k in used) for k, v in counts.items()):
        raise AssertionError(f"checkpointed model: launches {counts}, not those of B1-B4")
    per_step = {k: r["replay_counts"][k] / CKPT_STEPS for k in sorted(used)}
    if per_step != {k: float(v) for k, v in sorted(W4A8_APPEND_PER_STEP.items())}:
        raise AssertionError(f"checkpointed model: launches per decode step {per_step}")
    tok = torch.argmax(r["logits"], -1).to(torch.int32)[:, None]
    host = {"tokens": torch.cat([tok, r["out"]], 1).cpu(), **_host_cache(r["cache"])}
    del host["lengths"]
    return stacked, host, counts, per_step


def check_generate_text(stacked, cfg, qcfg):
    """``generate_text`` (chat template, byte tokenizer, int8 cache) must
    give the text of ``generate``'s new ids on the same ids."""
    import numpy as np

    from llm_compressor_tpu_torch.engine import CHAT_TEMPLATE, generate, generate_text

    tok, prompt = ByteTokenizer(), "Name three colours."
    got = generate_text(stacked, cfg, tok, prompt, max_new_tokens=CKPT_STEPS, qcfg=qcfg,
                        quantized_kv=True)
    ids = tok.encode(CHAT_TEMPLATE.format(message=prompt))
    out = generate(stacked, cfg, np.asarray([ids], np.int32), max_new_tokens=CKPT_STEPS,
                   qcfg=qcfg, quantized_kv=True)
    new = out[0, len(ids):].tolist()
    got_ids = [ord(c) - tok.BASE for c in got]
    if len(new) != CKPT_STEPS or got_ids != new:
        raise AssertionError(f"generate_text gave ids {got_ids}, generate {new}")
    return new


def phase_checkpoint(seed: int, smi: str):
    """Llama-3.2-1B at full depth through both checkpoints: random weights
    written as an HF bf16 directory and loaded back (bitwise), RTN W4A8 as
    ``build_model`` does, served; ``save_compressed`` -> ``load_compressed``
    -> ``pack_model`` (the tied head) served again: tokens, cache codes and
    scales and every QTensor bitwise equal to the in-memory model's; then
    ``generate_text`` against ``generate``. Both directories live in a
    temporary directory that is removed at the end."""
    import tempfile
    from pathlib import Path

    from llm_compressor_tpu_torch.algorithms import pack_model, rtn
    from llm_compressor_tpu_torch.models import (
        init_params,
        load_compressed,
        load_hf_checkpoint,
        save_compressed,
        to_hf_config,
    )
    from llm_compressor_tpu_torch.qformats import build_quant_config

    cfg = flagship_cfg(LAYERS)
    qcfg = build_quant_config(*W4A8[0], head_act=W4A8[1])
    out = {}
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        hf_dir, ck_dir = Path(tmp) / "hf", Path(tmp) / "compressed"
        params = init_params(cfg, seed=seed)
        _, out["hf_save_s"] = _timed(lambda: write_hf_dir(params, cfg, hf_dir))
        (cfg2, loaded), out["hf_load_s"] = _timed(lambda: load_hf_checkpoint(hf_dir))
        if cfg2 != cfg:
            raise AssertionError(f"from_hf_config gave {cfg2}, not {cfg}")
        want, got = dict(_flat_leaves(params)), dict(_flat_leaves(loaded))
        if set(want) != set(got) or any(not torch.equal(want[k], got[k]) for k in want):
            raise AssertionError("load_hf_checkpoint: the params differ from those written")
        del params, want, got
        rtn(loaded, cfg, qcfg)
        pack_model(loaded, cfg, qcfg)
        stacked, first, counts, per_step = serve_checkpointed(loaded, cfg, qcfg, seed)
        del stacked
        saved = {k: _qtensor_on_host(v) for k, v in _qtensors(loaded).items()}
        _, out["compressed_save_s"] = _timed(lambda: save_compressed(
            loaded, cfg, ck_dir, hf_config=to_hf_config(cfg)))
        del loaded
        torch.cuda.empty_cache()
        reloaded, out["compressed_load_s"] = _timed(lambda: load_compressed(ck_dir, cfg, qcfg))
        if "lm_head" in reloaded:
            raise AssertionError("the tied packed head was written")
        pack_model(reloaded, cfg, qcfg)
        back = _qtensors(reloaded)
        if set(back) != set(saved) or any(not _same_qtensor(back[k], saved[k]) for k in saved):
            raise AssertionError("load_compressed + pack_model: a QTensor differs from the "
                                 "saved one")
        stacked, second, counts, per_step = serve_checkpointed(reloaded, cfg, qcfg, seed)
        for name, a in first.items():
            if not torch.equal(a, second[name]):
                raise AssertionError(f"the reloaded model's {name} differ from the in-memory "
                                     "model's")
        del reloaded
        out["generate_text_ids"] = check_generate_text(stacked, cfg, qcfg)
        out["hf_dir_bytes"], out["compressed_dir_bytes"] = _dir_bytes(hf_dir), _dir_bytes(ck_dir)
        out["compressed_files"] = {f.name: f.stat().st_size for f in sorted(ck_dir.iterdir())}
    out.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, qtensors=len(saved),
               launches=counts, per_decode_step=per_step, card=smi)
    del stacked
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: the serving engine (continuous batching, speculative decoding)
# ---------------------------------------------------------------------------

# continuous batching: slots, cache rows, prefill chunk, requests, prompt
# lengths (inclusive), new tokens per request; the requests whose ids are
# also decoded alone by ``generate``
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_CHUNK, SERVE_REQUESTS, SERVE_NEW = 32, 512, 128, 96, 32
SERVE_PROMPTS = (16, 384)
SERVE_STANDALONE = 8
# speculative decoding: prompts, motif length and repeats (prompt = motif x
# repeats), drafts per round, rounds per dispatch, new tokens
SPEC_BATCH, SPEC_MOTIF, SPEC_REPEAT, SPEC_K, SPEC_ROUNDS, SPEC_NEW = 16, 16, 8, 4, 8, 64


def _batcher_run(params, cfg, qcfg, requests, graph: bool):
    """``requests`` ((prompt, submit kwargs) pairs) through a
    ``ContinuousBatcher`` (W4A8 over an int8 cache): ``warmup`` (with a
    graph, the decode step's eager first call and its capture), then
    ``run`` with the launch counts set to 0 and the peak memory reset just
    before. Each decode step and
    each chunk prefill is timed on the host, ended by ``synchronize``."""
    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.engine import ContinuousBatcher

    times = {"decode": [], "chunk": [], "on": False}

    def timed(name, fn, *args):
        if not times["on"]:
            return fn(*args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t)
        return out

    class Timed(ContinuousBatcher):
        def _decode(self, *args):
            return timed("decode", super()._decode, *args)

        def _chunk(self, *args):
            return timed("chunk", super()._chunk, *args)

    eng = Timed(params, cfg, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, qcfg=qcfg,
                quantized_kv=True, prefill_chunk=SERVE_CHUNK, graph=graph)
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    times["on"] = True
    for toks, kw in requests:
        eng.submit(toks, **kw)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    steps, chunks = len(times["decode"]), len(times["chunk"])
    generated = sum(len(v) for v in res.values())
    return res, {"wall_s": wall_s, "warmup_s": warmup_s, "requests_per_s": len(res) / wall_s,
                 "generated_tok_s": generated / wall_s, "generated": generated,
                 "decode_steps": steps, "chunks": chunks,
                 "host_ms_per_step": wall_s / steps * 1e3,
                 "decode_ms_mean": sum(times["decode"]) / steps * 1e3,
                 "chunk_prefill_ms_mean": sum(times["chunk"]) / chunks * 1e3,
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                 "counts": kernels.launch_counts()}


def check_batching(cfg, qcfg, params, seed: int):
    """96 requests, prompts of 16-384 tokens from ``seed``, 32 greedy new
    tokens each, through a graph batcher and an eager one: ids bitwise
    equal, the same launches, and B1-B4 launched as the steps and chunks
    ask (a decode step: 48 B1, 16 B2, 1 B3, 16 B4; a chunk: the same
    without B4). Request 1 carries an EOS id that it reaches: of the first
    8 tokens a one-slot eager batcher decodes for it, the one that appears
    first the latest; that batcher computes each row
    as the full batcher does (per-token act scales, the same M tiles and
    split plan). The first 8 requests are also decoded alone by
    ``generate``; the tokens each agrees for before the first difference
    are reported (``generate`` prefills the whole prompt at once, the
    batcher in chunks of 128 rows)."""
    import numpy as np

    from llm_compressor_tpu_torch.engine import ContinuousBatcher, generate

    rng = np.random.default_rng(seed + 7)
    lens = rng.integers(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32) for t in lens]
    probe = ContinuousBatcher(params, cfg, batch_slots=1, max_len=SERVE_MAX_LEN, qcfg=qcfg,
                              quantized_kv=True, prefill_chunk=SERVE_CHUNK, graph=False)
    probe.submit(prompts[0], max_new_tokens=8)
    probe_ids = probe.run()[1].tolist()
    eos = max(set(probe_ids), key=probe_ids.index)      # the token that comes first latest
    want_first = probe_ids[:probe_ids.index(eos) + 1]
    requests = [(t, dict(max_new_tokens=SERVE_NEW, eos_id=eos if i == 0 else None))
                for i, t in enumerate(prompts)]
    got, g = _batcher_run(params, cfg, qcfg, requests, graph=True)
    want, e = _batcher_run(params, cfg, qcfg, requests, graph=False)
    if set(got) != set(want) or any(not np.array_equal(got[u], want[u]) for u in want):
        raise AssertionError("batcher: the graph decode's ids differ from the eager decode's")
    if g["counts"] != e["counts"] or g["decode_steps"] != e["decode_steps"]:
        raise AssertionError(f"batcher: graph launches {g['counts']}, eager {e['counts']}")
    if got[1].tolist() != want_first:
        raise AssertionError(f"batcher: request 1 gave {got[1].tolist()}, not {want_first} "
                             f"ending on its EOS {eos}")
    if len(got) != SERVE_REQUESTS or any(len(got[u]) != SERVE_NEW for u in got if u != 1):
        raise AssertionError("batcher: a request is missing or was cut short")
    steps, chunks = g["decode_steps"], g["chunks"]
    want_counts = {"w4a8_stacked": 3 * LAYERS * (steps + chunks),
                   "w4a8_gateup": LAYERS * (steps + chunks), "w4a8_flat": steps + chunks,
                   "decode_attention_append": LAYERS * steps}
    if {k: v for k, v in g["counts"].items() if v} != want_counts:
        raise AssertionError(f"batcher: launches {g['counts']}, not {want_counts} for {steps} "
                             f"decode steps and {chunks} chunks")
    alone, first_calls = [], {"graph": [], "eager": []}
    for i in range(SERVE_STANDALONE):
        kw = dict(max_new_tokens=SERVE_NEW, qcfg=qcfg, quantized_kv=True,
                  eos_id=eos if i == 0 else None)
        ids, sec, extra = _timed_call(lambda: generate(params, cfg, prompts[i][None], **kw))
        eager_ids, eager_sec, eager_extra = _timed_call(
            lambda: generate(params, cfg, prompts[i][None], graph=False, **kw))
        if not np.array_equal(ids, eager_ids):
            raise AssertionError(f"generate: request {i + 1}'s ids through the graph differ "
                                 "from the eager ids")
        first_calls["graph"].append((sec, extra))
        first_calls["eager"].append((eager_sec, eager_extra))
        ids = ids[0, len(prompts[i]):]
        same = np.asarray(ids[:len(got[i + 1])]) == got[i + 1][:len(ids)]
        alone.append(int(np.argmin(same)) if not same.all() else len(same))
    return {"graph": g, "eager": {k: e[k] for k in ("wall_s", "requests_per_s",
                                                    "generated_tok_s", "host_ms_per_step",
                                                    "decode_ms_mean")},
            "eos_request_tokens": len(want_first), "standalone_prefix": alone,
            "generate_first_call": {k: {"s": [a for a, _ in v], "extra_peak_gib": max(
                b for _, b in v)} for k, v in first_calls.items()},
            "prompt_tokens": int(lens.sum())}


def _spec_state(params, cfg, qcfg, prompts, Hmax, max_len):
    """Prefill ``prompts`` into an int8 cache; the device history (prompt,
    first greedy token) and its lengths."""
    from llm_compressor_tpu_torch.engine import init_cache, prefill

    B, T = prompts.shape
    cache = init_cache(cfg.num_layers, B, max_len, cfg.num_kv_heads, cfg.head_dim,
                       quantized=True, device="cuda")
    logits, cache = prefill(params, prompts, cache, cfg=cfg, qcfg=qcfg)
    hist = torch.zeros((B, Hmax), dtype=torch.int32, device="cuda")
    hist[:, :T] = prompts
    hist[:, T] = torch.argmax(logits, -1).to(torch.int32)
    return hist, torch.full((B,), T + 1, dtype=torch.int32, device="cuda"), cache


def _greedy_tokens(params, cfg, qcfg, prompts, n, cache):
    """Plain greedy decode of ``prompts`` (B, T) on the card: prefill into
    ``cache`` (int8, at least T + n rows, zeroed first), then ``n - 1``
    steps in one ``decode_greedy_steps`` call (on one cache the first call
    runs eagerly, the second captures, later ones replay) -> (B, n) ids."""
    from llm_compressor_tpu_torch.engine import decode_greedy_steps, prefill

    _zero_cache(cache)                  # as new: see run_slice
    logits, cache = prefill(params, prompts, cache, cfg=cfg, qcfg=qcfg)
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks, _ = decode_greedy_steps(params, first, cache, n=n - 1, cfg=cfg, qcfg=qcfg)
    return torch.cat([first, toks], 1).cpu()


def _verify_vs_decode(params, cfg, qcfg, hist, hlen, cache):
    """The logits of the same next token two ways from one prefilled state:
    row 0 of a T = k + 1 verify forward (float attention over the
    dequantized int8 cache) and one decode step (B4's codes attention):
    the largest difference, the decode logits' top-2 gaps, and how many
    argmax tokens agree."""
    import importlib

    from llm_compressor_tpu_torch.engine import decode_step
    from llm_compressor_tpu_torch.engine.graph import _map
    from llm_compressor_tpu_torch.engine.speculative import draft_ngram_device
    from llm_compressor_tpu_torch.models import head

    gen_mod = importlib.import_module("llm_compressor_tpu_torch.engine.generate")
    last = torch.gather(hist, 1, (hlen.long() - 1)[:, None])
    toks = torch.cat([last, draft_ngram_device(hist, hlen, SPEC_K)], 1)
    with torch.inference_mode():
        h = gen_mod._forward_cached(params, cfg, toks, _map(torch.clone, cache), qcfg, start=None)
        verify = head(params, cfg, h, qcfg)[:, 0]
    decode, _ = decode_step(params, last, _map(torch.clone, cache), cfg=cfg, qcfg=qcfg,
                            graph=False)
    diff = (verify - decode).abs().max(-1).values
    top2 = torch.topk(decode, 2, -1).values
    gap = top2[:, 0] - top2[:, 1]
    return {"max_abs_logit_diff": float(diff.max()), "median_abs_logit_diff":
            float(diff.median()), "logit_std": float(decode.std()),
            "median_top2_gap": float(gap.median()), "rows_gap_above_diff": int((gap > diff).sum()),
            "argmax_equal": int((verify.argmax(-1) == decode.argmax(-1)).sum()),
            "rows": int(decode.shape[0])}


def _timed_call(fn):
    """``fn()`` -> (its result, host seconds ended by ``synchronize``, the
    peak device memory it added over what was allocated before, GiB)."""
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated() - allocated) / 2 ** 30)


def check_speculative(cfg, qcfg, params, seed: int):
    """16 prompts of a 16-token motif from ``seed`` repeated 8 times: the
    rounds of one dispatch (8 rounds of 4 drafts) through the graph path
    against the eager rounds from the same prefilled state, over three
    calls (the first eager, the second captures, the third replays;
    history, its lengths, the accept counts and the int8 cache bitwise
    after each); the next token's logits by the verify forward and by one
    decode step (``_verify_vs_decode``); then ``generate_speculative`` (64
    new tokens, ``accept_floor=0``), one call with the graph and one with
    ``graph=False`` (each a first call: a new cache; ids and stats equal),
    against greedy decode of the same prompts (its first call, eager, and
    a replay): tok/s of each and how many tokens agree (the T = k + 1
    verify forward's float attention over the dequantized cache and B4's
    codes attention break near-ties differently); then random prompts with
    the default accept floor (whether it falls back is reported), and with
    a floor above k_draft, which must fall back to greedy decode."""
    import numpy as np

    from llm_compressor_tpu_torch.engine import generate_speculative, init_cache
    from llm_compressor_tpu_torch.engine.graph import _map
    from llm_compressor_tpu_torch.engine.speculative import speculative_rounds

    rng = np.random.default_rng(seed + 8)
    motifs = rng.integers(0, cfg.vocab_size, (SPEC_BATCH, SPEC_MOTIF)).astype(np.int32)
    looping = np.tile(motifs, (1, SPEC_REPEAT))
    T = looping.shape[1]
    # three dispatches of rounds: room for their appends and cache writes
    Hmax = T + 3 * SPEC_ROUNDS * (SPEC_K + 1) + 1
    prompts = torch.from_numpy(looping).cuda()
    hist, hlen, cache = _spec_state(params, cfg, qcfg, prompts, Hmax, Hmax + SPEC_K + 1)
    active = torch.ones(SPEC_BATCH, dtype=torch.bool, device="cuda")
    state = [(hist.clone(), hlen.clone(), _map(torch.clone, cache)) for _ in range(2)]
    accepted = 0
    for captures in (0, 1, 1):
        (gh, gl, gc, gacc), (eh, el, ec, eacc) = [
            speculative_rounds(params, h, hl, c, active, rounds=SPEC_ROUNDS, k=SPEC_K, ngram=2,
                               cfg=cfg, qcfg=qcfg, graph=graph)
            for (h, hl, c), graph in zip(state, (True, False))]
        if not (torch.equal(gh, eh) and torch.equal(gl, el) and torch.equal(gacc, eacc)
                and _same_cache(gc, ec)) or gc.graphs.captures != captures:
            raise AssertionError("speculative rounds: the graph path's history, lengths, accept "
                                 "counts or cache differ from the eager rounds', or it did not "
                                 "capture at its second call")
        accepted += int(gacc.sum())
    del state, gc, ec
    out = {"rounds_graph_equal_eager": True, "accepted_in_three_dispatches": accepted,
           "verify_vs_decode": _verify_vs_decode(params, cfg, qcfg, hist, hlen, cache)}
    del cache
    random = rng.integers(0, cfg.vocab_size, looping.shape).astype(np.int32)
    greedy = {}
    for label, toks, kw in (("looping", looping, dict(accept_floor=0)), ("random", random, {}),
                            ("forced_fallback", random, dict(accept_floor=SPEC_K + 1.0))):
        run = lambda graph: generate_speculative(
            params, cfg, toks, max_new_tokens=SPEC_NEW, k_draft=SPEC_K, qcfg=qcfg,
            quantized_kv=True, rounds_per_dispatch=SPEC_ROUNDS, graph=graph, **kw)
        (hist_l, stats), spec_s, spec_extra = _timed_call(lambda: run(None))
        (eager_l, eager_stats), eager_s, eager_extra = _timed_call(lambda: run(False))
        if hist_l != eager_l or stats != eager_stats:
            raise AssertionError(f"speculative {label}: the graph path's ids or stats differ "
                                 "from the eager path's")
        if id(toks) not in greedy:
            prompts = torch.from_numpy(toks).cuda()
            greedy_cache = init_cache(cfg.num_layers, SPEC_BATCH, T + SPEC_NEW, cfg.num_kv_heads,
                                      cfg.head_dim, quantized=True, device="cuda")
            calls = [_timed_call(lambda: _greedy_tokens(params, cfg, qcfg, prompts, SPEC_NEW,
                                                        greedy_cache)) for _ in range(3)]
            if greedy_cache.graphs.captures != 1 or not all(
                    torch.equal(c[0], calls[0][0]) for c in calls):
                raise AssertionError(f"greedy decode ({label} prompts): the capture or the "
                                     "replay differs from the eager first call")
            greedy[id(toks)] = (calls[0][0], calls[0][1], calls[2][1])
            del greedy_cache
        ref, greedy_first_s, greedy_s = greedy[id(toks)]
        spec = torch.tensor([h[T:] for h in hist_l], dtype=torch.int32)
        if spec.shape != ref.shape:
            raise AssertionError(f"speculative {label}: {tuple(spec.shape)} tokens, greedy "
                                 f"{tuple(ref.shape)}")
        same = spec == ref
        n = spec.numel()
        out[label] = {**stats, "accept_floor": kw.get("accept_floor", 0.3 * SPEC_K),
                      "tok_s": n / spec_s, "eager_tok_s": n / eager_s,
                      "extra_peak_gib": spec_extra, "eager_extra_peak_gib": eager_extra,
                      "greedy_first_call_tok_s": n / greedy_first_s,
                      "greedy_replay_tok_s": n / greedy_s,
                      "tokens_equal_greedy": int(same.sum()), "tokens": n,
                      "rows_equal_greedy": int(same.all(1).sum())}
    if out["forced_fallback"]["fell_back"] is not True:
        raise AssertionError("speculative: an accept floor above k_draft did not fall back")
    return out


def phase_serving_engine(cfg, qcfg, params, seed: int, smi: str):
    """Phase 8 on the w4a8 slice's params: continuous batching and
    speculative decoding."""
    torch.cuda.empty_cache()
    out = {"batching": check_batching(cfg, qcfg, params, seed)}
    out["speculative"] = check_speculative(cfg, qcfg, params, seed)
    gc.collect()
    out.update(card=smi, allocated_after_gib=torch.cuda.memory_allocated() / 2 ** 30)
    return out


# ---------------------------------------------------------------------------
# phase 9: the quantizer formats (the MSE clip search, MX, NVFP4, MPQ)
# ---------------------------------------------------------------------------

# each slice: build_quant_config arguments, w_mse (the MSE clip search, RTN
# run with mse=True too), head_act, an int8 KV cache?, MPQ (every linear of
# the first and last layer promoted to int8 weights, register_4_to_8bit;
# the packed layers then do not stack and are served unstacked), the
# kernels of its path and their launches per decode step
FORMATS = {
    "w4a8_mse": dict(qargs=W4A8[0], mse=True, head_act=W4A8[1], int8_kv=True, mpq=False,
                     kernels=W4A8_KERNELS, per_step=W4A8_APPEND_PER_STEP),
    "mxfp8_weight_only": dict(qargs=("mxfp8_e4m3-g[128]-rw", None, None, "int8-g[128]-rw"),
                              mse=False, head_act=None, int8_kv=False, mpq=False,
                              kernels=["B5_dequant_matmul"],
                              per_step={"dequant_matmul": B5_PER_STEP}),
    "nvfp4_w4a4": dict(qargs=("nvfp4_e2m1-g[16]-rw", "nvfp4_e2m1-g[16]-rw", None,
                              "int8-g[128]-rw"),
                       mse=False, head_act=None, int8_kv=False, mpq=False,
                       kernels=["B5_dequant_matmul"], per_step={"dequant_matmul": 1}),
    "mpq_w4a8": dict(qargs=W4A8[0], mse=False, head_act=W4A8[1], int8_kv=True, mpq=True,
                     kernels=["B3_w4a8_flat", "B4_decode_attention_append"],
                     per_step={"w4a8_flat": B5_PER_STEP, "decode_attention_append": LAYERS}),
}
# the nvfp4_w4a4 check at 2 layers: packed against fake-quantized weights.
# Prefill runs the same bf16 matmuls on bitwise-equal weights; decode
# multiplies packed weights in f32 (dequantize, then the matmul, as JAX's
# dequant_matmul_xla), the fake ones in bf16; both under
# full_f32_accumulation, or cuBLAS may reduce the fake model's bf16 products
# in bf16 (5-11 % relative L2 between the two at 2 layers on an H100). An
# NVFP4 act code that flips on a last-bit difference moves its whole group.
# Held: greedy tokens equal wherever the fake model's top-2 gap exceeds
# NVFP4_GAP, and the logits' relative L2 difference at most NVFP4_REL_L2 at
# every step.
NVFP4_GAP, NVFP4_REL_L2 = 0.1, 0.05


def format_serving(name):
    f = FORMATS[name]
    return (f["qargs"], f["head_act"], f["int8_kv"])


def format_config(name, layers: int):
    from llm_compressor_tpu_torch.models.transformer import arch_slots, op_names
    from llm_compressor_tpu_torch.qformats import build_quant_config, register_4_to_8bit

    f = FORMATS[name]
    cfg = flagship_cfg(layers)
    qcfg = build_quant_config(*f["qargs"], w_mse=f["mse"], head_act=f["head_act"])
    if f["mpq"]:
        qcfg = register_4_to_8bit(qcfg, [f"{op_names(cfg, i)[s]}.weight"
                                         for i in (0, layers - 1) for s in arch_slots(cfg)])
    return cfg, qcfg


def build_format(name: str, layers: int, seed: int, keep_layer0: bool = False):
    """Random full-width weights from ``seed`` -> RTN (``mse`` as the slice
    says) with a scale book -> ``pack_model`` with the book -> fuse (->
    stack, unless MPQ). Packing must be lossless: ``dequantize`` of every
    packed linear equals RTN's fake-quantized weight bitwise. The head has
    no book entry and packs again from its fake-quantized values (its
    largest difference is reported). Returns (cfg, qcfg, params, info):
    RTN's seconds, peak memory and launches (counts set to 0 just before);
    with ``keep_layer0`` layer 0's weights before RTN, after it and its
    book entries."""
    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.algorithms import pack_model, rtn
    from llm_compressor_tpu_torch.algorithms.common import get_weight
    from llm_compressor_tpu_torch.models import fuse_model, init_params, stack_model
    from llm_compressor_tpu_torch.models.transformer import arch_slots
    from llm_compressor_tpu_torch.qformats import dequantize

    f = FORMATS[name]
    cfg, qcfg = format_config(name, layers)
    slots = arch_slots(cfg)
    params = init_params(cfg, seed=seed)
    info: dict = {}
    if keep_layer0:
        info["layer0_w"] = {s: get_weight(params["layers"][0], s).clone() for s in slots}
    book = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    rtn(params, cfg, qcfg, mse=f["mse"], scale_book=book)
    torch.cuda.synchronize()
    info.update(rtn_s=time.perf_counter() - t0, rtn_counts=kernels.launch_counts(),
                rtn_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    fake = {(i, s): get_weight(lp, s) for i, lp in enumerate(params["layers"]) for s in slots}
    head_fake = params["embed"]["weight"]
    pack_model(params, cfg, qcfg, scale_book=book)
    for (i, s), w in fake.items():
        if not torch.equal(dequantize(get_weight(params["layers"][i], s)), w):
            raise AssertionError(f"{name}: packing layer {i} {s} with RTN's scale book is not "
                                 "lossless")
    head = dequantize(params["lm_head"]["weight"])
    info["head_max_abs_diff"] = float((head.float() - head_fake.float()).abs().max())
    del head
    if keep_layer0:
        info["layer0_q"] = {s: fake[(0, s)] for s in slots}
        info["layer0_book"] = {s: book[(0, s)] for s in slots}
    del fake, book
    params = fuse_model(params, cfg, qcfg)
    return cfg, qcfg, params if f["mpq"] else stack_model(params), info


def check_mse_layer0(cfg, qcfg, info):
    """Layer 0's seven linears of ``w4a8_mse``: per group of 128, the MSE
    objective sum |Q(W) - W|**2.4 (f32, as the search scores it) at the
    search's pick must not exceed plain absmax RTN's (the search's own
    first candidate, p = 1; a tie passes). Returns, per linear, the groups
    the search clipped and ||W - Q_mse||_F / ||W - Q_rtn||_F, Q_rtn from
    RTN without the search."""
    from dataclasses import replace

    from llm_compressor_tpu_torch.algorithms.common import weight_quantizer_for
    from llm_compressor_tpu_torch.qformats import quantize as qz

    out = {}
    for s, W in info["layer0_w"].items():
        q = weight_quantizer_for(cfg, qcfg, 0, s, mse=True)
        plain = replace(q, mse=False)
        xb, _, axes = qz.block_for(q, W)
        x32 = xb.float()

        def objective(sc, z):
            dq = qz.fake_quantize_blocked(q, x32, sc, z, jitted=True)
            return (dq - x32).abs().pow(2.4).sum(axes, keepdim=True)

        s_mse, z_mse = info["layer0_book"][s]
        s_rtn, z_rtn = qz.find_params_blocked(plain, xb, axes, jitted=True)
        worse = int((objective(s_mse, z_mse) > objective(s_rtn, z_rtn)).sum())
        if worse:
            raise AssertionError(f"w4a8_mse layer 0 {s}: the MSE objective of {worse} groups "
                                 "is above plain RTN's")
        q_rtn, _ = qz.quantize_dequant_with_params(plain, W)
        err = lambda Q: torch.linalg.norm((W.float() - Q.float()).flatten())
        out[s] = {"ratio": float(err(info["layer0_q"][s]) / err(q_rtn)),
                  "clipped_groups": int((s_mse < s_rtn).sum()), "groups": s_mse.numel()}
    return out


def check_nvfp4_packed_vs_fake(seed: int):
    """``nvfp4_w4a4`` at 2 layers, full width: the packed model (its served
    form, B5 for the int8 head) against the same RTN output kept as dense
    fake-quantized weights (no kernel), 16 prompts of 32 tokens, prefill
    and 8 decode steps, both fed the fake model's greedy tokens, with f32
    accumulation (``full_f32_accumulation``). Greedy
    tokens must agree wherever the fake model's top-2 gap exceeds
    NVFP4_GAP, and each step's logits must lie within NVFP4_REL_L2
    relative L2 of the fake model's."""
    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.algorithms import pack_model, rtn
    from llm_compressor_tpu_torch.device import full_f32_accumulation
    from llm_compressor_tpu_torch.engine import decode_step, prefill
    from llm_compressor_tpu_torch.models import fuse_model, init_params, stack_model

    cfg, qcfg = format_config("nvfp4_w4a4", 2)
    params = init_params(cfg, seed=seed)
    rtn(params, cfg, qcfg)
    fake = stack_model(fuse_model(_clone_tree(params), cfg, qcfg))
    pack_model(params, cfg, qcfg)
    packed = stack_model(fuse_model(params, cfg, qcfg))
    B, T, steps = 16, 32, 8
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device="cuda",
                         dtype=torch.int32)

    def run(p, feed=None):
        cache = new_cache(cfg, B, 64, format_serving("nvfp4_w4a4"))
        with full_f32_accumulation():
            logits, cache = prefill(p, toks, cache, cfg=cfg, qcfg=qcfg)
            out = [logits]
            for i in range(steps):
                tok = torch.argmax(logits, -1).to(torch.int32)[:, None] if feed is None \
                    else feed[i]
                logits, cache = decode_step(p, tok, cache, cfg=cfg, qcfg=qcfg, graph=False)
                out.append(logits)
        return out

    kernels.reset_counts()
    ref = run(fake)
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"the fake-quantized model launched {kernels.launch_counts()}")
    got = run(packed, [torch.argmax(lg, -1).to(torch.int32)[:, None] for lg in ref[:-1]])
    counts = kernels.launch_counts()
    if counts["dequant_matmul"] != 1 + steps or sum(counts.values()) != 1 + steps:
        raise AssertionError(f"the packed model launched {counts}, not one B5 per head")
    rel = [float(torch.linalg.norm(a - b) / torch.linalg.norm(a)) for a, b in zip(ref, got)]
    checked = agree = 0
    for a, b in zip(ref, got):
        if not bool(torch.isfinite(b).all()):
            raise AssertionError("non-finite logits in the packed nvfp4 model")
        top2 = torch.topk(a, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > NVFP4_GAP
        checked += int(sure.sum())
        agree += int((sure & (torch.argmax(a, -1) == torch.argmax(b, -1))).sum())
    if agree != checked or checked == 0 or max(rel) > NVFP4_REL_L2:
        raise AssertionError(f"nvfp4 packed vs fake: {agree}/{checked} confident tokens agree, "
                             f"relative L2 by step {rel}")
    return {"confident_tokens_equal": agree, "tokens": (steps + 1) * B,
            "rel_l2_by_step": rel,
            "max_abs_diff": max(float((a - b).abs().max()) for a, b in zip(ref, got))}


def phase_formats(seed: int):
    """Phase 9: the 2-layer checks of ``mxfp8_weight_only`` (kernel path
    against plain) and ``nvfp4_w4a4`` (packed against fake-quantized), then
    the four slices at full width and depth, each built by
    :func:`build_format` and served as ``phase_slice`` serves the others."""
    out = {}
    checked, total, max_err, _ = check_reduced_depth(
        seed, format_serving("mxfp8_weight_only"), FORMATS["mxfp8_weight_only"]["kernels"])
    out["mxfp8_reduced_depth"] = {"confident_tokens_equal": checked, "tokens": total,
                                  "max_abs_logit_diff": max_err}
    out["nvfp4_packed_vs_fake"] = check_nvfp4_packed_vs_fake(seed)
    torch.cuda.empty_cache()
    slices = {}
    for name, f in FORMATS.items():
        cfg, qcfg, params, info = build_format(name, LAYERS, seed,
                                               keep_layer0=name == "w4a8_mse")
        if "layer0_w" in info:
            info["mse_vs_rtn_layer0"] = check_mse_layer0(cfg, qcfg, info)
            for k in ("layer0_w", "layer0_q", "layer0_book"):
                del info[k]
        s = phase_slice(seed, format_serving(name), f["kernels"], model=(cfg, qcfg, params),
                        per_step=f["per_step"])
        del s["params"], params
        torch.cuda.empty_cache()
        slices[name] = s | info
    out["slices"] = slices
    return out


# ---------------------------------------------------------------------------
# phase 10: the other architectures (Qwen2, Qwen3, Gemma, Gemma2, Gemma3)
# ---------------------------------------------------------------------------

# Each model's published config.json (Hugging Face hub), the keys
# ``from_hf_config`` reads; depth is cut where a run says so.
ARCH_CONFIGS = {
    "gemma2_2b": ("google/gemma-2-2b config.json", {
        "model_type": "gemma2", "vocab_size": 256000, "hidden_size": 2304,
        "intermediate_size": 9216, "num_hidden_layers": 26, "num_attention_heads": 8,
        "num_key_value_heads": 4, "head_dim": 256, "query_pre_attn_scalar": 256,
        "sliding_window": 4096, "attn_logit_softcapping": 50.0,
        "final_logit_softcapping": 30.0, "hidden_activation": "gelu_pytorch_tanh",
        "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "max_position_embeddings": 8192}),
    "qwen2_5_1_5b": ("Qwen/Qwen2.5-1.5B config.json (q/k/v biases: qwen2's default)", {
        "model_type": "qwen2", "vocab_size": 151936, "hidden_size": 1536,
        "intermediate_size": 8960, "num_hidden_layers": 28, "num_attention_heads": 12,
        "num_key_value_heads": 2, "hidden_act": "silu", "rope_theta": 1000000.0,
        "rms_norm_eps": 1e-6, "max_position_embeddings": 131072, "use_sliding_window": False,
        "tie_word_embeddings": True}),
    "qwen3_1_7b": ("Qwen/Qwen3-1.7B config.json", {
        "model_type": "qwen3", "vocab_size": 151936, "hidden_size": 2048,
        "intermediate_size": 6144, "num_hidden_layers": 28, "num_attention_heads": 16,
        "num_key_value_heads": 8, "head_dim": 128, "hidden_act": "silu",
        "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "max_position_embeddings": 40960,
        "attention_bias": False, "use_sliding_window": False, "tie_word_embeddings": True}),
    "gemma_2b": ("google/gemma-2b config.json", {
        "model_type": "gemma", "vocab_size": 256000, "hidden_size": 2048,
        "intermediate_size": 16384, "num_hidden_layers": 18, "num_attention_heads": 8,
        "num_key_value_heads": 1, "head_dim": 256, "hidden_act": "gelu",
        "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "max_position_embeddings": 8192}),
    "gemma3_1b": ("google/gemma-3-1b-pt config.json (layer_types: sliding_window_pattern "
                  "6, as transformers expands it)", {
        "model_type": "gemma3_text", "vocab_size": 262144, "hidden_size": 1152,
        "intermediate_size": 6912, "num_hidden_layers": 26, "num_attention_heads": 4,
        "num_key_value_heads": 1, "head_dim": 256, "query_pre_attn_scalar": 256,
        "sliding_window": 512, "rope_theta": 1000000.0, "rope_local_base_freq": 10000.0,
        "hidden_activation": "gelu_pytorch_tanh", "rms_norm_eps": 1e-6,
        "max_position_embeddings": 32768,
        "layer_types": ["full_attention" if (i + 1) % 6 == 0 else "sliding_attention"
                        for i in range(26)]}),
    "phi_2": ("microsoft/phi-2 config.json", {
        "model_type": "phi", "vocab_size": 51200, "hidden_size": 2560,
        "intermediate_size": 10240, "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": 32, "partial_rotary_factor": 0.4, "hidden_act": "gelu_new",
        "layer_norm_eps": 1e-5, "rope_theta": 10000.0, "max_position_embeddings": 2048,
        "qk_layernorm": False, "tie_word_embeddings": False}),
    "opt_1_3b": ("facebook/opt-1.3b config.json", {
        "model_type": "opt", "vocab_size": 50272, "hidden_size": 2048, "ffn_dim": 8192,
        "num_hidden_layers": 24, "num_attention_heads": 32, "activation_function": "relu",
        "max_position_embeddings": 2048, "do_layer_norm_before": True,
        "word_embed_proj_dim": 2048, "enable_bias": True}),
    "opt_350m": ("facebook/opt-350m config.json", {
        "model_type": "opt", "vocab_size": 50272, "hidden_size": 1024, "ffn_dim": 4096,
        "num_hidden_layers": 24, "num_attention_heads": 16, "activation_function": "relu",
        "max_position_embeddings": 2048, "do_layer_norm_before": False,
        "word_embed_proj_dim": 512, "enable_bias": True}),
    "bloom_560m": ("bigscience/bloom-560m config.json as BloomConfig(...).to_dict() writes it "
                   "(the hub file's n_embed under hidden_size)", {
        "model_type": "bloom", "vocab_size": 250880, "hidden_size": 1024, "n_layer": 24,
        "n_head": 16, "layer_norm_epsilon": 1e-5}),
}
GEMMA2_LAYERS = 26
# Gemma-2-2B's decode step: qkv, o and down per layer on B1, gate|up on B2,
# the int8 head on B3, one B4 per layer
GEMMA2_PER_STEP = {"w4a8_stacked": 3 * GEMMA2_LAYERS, "w4a8_gateup": GEMMA2_LAYERS,
                   "w4a8_flat": 1, "decode_attention_append": GEMMA2_LAYERS}
# the window check: layer 0 of 2 slides 4096; prompts of 4064 tokens and 64
# steps put positions 4064..4127 in the cache, so from step 32 on (position
# 4096) the window drops a slot's first keys
WINDOW_SHAPE = (4, 4064, 64, 4224)
# the four families at 2 layers: (slots, prompt, steps, cache rows); the
# Gemma-3-1B prompt runs past its window of 512
FAMILY_SHAPES = {"qwen2_5_1_5b": (16, 32, 8, 64), "qwen3_1_7b": (16, 32, 8, 64),
                 "gemma_2b": (16, 32, 8, 64), "gemma3_1b": (16, 576, 8, 640)}


def arch_cfg(name: str, layers: int, layer_types=None):
    """The published config of ``name`` (``ARCH_CONFIGS``) through
    ``from_hf_config``, bf16, cut to ``layers`` layers (``layer_types`` the
    kept layers' types where the config lists them)."""
    import dataclasses

    from llm_compressor_tpu_torch.models import from_hf_config

    cfg = from_hf_config(ARCH_CONFIGS[name][1])
    types = cfg.layer_types
    if types:
        types = tuple(layer_types or types[:layers])
    return dataclasses.replace(cfg, num_layers=layers, layer_types=types, dtype="bfloat16")


def check_window(seed: int):
    """Gemma-2-2B at 2 layers (layer 0 slides 4096), ``WINDOW_SHAPE``: the
    kernel path against the plain path in the three decode modes (as
    ``check_reduced_depth``), then the window bites: the kernel path
    without the window, fed the windowed run's tokens, gives the same
    logits bitwise up to position 4095 and other logits from 4096 on."""
    import dataclasses

    from llm_compressor_tpu_torch import kernels

    cfg = arch_cfg("gemma2_2b", 2)
    model = build_model(2, seed, W4A8, cfg=cfg)
    out = {}
    for mode, names in (("append", W4A8_KERNELS),
                        ("two_part", W4A8_MATMULS + SIDE_KERNELS["two_part"]),
                        ("hybrid", W4A8_MATMULS + SIDE_KERNELS["hybrid"])):
        checked, total, max_err, vs_b4 = check_reduced_depth(
            seed, W4A8, names, attention=mode, model=model, shape=WINDOW_SHAPE)
        out[mode] = {"confident_tokens_equal": checked, "tokens": total,
                     "max_abs_logit_diff": max_err}
        if vs_b4 is not None:
            out[mode]["vs_b4"] = vs_b4
    B, T, steps, max_len = WINDOW_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device="cuda",
                         dtype=torch.int32)
    kernels.reset_counts()
    windowed, _ = teacher_forced(model, W4A8, toks, steps, max_len)
    feed = [torch.argmax(lg, -1).to(torch.int32)[:, None] for lg in windowed[:-1]]
    full_model = (dataclasses.replace(cfg, sliding_window=None),) + model[1:]
    full, _ = teacher_forced(full_model, W4A8, toks, steps, max_len, feed=feed)
    first = cfg.sliding_window - T + 1       # logits index of position 4096
    same = [torch.equal(a, b) for a, b in zip(windowed, full)]
    if not all(same[:first]) or any(same[first:]):
        raise AssertionError(f"window check: logits equal by step {same}; expected equal "
                             f"before index {first} only")
    out["window_bites"] = {"equal_before_4096": first,
                           "max_abs_diff_from_4096": max(float((a - b).abs().max())
                                                         for a, b in zip(windowed[first:],
                                                                         full[first:]))}
    del model, full_model
    return out


def check_family(name: str, seed: int):
    """One family at 2 layers of its published widths, W4A8 with an int8
    cache: the kernel path against the plain path (``check_reduced_depth``
    at ``FAMILY_SHAPES``), then ``run_slice`` from the same params: the
    CUDA graph's three calls and the eager loop bitwise equal."""
    B, T, steps, max_len = FAMILY_SHAPES[name]
    cfg = arch_cfg(name, 2, ("sliding_attention", "full_attention")
                   if name == "gemma3_1b" else None)
    model = build_model(2, seed, W4A8, cfg=cfg)
    checked, total, max_err, _ = check_reduced_depth(seed, W4A8, W4A8_KERNELS, model=model,
                                                     shape=FAMILY_SHAPES[name])
    r = run_slice(model[2], cfg, model[1], W4A8, batch=B, prompt=T, steps=steps,
                  max_len=max_len, seed=seed)
    del model
    return {"source": ARCH_CONFIGS[name][0], "layers": 2, "shape": [B, T, steps, max_len],
            "confident_tokens_equal": checked, "tokens": total, "max_abs_logit_diff": max_err,
            "graph_decode_tok_s": B * steps / (r["decode_ms"] / 1e3),
            "eager_decode_tok_s": B * steps / (r["loop_ms"] / 1e3),
            "replay_counts": r["replay_counts"]}


def phase_archs(seed: int):
    """Phase 10: the ``gemma2_2b_w4a8`` slice at full width and depth (as
    ``phase_slice`` serves the flagship), the window check, the four
    families."""
    cfg = arch_cfg("gemma2_2b", GEMMA2_LAYERS)
    t0 = time.perf_counter()
    model = build_model(GEMMA2_LAYERS, seed, W4A8, cfg=cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s = phase_slice(seed, W4A8, W4A8_KERNELS, model=model, per_step=GEMMA2_PER_STEP)
    del s["params"], model
    s["build_s"] = build_s
    torch.cuda.empty_cache()
    out = {"slice": s, "window": check_window(seed)}
    torch.cuda.empty_cache()
    out["families"] = {name: check_family(name, seed) for name in FAMILY_SHAPES}
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 11: OPT, BLOOM and Phi
# ---------------------------------------------------------------------------

PHI2_LAYERS = 32
B1_B3_B4 = ["B1_w4a8_stacked", "B3_w4a8_flat", "B4_decode_attention_append"]
# Phi-2's decode step: qkv, o, fc1 and fc2 per layer on B1 (no gate|up, so
# no B2), the int8 head (51200 rows, with its bias) on B3, one B4 per layer
PHI2_PER_STEP = {"w4a8_stacked": 4 * PHI2_LAYERS, "w4a8_flat": 1,
                 "decode_attention_append": PHI2_LAYERS}
# the families at 2 layers: (slots, prompt, steps, cache rows)
FAMILY_B_SHAPE = (16, 32, 8, 64)
FAMILIES_B = ("opt_1_3b", "opt_350m", "bloom_560m", "phi_2")
# each decode mode and its attention kernels
ATTENTION_OF = {"append": ["B4_decode_attention_append"], **SIDE_KERNELS}


def family_b_kernels(name: str, mode: str, decode_only: bool = False):
    """The kernels a 2-layer family launches in a prefill and its decode
    steps (``decode_only``: in the decode steps): B1 at decode; B3 for the
    prefill projections with C/g <= 16 (every OPT and BLOOM linear but fc2)
    and for a head that B3 takes (BLOOM's 250880 and Phi-2's 51200 rows;
    OPT's 50272 rows, N % 128 != 0, take dequantize + matmul); the mode's
    attention kernels, none for BLOOM (ALiBi: the float path)."""
    b3 = [] if decode_only and name.startswith("opt") else ["B3_w4a8_flat"]
    attn = [] if name == "bloom_560m" else ATTENTION_OF[mode]
    return ["B1_w4a8_stacked"] + b3 + attn


def check_family_b(name: str, seed: int):
    """One family at 2 layers of its published widths, W4A8 with an int8
    cache, in the three decode modes: the kernel path against the plain
    path (``check_reduced_depth``; BLOOM once, its modes all decode alike),
    then ``run_slice`` from the same params: the CUDA graph's three calls
    and the eager loop bitwise equal, the replay launching the mode's
    kernels; OPT-1.3B also times its head (dequantize + matmul)."""
    from llm_compressor_tpu_torch.models import transformer as tt

    B, T, steps, max_len = FAMILY_B_SHAPE
    cfg = arch_cfg(name, 2)
    model = build_model(2, seed, W4A8, cfg=cfg)
    out = {"source": ARCH_CONFIGS[name][0], "layers": 2, "shape": list(FAMILY_B_SHAPE)}
    for mode in ATTENTION_OF:
        if name != "bloom_560m" or mode == "append":
            checked, total, max_err, vs_b4 = check_reduced_depth(
                seed, W4A8, family_b_kernels(name, mode), attention=mode, model=model,
                shape=FAMILY_B_SHAPE)
            out[mode] = {"confident_tokens_equal": checked, "tokens": total,
                         "max_abs_logit_diff": max_err}
            if vs_b4 is not None:
                out[mode]["vs_b4"] = vs_b4
        r = run_slice(model[2], cfg, model[1], W4A8, batch=B, prompt=T, steps=steps,
                      max_len=max_len, seed=seed, attention=mode)
        want = {COUNTER_OF[k] for k in family_b_kernels(name, mode, decode_only=True)}
        got = {k for k, v in r["replay_counts"].items() if v}
        if got != want:
            raise AssertionError(f"{name} {mode} decode launched {r['replay_counts']}, "
                                 f"not {sorted(want)}")
        out.setdefault(mode, {}).update(
            graph_decode_tok_s=B * steps / (r["decode_ms"] / 1e3),
            eager_decode_tok_s=B * steps / (r["loop_ms"] / 1e3),
            replay_counts=r["replay_counts"])
    if name == "opt_1_3b":
        cfg, qcfg, params = model
        h = torch.randn((BATCH, 1, cfg.hidden_size), device="cuda").to(torch.bfloat16)
        out["head_dequant_matmul_ms"] = time_ms(lambda: tt.head(params, cfg, h, qcfg))
        out["head_note"] = (f"final norm + {cfg.vocab_size} x {cfg.hidden_size} int8-g128 head, "
                            f"M = {BATCH}: dequantize + matmul (N % 128 != 0: neither B3 nor B5)")
    del model
    return out


def phase_archs_b(seed: int):
    """Phase 11: the ``phi_2_w4a8`` slice at full width and depth (as
    ``phase_slice`` serves the flagship), then the four families at 2
    layers."""
    cfg = arch_cfg("phi_2", PHI2_LAYERS)
    t0 = time.perf_counter()
    model = build_model(PHI2_LAYERS, seed, W4A8, cfg=cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s = phase_slice(seed, W4A8, B1_B3_B4, model=model, per_step=PHI2_PER_STEP)
    del s["params"], model
    s["build_s"] = build_s
    torch.cuda.empty_cache()
    out = {"slice": s, "families": {}}
    for name in FAMILIES_B:
        out["families"][name] = check_family_b(name, seed)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 12: the calibration and pruning algorithms
# ---------------------------------------------------------------------------

# the CLI's per-method corpora as offline streams (cli/main.py:47,65): seed +
# 0 wikitext-2 (GPTQ, GPTAQ, AWQ+'s GPTQ stage), + 1000 pile-val (AWQ, AWQ+,
# SmoothQuant), + 2000 C4 (Wanda, RIA, SparseGPT)
CORPUS_OFFSET = {"wikitext2": 0, "pileval": 1000, "c4": 2000}
SPARSITY = 0.5            # BASELINE.json's "AWQ INT4 + Wanda 50%"
SMOOTH_ALPHA = 0.8        # the CLI's default (cli/args.py:41)
BLOOM_KERNELS = ["B1_w4a8_stacked", "B3_w4a8_flat"]   # ALiBi: the float attention path


def calib_ctx(params, cfg, seed: int, corpus: str):
    """The layer-0 inputs of CALIB_SAMPLES x CALIB_LEN synthetic tokens of
    one corpus stream, in chunks of 8 as the CLI captures them."""
    from llm_compressor_tpu_torch.capture import capture_layer0
    from llm_compressor_tpu_torch.utils import synthetic_tokens

    toks = synthetic_tokens(CALIB_SAMPLES, CALIB_LEN, cfg.vocab_size,
                            seed + CORPUS_OFFSET[corpus])
    return capture_layer0(params, cfg, toks, chunk=8)


def _measured(fn):
    """fn() -> (its result, host seconds ended by synchronize, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 30


@contextlib.contextmanager
def awq_search_checks(rec):
    """Inside the block every AWQ scale search must find a loss at most its
    loss at ratio 0 (s = 1: plain RTN), and every clip group an error at
    most its unclipped one (both grid points are searched, so a miss is a
    port fault). ``rec`` counts pairs, the best loss over RTN's, groups
    and clipped groups."""
    import importlib

    awq_mod = importlib.import_module("llm_compressor_tpu_torch.algorithms.awq")
    real_grid, real_clip = awq_mod._scale_grid, awq_mod._clip_errors
    rec.update(pairs=0, best_over_rtn=[], chosen_ratio=[], clip_groups=0, clipped=0)

    def grid(*a, **kw):
        g = real_grid(*a, **kw)
        losses = [loss for loss, _ in g]
        best = min(losses)
        if not best <= losses[0]:
            raise AssertionError(f"AWQ scale search: best loss {best} above RTN's {losses[0]}")
        rec["pairs"] += 1
        rec["best_over_rtn"].append(best / losses[0] if losses[0] else 1.0)
        rec["chosen_ratio"].append(losses.index(best) / len(losses))
        return g

    def clip(*a, **kw):
        best, err, err0 = real_clip(*a, **kw)
        if not bool((err <= err0).all()):
            raise AssertionError("AWQ clip search: a chosen error above the unclipped one")
        rec["clip_groups"] += err.numel()
        rec["clipped"] += int((err < err0).sum())
        return best, err, err0

    awq_mod._scale_grid, awq_mod._clip_errors = grid, clip
    try:
        yield rec
    finally:
        awq_mod._scale_grid, awq_mod._clip_errors = real_grid, real_clip


def _linears(params, cfg):
    from llm_compressor_tpu_torch.algorithms.common import get_weight
    from llm_compressor_tpu_torch.models.transformer import arch_slots

    return {(i, s): get_weight(lp, s) for i, lp in enumerate(params["layers"])
            for s in arch_slots(cfg)}


def check_sparse(params, cfg, label: str, ratio: float = SPARSITY) -> float:
    """Every linear's share of zeros must be at least ``ratio``; returns
    the model's (``check_sparsity``)."""
    from llm_compressor_tpu_torch.evalx import check_sparsity

    for (i, s), w in _linears(params, cfg).items():
        share = float((w == 0).float().mean())
        if share < ratio:
            raise AssertionError(f"{label}: layer {i} {s} sparsity {share} < {ratio}")
    return check_sparsity(params, cfg, verbose=False)


def pack_lossless(params, cfg, qcfg, book, label: str, zeros=None):
    """``pack_model`` with the scale book; ``dequantize`` of every packed
    linear must equal the calibrated weight bitwise, and, given ``zeros``
    ((layer, slot) -> host bool mask of a pruning's zeros), every packed
    code there must be the zero code."""
    from llm_compressor_tpu_torch.algorithms import pack_model
    from llm_compressor_tpu_torch.algorithms.common import get_weight
    from llm_compressor_tpu_torch.qformats import dequantize
    from llm_compressor_tpu_torch.qformats.qtensor import unpack_int_codes

    calibrated = _linears(params, cfg)
    pack_model(params, cfg, qcfg, scale_book=book)
    for (i, s), w in calibrated.items():
        qt = get_weight(params["layers"][i], s)
        if not torch.equal(dequantize(qt), w):
            raise AssertionError(f"{label}: packing layer {i} {s} is not lossless")
        if zeros is not None:
            codes = unpack_int_codes(qt).reshape(w.shape)
            if bool((codes[zeros[(i, s)].to(codes.device)] != 0).any()):
                raise AssertionError(f"{label}: layer {i} {s} has a nonzero code where "
                                     "pruning zeroed the weight")


def wanda_awq(layers: int, seed: int):
    """Llama-3.2-1B at ``layers`` layers, random weights from ``seed``, in
    the CLI's order: ``wanda(0.5)`` on the C4 stream, ``awq`` with a scale
    book on the pile-val stream (W4A8), ``pack_model`` with the book, fuse,
    stack. Checks: every linear at least 50 % zeros after Wanda; AWQ's
    searches (``awq_search_checks``); packing lossless; every code at a
    position Wanda zeroed the zero code; no kernel launched. Returns (cfg,
    qcfg, params, info)."""
    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.algorithms import PhaseTimer, awq, wanda
    from llm_compressor_tpu_torch.models import fuse_model, init_params, stack_model
    from llm_compressor_tpu_torch.qformats import build_quant_config

    qargs, head_act, _ = W4A8
    cfg = flagship_cfg(layers)
    qcfg = build_quant_config(*qargs, head_act=head_act)
    params = init_params(cfg, seed=seed)
    kernels.reset_counts()
    _, wanda_s, wanda_peak = _measured(
        lambda: wanda(params, cfg, calib_ctx(params, cfg, seed, "c4"), SPARSITY, qcfg))
    sparsity = check_sparse(params, cfg, "wanda")
    zeros = {k: (w == 0).cpu() for k, w in _linears(params, cfg).items()}
    book, timer, rec = {}, PhaseTimer(), {}
    with awq_search_checks(rec):
        _, awq_s, awq_peak = _measured(lambda: awq(
            params, cfg, calib_ctx(params, cfg, seed, "pileval"), qcfg, scale_book=book,
            timings=timer))
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"calibration launched kernels: {launched}")
    pack_lossless(params, cfg, qcfg, book, "wanda + awq", zeros)
    del zeros
    info = {"wanda_s": wanda_s, "wanda_peak_gib": wanda_peak, "sparsity": sparsity,
            "awq_s": awq_s, "awq_s_by_phase": timer.seconds, "awq_peak_gib": awq_peak,
            "awq_pairs": rec["pairs"], "awq_best_over_rtn_max": max(rec["best_over_rtn"]),
            "awq_best_over_rtn_median": sorted(rec["best_over_rtn"])[rec["pairs"] // 2],
            "awq_chosen_ratio_mean": sum(rec["chosen_ratio"]) / len(rec["chosen_ratio"]),
            "clip_groups": rec["clip_groups"], "clip_groups_clipped": rec["clipped"]}
    return cfg, qcfg, stack_model(fuse_model(params, cfg, qcfg)), info


def _layer0_error_ratios(cfg, qcfg, lp0, ctx0, calibrated):
    """||(W - Q)X||_F / ||(W - Q_rtn)X||_F for every linear of layer 0: W
    its original weight, X its inputs through the original layer 0 (float
    stream), Q_rtn RTN with the same quantizer, through
    H = 2/n X X^T: ||dW X||_F^2 = n/2 tr(dW H dW^T)."""
    from llm_compressor_tpu_torch.algorithms.common import (get_weight, slot_tap,
                                                            weight_quantizer_for)
    from llm_compressor_tpu_torch.capture import TAP_KEYS, accumulate_hessian
    from llm_compressor_tpu_torch.device import full_f32_matmul
    from llm_compressor_tpu_torch.models import layer_ops
    from llm_compressor_tpu_torch.models.transformer import arch_slots
    from llm_compressor_tpu_torch.qformats import quantize_dequant

    H = accumulate_hessian(ctx0, lp0, 0, TAP_KEYS, layer_ops(cfg, qcfg, 0))
    n, out = ctx0.hidden.shape[0], {}
    with full_f32_matmul():
        for s in arch_slots(cfg):
            W = get_weight(lp0, s)
            rtn_w = quantize_dequant(weight_quantizer_for(cfg, qcfg, 0, s), W) * (W != 0)

            def err(Q):
                d = W.float() - Q.float()
                return math.sqrt(n / 2 * float(((d @ H[slot_tap(s)]) * d).sum()))

            out[s] = {name: err(q[s]) / err(rtn_w) for name, q in calibrated.items()}
    return out


def calib_b_model_fn(name: str, seed: int, info: dict):
    """``build(layers)`` for ``check_reduced_depth``: one algorithm of the
    2-layer checks on random full-width weights from ``seed`` (Llama-3.2-1B,
    or BLOOM-560m from its published config), its corpus as the CLI takes
    it, packed losslessly with its scale book, fused, stacked. Each build
    records its seconds and peak memory in ``info``; the pruning ones
    check 50 % sparsity; GPTAQ's first build also records layer 0's output
    error against RTN's, beside a GPTQ run's on the same weights."""
    from llm_compressor_tpu_torch import algorithms as alg
    from llm_compressor_tpu_torch.capture import CalibContext
    from llm_compressor_tpu_torch.models import fuse_model, init_params, stack_model
    from llm_compressor_tpu_torch.qformats import build_quant_config

    def build(layers):
        qargs, head_act, _ = W4A8
        bloom = name == "smoothquant_bloom"
        cfg = arch_cfg("bloom_560m", layers) if bloom else flagship_cfg(layers)
        qcfg = build_quant_config(*qargs, head_act=head_act)
        params = init_params(cfg, seed=seed)
        book: dict = {}
        ctx = lambda corpus: calib_ctx(params, cfg, seed, corpus)
        keep = name == "gptaq" and "layer0_error_over_rtn" not in info
        if keep:
            c0 = ctx("wikitext2")
            lp0 = _clone_tree(params["layers"][0])
            ctx0 = CalibContext(cfg=cfg, hidden=c0.hidden.clone(), positions=c0.positions,
                                chunk=c0.chunk)
            twin = _clone_tree(params)

        def run():
            if name.startswith("smoothquant"):
                alg.smoothquant(params, cfg, ctx("pileval"), qcfg, alpha=SMOOTH_ALPHA,
                                scale_book=book)
            elif name == "awq_plus":
                alg.awq_plus(params, cfg, ctx("pileval"), ctx("wikitext2"), qcfg,
                             scale_book=book)
            elif name == "gptaq":
                alg.gptaq(params, cfg, c0 if keep else ctx("wikitext2"), qcfg, scale_book=book)
            else:
                if name == "sparsegpt":
                    alg.sparsegpt(params, cfg, ctx("c4"), SPARSITY, qcfg)
                elif name == "ria":
                    alg.ria(params, cfg, ctx("c4"), SPARSITY, 0.5, qcfg)
                else:
                    alg.magnitude(params, cfg, SPARSITY)
                info["sparsity"] = check_sparse(params, cfg, name)
                alg.rtn(params, cfg, qcfg, scale_book=book)

        _, info["calib_s"], info["calib_peak_gib"] = _measured(run)
        if keep:
            alg.gptq(twin, cfg, CalibContext(cfg=cfg, hidden=ctx0.hidden.clone(),
                                              positions=ctx0.positions, chunk=ctx0.chunk), qcfg)
            layer0 = lambda p: {s: w for (i, s), w in _linears(p, cfg).items() if i == 0}
            info["layer0_error_over_rtn"] = _layer0_error_ratios(
                cfg, qcfg, lp0, ctx0, {"gptaq": layer0(params), "gptq": layer0(twin)})
            del twin, lp0, ctx0
        pack_lossless(params, cfg, qcfg, book, name)
        return cfg, qcfg, stack_model(fuse_model(params, cfg, qcfg))

    return build


CALIB_B_CHECKS = ("smoothquant_llama", "smoothquant_bloom", "awq_plus", "gptaq", "sparsegpt",
                  "ria", "magnitude")


def phase_calibration_b(seed: int):
    """Phase 12: the ``wanda_awq_w4a8`` slice (``wanda_awq`` at full width
    and depth, served as ``phase_slice`` serves the flagship), then each
    algorithm of ``CALIB_B_CHECKS`` at 2 layers, kernel path against plain
    path (``check_reduced_depth(build=...)``)."""
    cfg, qcfg, params, info = wanda_awq(LAYERS, seed)
    torch.cuda.empty_cache()
    s = phase_slice(seed, W4A8, W4A8_KERNELS, model=(cfg, qcfg, params),
                    per_step=W4A8_APPEND_PER_STEP)
    del s["params"], params
    torch.cuda.empty_cache()
    out = {"slice": s | info, "checks": {}}
    for name in CALIB_B_CHECKS:
        rec: dict = {}
        names = BLOOM_KERNELS if name == "smoothquant_bloom" else W4A8_KERNELS
        checked, total, max_err, _ = check_reduced_depth(seed, W4A8, names,
                                                         build=calib_b_model_fn(name, seed, rec))
        out["checks"][name] = rec | {"confident_tokens_equal": checked, "tokens": total,
                                     "max_abs_logit_diff": max_err}
        torch.cuda.empty_cache()
    return out


def report_calibration_b(cb, smi: str) -> None:
    """Log phase 12's slice and 2-layer checks."""
    s = cb["slice"]
    log(f"slice wanda_awq_w4a8: Llama-3.2-1B, {LAYERS} layers, wanda({SPARSITY}) on {CALIB_SAMPLES} "
        f"x {CALIB_LEN} synthetic C4 tokens in {s['wanda_s']:.2f} s (peak {s['wanda_peak_gib']:.2f} "
        f"GiB; sparsity {s['sparsity']:.4f}, every linear >= {SPARSITY}), then awq W4A8 on the "
        f"pile-val stream in {s['awq_s']:.2f} s ({json.dumps(s['awq_s_by_phase'])}; peak "
        f"{s['awq_peak_gib']:.2f} GiB; {s['awq_pairs']} scale pairs, best loss / RTN's loss max "
        f"{s['awq_best_over_rtn_max']:.4f} median {s['awq_best_over_rtn_median']:.4f}, mean chosen "
        f"ratio {s['awq_chosen_ratio_mean']:.3f}; {s['clip_groups_clipped']}/{s['clip_groups']} "
        f"clip groups clipped, none above its unclipped error); packed losslessly, every code at a "
        f"Wanda zero the zero code; batch {BATCH}, prompt {PROMPT}: prefill (TTFT) "
        f"{s['ttft_ms']:.2f} ms, {STEPS} decode steps as one CUDA graph {s['decode_ms']:.2f} ms = "
        f"{s['decode_tok_s']:.1f} tok/s (first call {s['first_call_s']:.2f} s, capture "
        f"{s['capture_s']:.2f} s; eager loop {s['loop_decode_tok_s']:.1f} tok/s, tokens and cache "
        f"bitwise equal), peak memory {s['peak_mem_gib']:.2f} GiB on {smi}; launches "
        f"{s['counts']}, per decode step {s['per_step']}")
    log(f"slice wanda_awq_w4a8 decode profile (one replay of the {STEPS}-step graph, "
        f"torch.profiler): {json.dumps(s['profile'])}")
    for name, c in cb["checks"].items():
        log(f"calibration_b {name} at 2 layers (full width, {CALIB_SAMPLES} x {CALIB_LEN} "
            f"tokens): {c['calib_s']:.2f} s, peak {c['calib_peak_gib']:.2f} GiB"
            + (f", sparsity {c['sparsity']:.4f}" if "sparsity" in c else "")
            + "; packed losslessly; served W4A8: "
            f"{c['confident_tokens_equal']}/{c['tokens']} kernel-path tokens with a plain top-2 "
            f"gap > 0.1 equal the plain path's; max |logit diff| {c['max_abs_logit_diff']:.4g}"
            + ("" if "layer0_error_over_rtn" not in c else
               f"; layer 0 ||(W-Q)X|| / RTN's (reported): "
               f"{json.dumps(c['layer0_error_over_rtn'])}"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    # fails here, before any output, outside a checkout of the repo
    from llm_compressor_tpu_torch.kernels import _build

    t_start = time.perf_counter()
    device_name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"device: {device_name} x{count}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {len(_build.SOURCES)} sources in {time.perf_counter() - t0:.1f} s")
    for src in _build.SOURCES:
        for line in _build.ptxas_report(src).splitlines():
            log(f"build {src}: {line.strip()}")

    cases = phase_kernels(args.seed)

    calibrated: dict = {}

    def build_calibrated(layers):
        cfg, qcfg, params, info = calibrate_and_pack(layers, args.seed, keep_layer0=True)
        calibrated.update(info, cfg=cfg, qcfg=qcfg)
        return cfg, qcfg, params

    for label, serving, names, build, attention in (
            ("W4A8", W4A8, W4A8_KERNELS, None, "append"),
            ("W4A8 side-block two_part", W4A8, W4A8_MATMULS + SIDE_KERNELS["two_part"], None,
             "two_part"),
            ("W4A8 side-block hybrid", W4A8, W4A8_MATMULS + SIDE_KERNELS["hybrid"], None,
             "hybrid"),
            ("weight-only int4-g128 zp", WEIGHT_ONLY, ["B5_dequant_matmul"], None, "append"),
            ("weight-only fp8-e4m3-g128", WEIGHT_ONLY_FP8, ["B5_dequant_matmul"], None, "append"),
            ("SpinQuant-Hadamard + GPTQ, W4A8", W4A8, W4A8_KERNELS + ["B10_hadamard"],
             build_calibrated, "append")):
        checked, total, max_err, vs_b4 = check_reduced_depth(args.seed, serving, names,
                                                             build=build, attention=attention)
        log(f"reduced depth {label} (2 layers, full width): {checked}/{total} kernel-path "
            f"tokens with a plain top-2 gap > 0.1 equal the plain path's; max |logit diff| "
            f"{max_err:.4g}" + ("" if vs_b4 is None else
                                f"; against the in-place B4 path on the same tokens: "
                                f"{vs_b4['tokens_equal']}/{total} argmax tokens equal, "
                                f"{vs_b4['codes_differ_by_layer']} (by layer) of "
                                f"{vs_b4['codes']} merged-cache codes differ"))
    ratios = check_gptq_beats_rtn(calibrated, calibrated["cfg"], calibrated["qcfg"])
    log(f"GPTQ vs RTN, layer 0 (same rotated W, quantizer and calibration inputs): "
        f"||(W-Q_gptq)X|| / ||(W-Q_rtn)X|| = {json.dumps(ratios)}")
    log(f"calibration pass profile (layer 0, the down-proj group: 16 chunks of 8 x "
        f"{CALIB_LEN} tokens and its Hessian, torch.profiler): "
        f"{json.dumps(profile_calibration_pass(calibrated))}")
    # held on the host, so that the next slices' peak memory does not see it
    layer0_at_2_layers = {k: v.cpu() for k, v in calibrated["gptq_layer0"].items()}
    calibrated.clear()
    pr = compare_prefill_reduction(build_model(2, args.seed, WEIGHT_ONLY), WEIGHT_ONLY, 16, 32,
                                   args.seed)
    log(f"prefill reduction, weight-only int4-g128 zp at 2 layers (bf16 reduced-precision "
        f"reduction allowed vs full_f32_accumulation, reported only): {json.dumps(pr)}")

    slices = {}
    w4a8_model = None
    for key, label, serving, names, attention, per_step in (
            ("w4a8", "Llama-3.2-1B W4A8, int8 KV cache", W4A8, W4A8_KERNELS, "append",
             W4A8_APPEND_PER_STEP),
            ("w4a8_two_part", "the w4a8 slice's params, side-block two_part decode", W4A8,
             W4A8_MATMULS + SIDE_KERNELS["two_part"], "two_part",
             W4A8_PER_STEP | {"decode_attention": LAYERS, "fresh_write": LAYERS}),
            ("w4a8_hybrid", "the w4a8 slice's params, side-block hybrid decode", W4A8,
             W4A8_MATMULS + SIDE_KERNELS["hybrid"], "hybrid",
             W4A8_PER_STEP | {"decode_attention_stats": LAYERS, "fresh_write": LAYERS}),
            ("weight_only", "Llama-3.2-1B weight-only int4-g128 zp + int8-g128 head, bf16 KV "
             "cache", WEIGHT_ONLY, ["B5_dequant_matmul"], "append",
             {"dequant_matmul": B5_PER_STEP})):
        if key == "weight_only":   # the W4A8 slices and the B9 entry point are done
            actq = phase_actq(*w4a8_model, args.seed)
            log(f"B9 entry point w4a8_matmul(..., act_inside=True) (the w4a8 slice's int8 head "
                f"and layer-0 qkv, M = 128, equal to the host-quantised B3 path bitwise): "
                f"launches {actq['counts']}")
            served = phase_serving_engine(*w4a8_model, args.seed, smi)
            b, sp = served["batching"], served["speculative"]
            g = b["graph"]
            log(f"serving_engine batching: Llama-3.2-1B W4A8, {LAYERS} layers, int8 KV cache, "
                f"{SERVE_SLOTS} slots, max_len {SERVE_MAX_LEN}, chunk {SERVE_CHUNK}: "
                f"{SERVE_REQUESTS} requests ({b['prompt_tokens']} prompt tokens, "
                f"{SERVE_PROMPTS[0]}-{SERVE_PROMPTS[1]}), {g['generated']} greedy tokens in "
                f"{g['wall_s']:.2f} s = {g['requests_per_s']:.2f} requests/s, "
                f"{g['generated_tok_s']:.1f} tok/s; {g['decode_steps']} decode steps "
                f"({g['decode_ms_mean']:.2f} ms each) and {g['chunks']} chunk prefills "
                f"({g['chunk_prefill_ms_mean']:.2f} ms each), {g['host_ms_per_step']:.2f} host ms "
                f"per step; eager decode {b['eager']['generated_tok_s']:.1f} tok/s "
                f"({b['eager']['decode_ms_mean']:.2f} ms a step); ids of graph and eager "
                f"bitwise equal; EOS request ended after {b['eos_request_tokens']} tokens; "
                f"tokens agreeing with generate alone before the first difference, requests "
                f"1-{SERVE_STANDALONE}: {b['standalone_prefix']}, each call's seconds with "
                f"its graph (one per call, captured at step 2) "
                f"{[round(x, 3) for x in b['generate_first_call']['graph']['s']]} and eager "
                f"{[round(x, 3) for x in b['generate_first_call']['eager']['s']]}, ids equal; "
                f"peak memory {g['peak_mem_gib']:.2f} GiB on {smi}")
            for case in ("looping", "random", "forced_fallback"):
                r = sp[case]
                log(f"serving_engine speculative {case}: {SPEC_BATCH} prompts of "
                    f"{SPEC_MOTIF * SPEC_REPEAT} tokens, k_draft {SPEC_K}, {SPEC_ROUNDS} rounds "
                    f"a dispatch, {SPEC_NEW} new tokens, accept floor {r['accept_floor']}: "
                    f"mean_accepted "
                    f"{r['mean_accepted']:.3f} over {r['live_rounds']} live rounds, fell_back "
                    f"{r['fell_back']}; one call {r['tok_s']:.1f} tok/s with graphs, "
                    f"{r['eager_tok_s']:.1f} eager (ids and stats equal; peak added "
                    f"{r['extra_peak_gib']:.3f} and {r['eager_extra_peak_gib']:.3f} GiB), "
                    f"against greedy decode {r['greedy_first_call_tok_s']:.1f} tok/s at its "
                    f"first call on a cache (eager) and {r['greedy_replay_tok_s']:.1f} replayed; "
                    f"{r['tokens_equal_greedy']}/{r['tokens']} tokens "
                    f"({r['rows_equal_greedy']}/{SPEC_BATCH} rows) equal to greedy decode")
            log(f"serving_engine numbers: {json.dumps(served)}")
            w4a8_model = None
            torch.cuda.empty_cache()
        s = phase_slice(args.seed, serving, names, model=w4a8_model, attention=attention,
                        per_step=per_step)
        log(f"slice {key}: {label}, {LAYERS} layers, batch {BATCH}, prompt {PROMPT}, "
            f"max_len {MAX_LEN}: prefill (TTFT) {s['ttft_ms']:.2f} ms, {STEPS} decode steps as "
            f"one CUDA graph {s['decode_ms']:.2f} ms = {s['decode_tok_s']:.1f} tok/s (first call "
            f"on the cache, eager: {s['first_call_s']:.2f} s; second, the capture: "
            f"{s['capture_s']:.2f} s; graph key {s['key_us']:.1f} us; eager loop "
            f"{s['loop_decode_tok_s']:.1f} tok/s, "
            f"tokens and cache bitwise equal), peak memory {s['peak_mem_gib']:.2f} GiB "
            f"({s['allocated_before_gib']:.2f} GiB live before the prefill) on {smi}; "
            f"launches {s['counts']}, per decode step {s['per_step']}")
        log(f"slice {key} decode profile (one replay of the {STEPS}-step graph, "
            f"torch.profiler): {json.dumps(s['profile'])}")
        if key == "w4a8":
            w4a8_model = (s["cfg"], s["qcfg"], s["params"])
            s["prefill_profile"] = profile_prefill(*w4a8_model, serving, args.seed)
            log(f"slice w4a8 prefill profile ({BATCH} x {PROMPT} tokens, torch.profiler, "
                f"device ms by kernel family): {json.dumps(s['prefill_profile'])}")
        if key == "weight_only":
            s["prefill_reduction"] = compare_prefill_reduction(
                (s["cfg"], s["qcfg"], s["params"]), serving, BATCH, PROMPT, args.seed)
            log(f"prefill reduction, slice weight_only at {LAYERS} layers (TTFT both ways, "
                f"reported only): {json.dumps(s['prefill_reduction'])}")
            sampled = check_generate(s["params"], s["cfg"], s["qcfg"], args.seed)
            log(f"generate (weight-only, 4 prompts, top_k 50, temperature 0.8, seed "
                f"{args.seed}, twice, equal): {sampled}")
        del s["params"]
        torch.cuda.empty_cache()
        slices[key] = s

    s = slices["spinquant_gptq"] = phase_spinquant(args.seed, layer0_at_2_layers)
    del s["params"]
    torch.cuda.empty_cache()
    log(f"slice spinquant_gptq: Llama-3.2-1B, {LAYERS} layers, spinquant(mode='hadamard') + "
        f"GPTQ on {CALIB_SAMPLES} x {CALIB_LEN} synthetic tokens in {s['calib_s']:.2f} s "
        f"({json.dumps(s['phases'])}), peak memory {s['calib_peak_gib']:.2f} GiB, launches "
        f"{s['calib_counts']}; packed losslessly; served W4A8 with an int8 KV cache, batch "
        f"{BATCH}, prompt {PROMPT}: prefill (TTFT) {s['ttft_ms']:.2f} ms, {STEPS} decode steps "
        f"as one CUDA graph {s['decode_ms']:.2f} ms = {s['decode_tok_s']:.1f} tok/s (first call "
        f"{s['first_call_s']:.2f} s, capture {s['capture_s']:.2f} s; eager loop "
        f"{s['loop_decode_tok_s']:.1f} tok/s), peak memory "
        f"{s['peak_mem_gib']:.2f} GiB on {smi}; launches {s['counts']}, per decode step "
        f"{s['per_step']}")
    log(f"slice spinquant_gptq decode profile (one replay of the {STEPS}-step graph, "
        f"torch.profiler): "
        f"{json.dumps(s['profile'])}")

    ck = phase_checkpoint(args.seed, smi)
    log(f"checkpoint: Llama-3.2-1B, {LAYERS} layers, HF bf16 directory "
        f"{ck['hf_dir_bytes']} bytes written in {ck['hf_save_s']:.2f} s, loaded in "
        f"{ck['hf_load_s']:.2f} s (bitwise); RTN W4A8; save_compressed {ck['compressed_dir_bytes']} "
        f"bytes in {ck['compressed_save_s']:.2f} s, load_compressed in "
        f"{ck['compressed_load_s']:.2f} s; {ck['qtensors']} QTensors, {CKPT_BATCH} x "
        f"{CKPT_PROMPT} prompts + {CKPT_STEPS} greedy steps: tokens, int8 cache codes and "
        f"scales bitwise equal to the in-memory model's; peak memory "
        f"{ck['peak_mem_gib']:.2f} GiB on {smi}")
    log(f"checkpoint numbers: {json.dumps(ck)}")

    fm = phase_formats(args.seed)
    c = fm["mxfp8_reduced_depth"]
    log(f"formats, mxfp8_weight_only at 2 layers (full width): {c['confident_tokens_equal']}/"
        f"{c['tokens']} kernel-path tokens with a plain top-2 gap > 0.1 equal the plain "
        f"path's; max |logit diff| {c['max_abs_logit_diff']:.4g}")
    c = fm["nvfp4_packed_vs_fake"]
    log(f"formats, nvfp4_w4a4 at 2 layers (full width), packed vs fake-quantized weights: "
        f"{c['confident_tokens_equal']}/{c['tokens']} tokens with a top-2 gap > {NVFP4_GAP} "
        f"equal; relative L2 of the logits by step {[round(x, 5) for x in c['rel_l2_by_step']]} "
        f"(at most {NVFP4_REL_L2}); max |logit diff| {c['max_abs_diff']:.4g}")
    for key, s in fm["slices"].items():
        slices[key] = s
        log(f"slice {key}: Llama-3.2-1B {FORMATS[key]['qargs']}, w_mse {FORMATS[key]['mse']}, "
            f"MPQ {FORMATS[key]['mpq']}, {LAYERS} layers: RTN {s['rtn_s']:.2f} s (peak "
            f"{s['rtn_peak_gib']:.2f} GiB), packed losslessly (head re-packed, max |diff| "
            f"{s['head_max_abs_diff']:.4g}); batch {BATCH}, prompt {PROMPT}: prefill (TTFT) "
            f"{s['ttft_ms']:.2f} ms, {STEPS} decode steps as one CUDA graph {s['decode_ms']:.2f} "
            f"ms = {s['decode_tok_s']:.1f} tok/s (first call {s['first_call_s']:.2f} s, capture "
            f"{s['capture_s']:.2f} s; eager loop {s['loop_decode_tok_s']:.1f} tok/s, bitwise "
            f"equal), peak memory {s['peak_mem_gib']:.2f} GiB on {smi}; launches "
            f"{s['counts']}, per decode step {s['per_step']}")
        log(f"slice {key} decode profile (one replay of the {STEPS}-step graph, "
            f"torch.profiler): {json.dumps(s['profile'])}")
        if "mse_vs_rtn_layer0" in s:
            log(f"slice {key}: layer 0, MSE objective never above plain RTN's in any group; "
                f"||W - Q_mse|| / ||W - Q_rtn|| and clipped groups by linear: "
                f"{json.dumps(s['mse_vs_rtn_layer0'])}")

    ar = phase_archs(args.seed)
    s = slices["gemma2_2b_w4a8"] = ar["slice"]
    log(f"slice gemma2_2b_w4a8: Gemma-2-2B ({ARCH_CONFIGS['gemma2_2b'][0]}) W4A8, "
        f"{GEMMA2_LAYERS} layers, int8 KV cache, batch {BATCH}, prompt {PROMPT}, max_len "
        f"{MAX_LEN} (RTN -> pack -> fuse -> stack {s['build_s']:.2f} s): prefill (TTFT) "
        f"{s['ttft_ms']:.2f} ms, {STEPS} decode steps as one CUDA graph {s['decode_ms']:.2f} ms "
        f"= {s['decode_tok_s']:.1f} tok/s (first call {s['first_call_s']:.2f} s, capture "
        f"{s['capture_s']:.2f} s; eager loop {s['loop_decode_tok_s']:.1f} tok/s, tokens and "
        f"cache bitwise equal), peak memory {s['peak_mem_gib']:.2f} GiB on {smi}; launches "
        f"{s['counts']}, per decode step {s['per_step']}")
    log(f"slice gemma2_2b_w4a8 decode profile (one replay of the {STEPS}-step graph, "
        f"torch.profiler): {json.dumps(s['profile'])}")
    for mode, c in ar["window"].items():
        if mode == "window_bites":
            log(f"archs window check, Gemma-2-2B at 2 layers: without the window the kernel "
                f"path's logits equal the windowed run's bitwise at the first "
                f"{c['equal_before_4096']} positions (up to 4095) and differ at every later "
                f"one (max |diff| {c['max_abs_diff_from_4096']:.4g})")
            continue
        log(f"archs window check, Gemma-2-2B at 2 layers, {WINDOW_SHAPE[0]} slots, prompts of "
            f"{WINDOW_SHAPE[1]} + {WINDOW_SHAPE[2]} steps ({mode}): {c['confident_tokens_equal']}"
            f"/{c['tokens']} kernel-path tokens with a plain top-2 gap > 0.1 equal the plain "
            f"path's; max |logit diff| {c['max_abs_logit_diff']:.4g}"
            + ("" if "vs_b4" not in c else f"; against the in-place B4 path: "
               f"{c['vs_b4']['tokens_equal']}/{c['tokens']} tokens equal, "
               f"{c['vs_b4']['codes_differ_by_layer']} (by layer) of {c['vs_b4']['codes']} "
               f"merged-cache codes differ"))
    for fam, c in ar["families"].items():
        log(f"archs family {fam} ({c['source']}), 2 layers, W4A8, shape {c['shape']}: "
            f"{c['confident_tokens_equal']}/{c['tokens']} kernel-path tokens with a plain "
            f"top-2 gap > 0.1 equal the plain path's; max |logit diff| "
            f"{c['max_abs_logit_diff']:.4g}; graph {c['graph_decode_tok_s']:.1f} tok/s and eager "
            f"loop {c['eager_decode_tok_s']:.1f} tok/s, bitwise equal; replay launches "
            f"{c['replay_counts']}")

    ab = phase_archs_b(args.seed)
    s = slices["phi_2_w4a8"] = ab["slice"]
    log(f"slice phi_2_w4a8: Phi-2 ({ARCH_CONFIGS['phi_2'][0]}) W4A8, {PHI2_LAYERS} layers, "
        f"int8 KV cache, batch {BATCH}, prompt {PROMPT}, max_len {MAX_LEN} (RTN -> pack -> "
        f"fuse -> stack {s['build_s']:.2f} s): prefill (TTFT) {s['ttft_ms']:.2f} ms, {STEPS} "
        f"decode steps as one CUDA graph {s['decode_ms']:.2f} ms = {s['decode_tok_s']:.1f} "
        f"tok/s (first call {s['first_call_s']:.2f} s, capture {s['capture_s']:.2f} s; eager "
        f"loop {s['loop_decode_tok_s']:.1f} tok/s, tokens and cache bitwise equal), peak memory "
        f"{s['peak_mem_gib']:.2f} GiB on {smi}; launches {s['counts']}, per decode step "
        f"{s['per_step']}")
    log(f"slice phi_2_w4a8 decode profile (one replay of the {STEPS}-step graph, "
        f"torch.profiler): {json.dumps(s['profile'])}")
    for fam, c in ab["families"].items():
        for mode in ATTENTION_OF:
            m = c[mode]
            log(f"archs_b family {fam} ({c['source']}), 2 layers, W4A8, shape {c['shape']}, "
                f"{mode}: " + (f"{m['confident_tokens_equal']}/{m['tokens']} kernel-path tokens "
                               f"with a plain top-2 gap > 0.1 equal the plain path's; max "
                               f"|logit diff| {m['max_abs_logit_diff']:.4g}; "
                               if "tokens" in m else "")
                + f"graph {m['graph_decode_tok_s']:.1f} tok/s and eager loop "
                f"{m['eager_decode_tok_s']:.1f} tok/s, bitwise equal; replay launches "
                f"{m['replay_counts']}")
        if "head_dequant_matmul_ms" in c:
            log(f"archs_b family {fam}: {c['head_note']}: {c['head_dequant_matmul_ms']:.4f} ms "
                f"on {smi}")

    cb = phase_calibration_b(args.seed)
    slices["wanda_awq_w4a8"] = cb["slice"]
    report_calibration_b(cb, smi)

    metrics = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = lambda c: {k: c[k] for k in EXTRA_METRICS if k in c}
    runs = slices | {"actq_entry": actq}
    kernels = []
    for kname, cs in cases.items():
        run, field = SLICE_OF[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": TPU_KERNELS[kname], "launches": runs[run][field][COUNTER_OF[kname]],
            "launches_from": LAUNCHES_FROM[run],
            **{k: cs[0][k] for k in metrics}, "case": cs[0]["case"], **extra(cs[0]),
            "other_cases": [{"case": c["case"], **{k: c[k] for k in metrics}, **extra(c)}
                            for c in cs[1:]],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"slices": {k: _slice_numbers(v) for k, v in slices.items()},
                      "serving_engine": served,
                      "formats_checks": {k: v for k, v in fm.items() if k != "slices"},
                      "archs_checks": {"window": ar["window"], "families": ar["families"]},
                      "archs_b_checks": {"families": ab["families"]},
                      "calibration_b_checks": cb["checks"]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
