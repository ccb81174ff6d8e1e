"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed 0]

Phases (each prints a line; any failure exits non-zero):
1. device — card name, count, and nvidia-smi's name and power limit;
2. build — compile every kernel of ``llm_compressor_tpu_torch/csrc`` (one
   nvcc per source, all at once) and print ptxas register / smem use;
3. kernels — each kernel against its plain PyTorch version on the card at
   the flagship shapes, with its device time (CUDA events, L2 flushed
   before each launch, host work queued ahead of the window), the plain
   version's time, one PyTorch library call's time for the same function,
   and the bound: max(bytes / 3.35 TB/s, int8 ops / 1979 TOP/s) from the
   published H100 SXM peaks;
4. slice — full-width, full-depth Llama-3.2-1B W4A8 (random weights from
   ``--seed``): RTN -> pack -> fuse -> stack, prefill 128 prompts of 128
   tokens into an int8 cache of 256 positions, then 32 greedy decode steps;
   every kernel's launch counter must move. At 2 layers, full width, the
   kernel path's greedy tokens must equal the plain path's wherever the
   plain logits' top-2 gap exceeds the stated tolerance. Two more decode
   steps run under ``torch.profiler`` for the device time by kernel and the
   idle share.
The ``kernels`` JSON object and nvidia-smi's name and power limit come on
the two lines before the last; the last is ``{"ok": true, "device": {...},
"slice": {...}}``, the slice's TTFT, decode tok/s and peak memory included.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak, same source
# the slice: Llama-3.2-1B at full depth, the serving shape of the flagship bench
LAYERS, BATCH, PROMPT, MAX_LEN, STEPS = 16, 128, 128, 256, 32
TPU_KERNELS = {
    "B1_w4a8_stacked": "llm_compressor_tpu/kernels/w4a8_matmul.py:405",
    "B2_w4a8_gateup_silu": "llm_compressor_tpu/kernels/w4a8_matmul.py:517",
    "B3_w4a8_flat": "llm_compressor_tpu/kernels/w4a8_matmul.py:353",
    "B4_decode_attention_append": "llm_compressor_tpu/kernels/decode_attention.py:469",
}
COUNTER_OF = {"B1_w4a8_stacked": "w4a8_stacked", "B2_w4a8_gateup_silu": "w4a8_gateup",
              "B3_w4a8_flat": "w4a8_flat",
              "B4_decode_attention_append": "decode_attention_append"}
SOURCES = {"B1_w4a8_stacked": "llm_compressor_tpu_torch/csrc/w4a8_matmul.cu",
           "B2_w4a8_gateup_silu": "llm_compressor_tpu_torch/csrc/w4a8_matmul.cu",
           "B3_w4a8_flat": "llm_compressor_tpu_torch/csrc/w4a8_matmul.cu",
           "B4_decode_attention_append": "llm_compressor_tpu_torch/csrc/decode_attention.cu"}


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


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
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


def check_w4a8(gen, label, kind, M, N, C, wfmt):
    """One W4A8 case; ``kind`` is 'stacked', 'flat' or 'gateup' (N = 2I)."""
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
        run = lambda: wm.matmul_stacked(x_i8, codes, scales, sx, 1, wfmt, bf)
        plain = lambda: wm.w4a8_plain(x_i8, codes[1], scales[1], sx, wfmt, bf)
        n_out = N
    elif kind == "flat":
        c0, s0 = codes[0], scales[0]
        run = lambda: wm.matmul_flat(x_i8, c0, s0, sx, wfmt, bf)
        plain = lambda: wm.w4a8_plain(x_i8, c0, s0, sx, wfmt, bf)
        n_out = N
    else:
        run = lambda: wm.gateup_silu(x_i8, codes, scales, sx, 1, wfmt, "silu", bf)
        plain = lambda: wm.gateup_plain(x_i8, codes[1], scales[1], sx, wfmt, "silu", bf)
        n_out = N // 2
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if kind == "gateup":
        # f32 activation epilogue: expf and torch's exp may round one bf16
        # ulp apart
        ok = bool((err <= want.float().abs() * 2.0 ** -7 + 1e-6).all())
        tol = "1 bf16 ulp"
    else:
        ok = bool((err == 0).all())
        tol = "bitwise"
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with plain (max err {float(err.max())})")
    wbytes = codes[0].numel() + scales[0].numel() * 4
    nbytes = x_i8.numel() + sx.numel() * 4 + wbytes + M * n_out * 2
    ops = 2.0 * M * N * C
    b_ms, b_by = bound(nbytes, ops)
    w_bf = torch.randn((N, C), generator=gen, device="cuda").to(bf)
    case = {
        "case": label, "M": M, "N": N, "C": C, "tolerance": tol,
        "max_abs_err": float(err.max()),
        "ms": time_ms(run), "plain_ms": time_ms(plain, reps=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.matmul(x, w_bf.t())),
    }
    del codes, scales, w_bf
    return case


def check_decode_attention(gen, B=128, KV=8, r=4, D=64, S=256, pos=144):
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
    scale = D ** -0.5
    bufs = [t.clone() for t in (kc, vc, ks, vs)]
    got = da.decode_attention_append(q, nk, nv, nks, nvs, *bufs, p, scale=scale)
    ref_bufs = [t.clone() for t in (kc, vc, ks, vs)]
    want = da.decode_attention_plain(q, nk, nv, nks, nvs, *ref_bufs, p, scale=scale)
    torch.cuda.synchronize()
    for a, b in zip(bufs, ref_bufs):
        if not torch.equal(a, b):
            raise AssertionError("B4: written cache differs from the plain version")
    err = (got - want).abs()
    ulps = 4 * torch.finfo(torch.float32).eps * want.abs() + 1e-7
    flip = float(vs.max())  # one flipped prob code moves an output by <= max v_scale
    if not bool((err <= ulps + flip).all()) or float((err > ulps).float().mean()) > 0.01:
        raise AssertionError(f"B4: kernel disagrees with plain (max err {float(err.max())})")
    n = pos + 1
    nbytes = (q.numel() * 4 + 2 * B * KV * (D + 4)          # q, new token
              + 2 * B * KV * n * (D + 4)                   # K/V window codes + scales
              + 2 * B * KV * (D + 4) + got.numel() * 4)    # token written, out
    ops = 2.0 * 2 * B * KV * r * n * D
    b_ms, b_by = bound(nbytes, ops)
    kd = (kc.float() * ks[..., None]).to(torch.bfloat16)   # dequantized (B, KV, S, D)
    vd = (vc.float() * vs[..., None]).to(torch.bfloat16)
    qh = q.reshape(B, KV * r, 1, D).to(torch.bfloat16)
    mask = (torch.arange(S, device="cuda") <= pos)[None, None, None, :]
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=mask, enable_gqa=True)
    run = lambda: da.decode_attention_append(q, nk, nv, nks, nvs, *bufs, p, scale=scale)
    plain = lambda: da.decode_attention_plain(q, nk, nv, nks, nvs, *ref_bufs, p, scale=scale)
    return {"case": f"decode B={B} KV={KV} r={r} D={D} S={S} pos={pos}",
            "tolerance": "codes bitwise; f32 ulps + one prob code on <= 1% of outputs",
            "max_abs_err": float(err.max()), "ms": time_ms(run),
            "plain_ms": time_ms(plain, reps=3, warmup=1), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": time_ms(lib)}


def phase_kernels(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    E, I, V = 2048, 8192, 128256
    cases = {
        "B1_w4a8_stacked": [
            check_w4a8(gen, "decode qkv", "stacked", 128, 3072, E, 1),
            check_w4a8(gen, "decode o", "stacked", 128, E, E, 1),
            check_w4a8(gen, "decode down", "stacked", 128, E, I, 1)],
        "B2_w4a8_gateup_silu": [check_w4a8(gen, "decode gate|up", "gateup", 128, 2 * I, E, 1)],
        "B3_w4a8_flat": [
            check_w4a8(gen, "decode int8 head", "flat", 128, V, E, 0),
            check_w4a8(gen, "prefill qkv 128x128 rows", "flat", 128 * 128, 3072, E, 1)],
        "B4_decode_attention_append": [check_decode_attention(gen)],
    }
    for name, cs in cases.items():
        for c in cs:
            log(f"kernel {name} [{c['case']}]: max_abs_err={c['max_abs_err']} "
                f"({c['tolerance']}) ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
                f"bound_ms={c['bound_ms']:.4f} ({c['bound_by']}) "
                f"library_ms={c['library_ms']:.4f}")
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


def build_model(layers: int, seed: int):
    from llm_compressor_tpu_torch.algorithms import pack_model, rtn
    from llm_compressor_tpu_torch.models import fuse_model, init_params, stack_model
    from llm_compressor_tpu_torch.qformats import build_quant_config

    cfg = flagship_cfg(layers)
    qcfg = build_quant_config("int4-g[128]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw",
                              head_act="int8-g[-1]-rw")
    params = init_params(cfg, seed=seed)
    rtn(params, cfg, qcfg)
    pack_model(params, cfg, qcfg)
    params = stack_model(fuse_model(params, cfg, qcfg))
    return cfg, qcfg, params


@contextlib.contextmanager
def plain_kernels():
    """Route the four kernel wrappers to their plain versions (CUDA
    tensors included) — the reference run of the reduced-depth check."""
    from llm_compressor_tpu_torch.engine import generate as gen_mod
    from llm_compressor_tpu_torch.kernels import decode_attention as da
    from llm_compressor_tpu_torch.kernels import w4a8_matmul as wm

    saved = (wm.matmul_stacked, wm.matmul_flat, wm.gateup_silu, gen_mod.decode_attention_append)
    wm.matmul_stacked = lambda x, c, s, sx, layer, f, dt: wm.w4a8_plain(x, c[layer], s[layer], sx, f, dt)
    wm.matmul_flat = wm.w4a8_plain
    wm.gateup_silu = lambda x, c, s, sx, layer, f, act, dt: wm.gateup_plain(
        x, c[layer], s[layer], sx, f, act, dt)
    gen_mod.decode_attention_append = da.decode_attention_plain
    try:
        yield
    finally:
        wm.matmul_stacked, wm.matmul_flat, wm.gateup_silu, gen_mod.decode_attention_append = saved


def run_slice(params, cfg, qcfg, batch, prompt, steps, max_len, seed):
    from llm_compressor_tpu_torch.engine import decode_greedy_steps, init_cache, prefill

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device="cuda",
                         dtype=torch.int32)
    cache = init_cache(cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, toks, cache, cfg=cfg, qcfg=qcfg)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out, cache = decode_greedy_steps(params, tok, cache, n=steps, cfg=cfg, qcfg=qcfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return logits, out, cache, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def check_reduced_depth(seed: int, gap_tol: float = 0.1):
    """2 layers, full width: teacher-force the plain path's greedy tokens
    through both paths; where the plain logits' top-2 gap exceeds
    ``gap_tol`` the kernel path's argmax must be the same token."""
    from llm_compressor_tpu_torch.engine import decode_step, init_cache, prefill

    cfg, qcfg, params = build_model(2, seed)
    B, T, steps = 16, 32, 8
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device="cuda",
                         dtype=torch.int32)

    def run(feed=None):
        cache = init_cache(cfg.num_layers, B, 64, cfg.num_kv_heads, cfg.head_dim)
        logits, cache = prefill(params, toks, cache, cfg=cfg, qcfg=qcfg)
        all_logits = [logits]
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        for i in range(steps):
            if feed is not None:
                tok = feed[i]
            logits, cache = decode_step(params, tok, cache, cfg=cfg, qcfg=qcfg)
            all_logits.append(logits)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        return all_logits

    from llm_compressor_tpu_torch import kernels

    kernels.reset_counts()
    with plain_kernels():
        ref = run()
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"the plain run launched kernels: {kernels.launch_counts()}")
    feed = [torch.argmax(lg, -1).to(torch.int32)[:, None] for lg in ref[:-1]]
    got = run(feed)
    if not all(kernels.launch_counts().values()):
        raise AssertionError(f"the kernel run missed a kernel: {kernels.launch_counts()}")
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
    del params
    return checked, (steps + 1) * B, max_err


def _kernel_class(name: str) -> str:
    if "decode_attention" in name:
        return "B4"
    if "w4a8_kernel" in name:  # template argument NW: 2 is the fused gate|up
        return "B2" if ("Li2EEEv" in name or ", 2>" in name) else "B1/B3"
    return "other"


def profile_decode(params, cfg, qcfg, cache, token, steps: int = 2):
    """Device time per decode step by kernel class, and the device's idle
    share of the wall-clock window, from a ``torch.profiler`` trace of
    ``steps`` greedy steps (the profiler's own host cost is inside the
    window, so the idle share reads high)."""
    from torch.profiler import ProfilerActivity, profile

    from llm_compressor_tpu_torch.engine import decode_greedy_steps

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_greedy_steps(params, token, cache, n=steps, cfg=cfg, qcfg=qcfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_class = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        k = _kernel_class(e.name)
        by_class[k] = by_class.get(k, 0.0) + (b - a) / 1e3 / steps
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # union of the device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    if not spans:
        return {"device_ms_per_step": "not measured", "idle_share": "not measured",
                "wall_ms_per_step": wall_ms / steps}
    return {"wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "device_ms_per_step": {k: round(v, 4) for k, v in sorted(by_class.items())}}


def phase_slice(seed: int):
    from llm_compressor_tpu_torch import kernels

    cfg, qcfg, params = build_model(LAYERS, seed)
    # warm the allocator, cuBLAS and the kernel libraries at a small batch
    run_slice(params, cfg, qcfg, batch=8, prompt=16, steps=2, max_len=64, seed=seed)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    logits, out, cache, ttft_ms, dec_ms = run_slice(
        params, cfg, qcfg, batch=BATCH, prompt=PROMPT, steps=STEPS, max_len=MAX_LEN,
        seed=seed)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(logits).all()) or logits.shape != (BATCH, cfg.vocab_size):
        raise AssertionError("prefill logits are not finite (batch, vocab)")
    if out.shape != (BATCH, STEPS) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError("decoded tokens out of range")
    if not bool((cache.lengths == PROMPT + STEPS).all()):
        raise AssertionError("cache lengths did not advance")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    prof = profile_decode(params, cfg, qcfg, cache, out[:, -1:])
    del params, cache
    torch.cuda.empty_cache()
    return {"counts": counts, "ttft_ms": ttft_ms, "decode_ms": dec_ms,
            "decode_tok_s": BATCH * STEPS / (dec_ms / 1e3),
            "peak_mem_gib": peak / 2 ** 30, "profile": prof}


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
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"device: {name} x{count}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {len(_build.SOURCES)} sources in {time.perf_counter() - t0:.1f} s")
    for src in _build.SOURCES:
        for line in _build.ptxas_report(src).splitlines():
            log(f"build {src}: {line.strip()}")

    cases = phase_kernels(args.seed)

    checked, total, max_err = check_reduced_depth(args.seed)
    log(f"reduced depth (2 layers, full width): {checked}/{total} kernel-path tokens with "
        f"a plain top-2 gap > 0.1 equal the plain path's; max |logit diff| {max_err:.4g}")

    s = phase_slice(args.seed)
    log(f"slice: Llama-3.2-1B W4A8, {LAYERS} layers, batch {BATCH}, prompt {PROMPT}, "
        f"max_len {MAX_LEN}: prefill (TTFT) {s['ttft_ms']:.2f} ms, {STEPS} decode steps "
        f"{s['decode_ms']:.2f} ms = {s['decode_tok_s']:.1f} tok/s, peak memory "
        f"{s['peak_mem_gib']:.2f} GiB on {smi}; launches {s['counts']}")
    log(f"decode profile (2 steps, torch.profiler): {json.dumps(s['profile'])}")

    metrics = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for kname, cs in cases.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": TPU_KERNELS[kname], "launches": s["counts"][COUNTER_OF[kname]],
            **{k: cs[0][k] for k in metrics}, "case": cs[0]["case"],
            "other_cases": [{"case": c["case"], **{k: c[k] for k in metrics}}
                            for c in cs[1:]],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    prof = s["profile"]
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count},
                      "slice": {"ttft_ms": s["ttft_ms"], "decode_tok_s": s["decode_tok_s"],
                                "peak_mem_gib": s["peak_mem_gib"],
                                "device_busy_ms_per_step": prof.get("device_busy_ms_per_step"),
                                "wall_ms_per_step": prof["wall_ms_per_step"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
