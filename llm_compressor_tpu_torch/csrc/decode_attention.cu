// int8-KV decode attention for Hopper (sm_90a): kernels B4, B6, B7, B8.
//
// Replaces in llm_compressor_tpu/kernels/decode_attention.py (shared body
// _slot_attention :71, _row_quant_i8 :62):
//   B4 _call_append (:469; body _kernel_append :363) fused-append attention
//   B7 _call        (:605; body _kernel :117)        read-only [main | side]
//   B6 _call_stats  (:225; body _kernel_stats :150)  main part + coupling stats
//   B8 _call_write  (:308; body _kernel_write :288)  one token into the side block
// The TPU kernel of B4 kept the main cache read-only and merged the current
// token from a side block; here the cache is written in place, which the
// JAX package shows gives bitwise the same tokens and codes. B6-B8 serve
// the side-block decode, which keeps the main cache read-only and the
// call's new tokens in a side block of W lanes, (B, KV, W, D) per layer.
//
// The function. One CTA per (slot, kv head) for B4, B6 and B7. It
//   1. row-quantises the r query rows of its head group to int8
//      (absmax * (1/127), clamped at 1e-8, round half to even) — B6 takes
//      the codes as input,
//   2. (B4 only) stores the current token's K/V codes and scales at pos,
//   3. scores the n kept keys of its window: exact int32 dots, then
//      ((s32 * qs) * ks) * scale, then the optional softcap,
//   4. runs the exact two-pass softmax with the normalisation folded into
//      the output scale: m = rowmax, e = exp(s - m), w = e * v_scale,
//      a = max(rowmax(w) * (1/127), 1e-8), pi = clip(rint(w / a), +-127);
//      B6 couples m and a with the side part's statistics (m_f, wfm),
//   5. takes the int32 P.V dot and writes out = o32 * (a / sum(e)) — B6
//      writes o32, m, a and the main part's sum instead.
// Masked lanes of the TPU kernels (score -1e9) contribute exp(-1e9 - m) =
// 0 and a zero prob code, so scoring only the kept rows is the same
// function; the row max starts at -1e9 where a part has masked lanes, as
// the TPU kernels' max over every lane does. B7 with no kept lane at all
// attends uniformly over every lane at -1e9, as the TPU kernel does.
// Built without fast math: rintf, IEEE division and expf keep the int8
// codes those of the plain version. The scales multiply by the f32
// reciprocal of 127, as the JAX kernels do under jit (XLA rewrites their
// division by the constant), and the plain version writes out. The row
// max, a and every prob code depend on no summation order; only sum(e)
// does (per-thread, then warp, then warp-order partial sums, fixed).
//
// What bounds it on this card (H100 SXM, 3.35 TB/s): the bytes of the
// window, (D + 4) * 2 per kept token per kv head (K and V codes, their
// scales); at the flagship step (B=128, KV=8, D=64, about 145 kept rows)
// about 20 MB a layer, 6-7 us. The operations (4 r D per key) are two
// orders below the int8 peak. So the design is about keeping bytes moving:
//   * one window = a chain of chunks of CK = 64 keys, first K's chunks,
//     then V's; each chunk's rows go to shared memory by 16-byte cp.async
//     (each part's rows one contiguous run, rows unpadded: ldmatrix's bank
//     conflicts cost less than a row-by-row copy loop; 4-byte pieces where
//     D % 16 != 0), in a ring of STAGES = 4 chunks. The first three chunks are in
//     flight before the CTA quantises q, and V's chunks stream while Q.K
//     and the softmax run; one barrier per chunk. Each byte of the window
//     is read once;
//   * shared memory is fixed by (r, D), whatever the cache length: the
//     ring, the q codes and a resident window of cap keys (f32 scores, v
//     scales, prob codes). A window longer than cap keeps its f32 scores
//     in a global scratch (r * (S + W) floats per CTA) that the wrapper
//     allocates only when S + W > cap (kernels/decode_attention.py::plan);
//     at the flagship shape 25,792 bytes: 8 CTAs per SM, one wave of 1,024;
//   * Q.K on the int8 tensor cores: mma.sync m16n8k32 s8, 16 keys (one
//     warp's m-tile of a chunk, through ldmatrix) by the r
//     query rows padded to 8, k-steps of 32 over D (q codes zero-padded);
//   * P.V on the int8 tensor cores too: m16n8k32 with 16 columns of V as
//     M, the query rows as N and 32 keys as K; V's rows are read
//     transposed by ldmatrix.trans and byte permutes, and the prob codes
//     are stored in the key order that gives (pi_slot). Each warp owns
//     whole columns over every key, so no partial sums meet;
//   * the q rows (and B6's statistics) are copied before the CTA reads its
//     position, and B4's new token is loaded then too, so the window's
//     address is the only round trip before the copies start;
//   * B4 takes its own token's codes straight from new_k / new_v (the same
//     cp.async), so nothing reads back the row it writes.
// What holds it now is the CTA's chain of phases and barriers, not bytes
// (tools/attention_phases.py; PERF.md section 6).
// B8 moves 2 (D + 4) bytes per (slot, head): a launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "phase_stamps.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int RMAX = 8;
constexpr int DMAX = 256;
constexpr int CK = 64;      // keys per chunk: one 16-key m-tile per warp
constexpr int STAGES = 4;   // chunks in the ring
constexpr float kInv127 = 1.0f / 127.0f;
constexpr float kNegInf = -1e9f;  // the TPU kernels' mask value

// Dynamic shared memory of one CTA (byte offsets), for r query rows, head
// dim D and a resident window of cap keys. kernels/decode_attention.py::
// plan computes the same total; the launchers check that they agree.
struct Layout {
  int pitch;   // bytes per K/V row in a chunk: D rounded up to 16
  int stage;   // one chunk: CK rows, then CK f32 k scales
  int qpitch;  // bytes per q-code row: an odd multiple of 16
  int qi;      // 8 rows of q codes at qpitch, zero past r and D
  int sc;      // (r, cap) f32 scores, then w = e * v_scale; first the staged
               // q: (r, D) f32, or B6's codes, then 3 x 8 floats
  int vs;      // (cap,) f32 v scales of the window
  int pi;      // (r, pip) int8 prob codes, keys in pi_slot order
  int pip;     // bytes per prob-code row: cap + 16
  int total;
};

__host__ __device__ inline Layout layout(int r, int D, int cap) {
  Layout L;
  L.pitch = (D + 15) / 16 * 16;
  L.stage = CK * (L.pitch + 4);
  L.qpitch = (D + 31) / 32 * 32 + 16;
  L.qi = STAGES * L.stage;
  L.sc = L.qi + 8 * L.qpitch;
  L.vs = L.sc + (r * cap * 4 > r * D * 4 + 96 ? r * cap * 4 : r * D * 4 + 96);
  L.pi = L.vs + cap * 4;
  L.pip = cap + 16;
  L.total = L.pi + r * L.pip;
  return L;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One part of a window: pointers at its first kept row.
struct Part {
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
};

// The n kept keys of one (slot, kv head): keys [0, n1) are the rows of p1,
// keys [n1, n) the rows of p2 (B7's side block, B4's new token).
struct Window {
  Part p1, p2;
  int n1, n;
  __device__ const int8_t* row(bool v, int t, int D) const {
    return t < n1 ? (v ? p1.v : p1.k) + (long)t * D : (v ? p2.v : p2.k) + (long)(t - n1) * D;
  }
  __device__ const float* scale(bool v, int t) const {
    return t < n1 ? (v ? p1.vs : p1.ks) + t : (v ? p2.vs : p2.ks) + (t - n1);
  }
};

enum Mode { APPEND, TWO_PART, STATS };

// Phase stamps (phase_stamps.cuh, tools/attention_phases.py): SM clocks at
// the phase boundaries and spent in the copy waits.
enum Stamp { ST_SM, ST_T0, ST_T1, ST_ENTRY, ST_WINDOW, ST_ISSUED, ST_PROLOGUE, ST_QK,
             ST_QK_WAIT, ST_SOFTMAX, ST_PV, ST_PV_WAIT, ST_END };

// Per-CTA outputs, at this CTA's offsets.
struct Io {
  float* out;                      // (r, D): out, or o32 (B6)
  float* m; float* a; float* sum;  // (r,) B6
};

// A 32-key block of prob codes is stored with key 16h + 8q + 2u + v at
// slot 16h + 4u + 2q + v: the order in which the P.V fragments below see
// the keys, so that a lane's B word is one 4-byte load.
__device__ __forceinline__ int pi_slot(int k) {
  return (k & 16) | ((k & 6) << 1) | ((k & 8) >> 2) | (k & 1);
}

// Copies this CTA's query rows into shared memory (the layout's ``sc``)
// and commits them as one cp.async group, before the kernel knows its
// window: (r, D) f32 q, or B6's (r, D) codes, then its scales, m_f and wfm
// (8 floats each).
template <Mode MODE>
__device__ __forceinline__ void stage_q(const void* q, const float* qs, const float* m_f,
                                        const float* wfm, int r, int D, int cap) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* qf = smem + layout(r, D, cap).sc;
  const int8_t* src = static_cast<const int8_t*>(q);
  if (MODE == STATS) {
    for (int w = threadIdx.x; w < r * D / 4; w += THREADS) cp_async4(qf + 4 * w, src + 4 * w);
    if (threadIdx.x < r) {
      float* f = reinterpret_cast<float*>(qf + r * D * 4);
      cp_async4(f + threadIdx.x, qs + threadIdx.x);
      cp_async4(f + 8 + threadIdx.x, m_f + threadIdx.x);
      cp_async4(f + 16 + threadIdx.x, wfm + threadIdx.x);
    }
  } else {
    for (int w = threadIdx.x; w < r * D / 4; w += THREADS) cp_async16(qf + 16 * w, src + 16 * w);
  }
  cp_async_commit();
}

// Steps 1-5 for one CTA, after stage_q. ``scratch`` is this CTA's (r, ldg)
// f32 score rows in global memory, used when n > cap (null otherwise);
// ``m0`` starts the row max; ``none_kept`` scores every key at -1e9.
template <Mode MODE, int R, int MW>
__device__ __forceinline__ void attend(const Window& win, const Io& io, int r, int D, int cap,
                                       bool vec, float* scratch, int ldg, float m0,
                                       bool none_kept, float scale, float softcap,
                                       int has_softcap) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ float qs_s[RMAX], m_s[RMAX], a_s[RMAX], osc_s[RMAX], mf_s[RMAX], wfm_s[RMAX];
  __shared__ float red0[NWARPS][RMAX], red1[NWARPS][RMAX];

  const Layout L = layout(r, D, cap);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tg = lane % 4;
  const int n = win.n, nc = (n + CK - 1) / CK;
  const bool resident = n <= cap;
  float* sb = resident ? reinterpret_cast<float*>(smem + L.sc) : scratch;
  const int ld = resident ? cap : ldg;
  float* vs_s = reinterpret_cast<float*>(smem + L.vs);
  int8_t* qi_s = smem + L.qi;
  int8_t* pi_s = smem + L.pi;
  const float* qf = reinterpret_cast<const float*>(smem + L.sc);  // stage_q's
  const float* stat = qf + r * D;  // B6: qs, m_f, wfm at 0, 8, 16

  // item j < nc: K chunk j; nc <= j < 2 nc: V chunk j - nc; into stage j %
  // STAGES (the P.V loop issues V chunks only, so that K's pointers die
  // there). With 16-byte copies a chunk's rows of each part are one
  // contiguous run of bytes; with 4-byte copies a thread takes pieces (row
  // t, piece p) from (tid / per, tid % per) on, THREADS pieces apart.
  const int per = D / 4;
  const int t_first = tid / per, p_first = tid % per;
  const int t_step = THREADS / per, p_step = THREADS % per;
  auto chunk = [&](bool isv, int j) {
    const int t0 = (isv ? j - nc : j) * CK, nv = min(CK, n - t0);
    int8_t* st = smem + (j % STAGES) * L.stage;
    if (vec) {
      const int a = max(0, min(nv, win.n1 - t0));  // rows of part 1
      const int8_t* s1 = win.row(isv, t0, D);
      for (int i = tid; i < a * D / 16; i += THREADS) cp_async16(st + 16 * i, s1 + 16 * i);
      if (a < nv) {
        const int8_t* s2 = win.row(isv, t0 + a, D);
        int8_t* d2 = st + a * D;
        for (int i = tid; i < (nv - a) * D / 16; i += THREADS)
          cp_async16(d2 + 16 * i, s2 + 16 * i);
      }
    } else {
      for (int t = t_first, p = p_first; t < nv;) {
        cp_async4(st + t * L.pitch + 4 * p, win.row(isv, t0 + t, D) + 4 * p);
        t += t_step;
        p += p_step;
        if (p >= per) {
          p -= per;
          ++t;
        }
      }
    }
    if (!isv)
      for (int t = tid; t < nv; t += THREADS)
        cp_async4(st + CK * L.pitch + 4 * t, win.scale(false, t0 + t));
  };
  auto issue = [&](int j) {
    if (j < nc) chunk(false, j);
    else if (j < 2 * nc) chunk(true, j);
  };

  // the window's copies: the resident window's v scales, then STAGES - 1
  // chunks; each chunk's step refills the stage its predecessor freed, so
  // one barrier per chunk serves both
  STAMP(ST_WINDOW, CLOCK());
  if (resident)
    for (int t = tid; t < n; t += THREADS) cp_async4(vs_s + t, win.scale(true, t));
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    issue(j);
    cp_async_commit();
  }
  STAMP(ST_ISSUED, CLOCK());
  cp_async_wait<STAGES - 1>();  // stage_q's group, the oldest
  __syncthreads();

  // 1. the q codes, zero past r and D (one warp per row)
  const int DP = (D + 31) / 32 * 32;
  for (int i = warp; i < 8; i += NWARPS) {
    int8_t* row = qi_s + i * L.qpitch;
    if (i >= r) {
      for (int d = lane; d < DP; d += 32) row[d] = 0;
    } else if (MODE == STATS) {
      const int8_t* qc = reinterpret_cast<const int8_t*>(qf) + i * D;
      for (int d = lane; d < DP; d += 32) row[d] = d < D ? qc[d] : int8_t(0);
      if (lane == 0) {
        qs_s[i] = stat[i];
        mf_s[i] = stat[8 + i];
        wfm_s[i] = stat[16 + i];
      }
    } else {
      const float* qr = qf + i * D;
      float amax = 0.0f;
      for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(qr[d]));
      amax = warp_max(amax);
      const float s = fmaxf(amax * kInv127, 1e-8f);
      if (lane == 0) qs_s[i] = s;
      for (int d = lane; d < DP; d += 32)
        row[d] = d < D ? int8_t(fminf(fmaxf(rintf(qr[d] / s), -127.0f), 127.0f)) : int8_t(0);
    }
  }

  // 3. scores on the tensor cores, chunk by chunk: m16n8k32 with 16 keys
  // as M (warp w's m-tile is keys 16 w .. 16 w + 15 of the chunk) and the
  // query rows as N; a lane's fragment rows are keys g and g + 8, its
  // columns query rows 2 tg, 2 tg + 1
  float mx0 = -INFINITY, mx1 = -INFINITY;
  long long waited = 0, c0 = CLOCK();
  STAMP(ST_PROLOGUE, c0);
  int j = 0;
  for (; j < nc; ++j) {
    c0 = CLOCK();
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    waited += CLOCK() - c0;
    issue(j + STAGES - 1);
    cp_async_commit();
    const int8_t* st = smem + (j % STAGES) * L.stage;
    const int t0 = j * CK, nv = min(CK, n - t0);
    if (16 * warp < nv) {
      int acc[4] = {0, 0, 0, 0};
      const int8_t* a_at = st + (16 * warp + lane % 16) * L.pitch + (lane / 16) * 16;
      const int8_t* b_at = qi_s + g * L.qpitch + tg * 4;
      for (int k0 = 0; k0 < D; k0 += 32) {
        uint32_t a[4], b[2];
        ldmatrix_x4(a, a_at + k0);
        b[0] = *reinterpret_cast<const uint32_t*>(b_at + k0);
        b[1] = *reinterpret_cast<const uint32_t*>(b_at + k0 + 16);
        mma_s8(acc, a, b);
      }
      const float* ks = reinterpret_cast<const float*>(st + CK * L.pitch);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = 16 * warp + g + 8 * h;
        if (t >= nv) continue;
        const float kss = ks[t];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 2 * tg + c;
          if (i >= r) continue;
          float s = kNegInf;
          if (!none_kept) {
            s = __fmul_rn(__fmul_rn(__fmul_rn(float(acc[2 * h + c]), qs_s[i]), kss), scale);
            if (has_softcap) s = softcap * tanhf(s / softcap);
          }
          sb[i * ld + t0 + t] = s;
          if (c == 0) mx0 = fmaxf(mx0, s); else mx1 = fmaxf(mx1, s);
        }
      }
    }
  }
  STAMP(ST_QK, CLOCK());
  STAMP(ST_QK_WAIT, waited);
  waited = 0;

  // 4. the softmax: row max (order-free), then e, sum, w, rowmax(w)
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  if (lane < 4) {
    red0[warp][2 * lane] = mx0;
    red0[warp][2 * lane + 1] = mx1;
  }
  __syncthreads();
  if (tid < r) {
    float m = m0;
    for (int w = 0; w < NWARPS; ++w) m = fmaxf(m, red0[w][tid]);
    if (MODE == STATS) m = fmaxf(m, mf_s[tid]);
    m_s[tid] = m;
  }
  __syncthreads();
  {
    float sum[R], wm[R], mr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      sum[i] = 0.0f;
      wm[i] = 0.0f;
      mr[i] = i < r ? m_s[i] : 0.0f;
    }
    // U keys' scores are loaded before any w is stored (the stores would
    // otherwise hold each load back: a long window's scores are in global
    // memory); a thread still adds its keys in increasing order
    constexpr int U = 16 / R;
    for (int t0 = tid; t0 < n; t0 += U * THREADS) {
      float v[U], x[U][R];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * THREADS;
        if (t >= n) break;
        v[u] = resident ? vs_s[t] : __ldg(win.scale(true, t));
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (i < r) x[u][i] = sb[i * ld + t];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * THREADS;
        if (t >= n) break;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (i >= r) break;
          const float e = expf(x[u][i] - mr[i]);
          sum[i] += e;
          const float w = __fmul_rn(e, v[u]);
          wm[i] = fmaxf(wm[i], w);
          sb[i * ld + t] = w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      sum[i] = warp_sum(sum[i]);
      wm[i] = warp_max(wm[i]);
      if (lane == 0 && i < r) {
        red0[warp][i] = sum[i];
        red1[warp][i] = wm[i];
      }
    }
  }
  __syncthreads();
  if (tid < r) {
    float s = 0.0f, w = 0.0f;
    for (int k = 0; k < NWARPS; ++k) {
      s += red0[k][tid];
      w = fmaxf(w, red1[k][tid]);
    }
    const float m = m_s[tid];
    if (MODE == STATS) w = fmaxf(w, __fmul_rn(wfm_s[tid], expf(mf_s[tid] - m)));
    const float a = fmaxf(w * kInv127, 1e-8f);
    a_s[tid] = a;
    if (MODE == STATS) {
      io.m[tid] = m;
      io.a[tid] = a;
      io.sum[tid] = s;
    } else {
      osc_s[tid] = a / s;
    }
  }
  __syncthreads();
  STAMP(ST_SOFTMAX, CLOCK());

  // 5. P.V on the tensor cores: out^T(d, i) = sum_t V[t, d] pi[i, t] as
  // m16n8k32 with 16 columns d as M (warp w's m-tiles are w, w + 4, ...),
  // the query rows as N and 32 keys as K. ldmatrix.trans of 32 V rows
  // gives a lane, for each 8-key block, the byte pairs (d = 16 mt + 2g,
  // 2g + 1) of keys 2 tg and 2 tg + 1; byte permutes turn two blocks into
  // the A rows d = 2g (fragment row g) and 2g + 1 (row g + 8) over keys
  // {2tg, 2tg + 1, 8 + 2tg, 9 + 2tg} (and + 16), the order pi_slot stores
  // the prob codes in. The codes of keys [t0, t0 + cap) are made when the
  // chunks reach t0 (once if resident), zero past the window's end.
  const int MT = (D + 15) / 16;
  int acc[MW][4];
#pragma unroll
  for (int m = 0; m < MW; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0;
  for (; j < 2 * nc; ++j) {
    const int t0 = (j - nc) * CK, nv = min(CK, n - t0);
    if (t0 % cap == 0) {
      if (t0 > 0) __syncthreads();  // the last super-chunk's codes are read
      const int hi = min(cap, (n - t0 + 31) / 32 * 32);  // the k-steps' keys
      float ar[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ar[i] = i < r ? a_s[i] : 1.0f;
#pragma unroll 2
      for (int t = tid; t < hi; t += THREADS) {
        const int at = (t & ~31) + pi_slot(t & 31);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (i >= r) break;
          float c = 0.0f;
          if (t0 + t < n) c = fminf(fmaxf(rintf(sb[i * ld + t0 + t] / ar[i]), -127.0f), 127.0f);
          pi_s[i * L.pip + at] = int8_t(c);
        }
      }
    }
    c0 = CLOCK();
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    waited += CLOCK() - c0;
    if (j + STAGES - 1 < 2 * nc) chunk(true, j + STAGES - 1);
    cp_async_commit();
    const int8_t* st = smem + (j % STAGES) * L.stage;
    const int8_t* pc = pi_s + t0 % cap + g * L.pip + 4 * tg;
    for (int kb = 0; kb < nv; kb += 32) {
      uint32_t b[2] = {0u, 0u};
      if (g < r) {
        b[0] = *reinterpret_cast<const uint32_t*>(pc + kb);
        b[1] = *reinterpret_cast<const uint32_t*>(pc + kb + 16);
      }
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        const int mt = warp + NWARPS * m;
        if (mt >= MT) break;
        uint32_t v[4], a[4];
        ldmatrix_x4_trans(v, st + (kb + lane) * L.pitch + 16 * mt);
        a[0] = __byte_perm(v[0], v[1], 0x6420);
        a[1] = __byte_perm(v[0], v[1], 0x7531);
        a[2] = __byte_perm(v[2], v[3], 0x6420);
        a[3] = __byte_perm(v[2], v[3], 0x7531);
        mma_s8(acc[m], a, b);
      }
    }
  }
  STAMP(ST_PV, CLOCK());
  STAMP(ST_PV_WAIT, waited);

  // acc[m]: (d = 16 mt + 2g, i = 2tg), (2g, 2tg + 1), (2g + 1, 2tg), (2g + 1, 2tg + 1)
#pragma unroll
  for (int m = 0; m < MW; ++m) {
    const int mt = warp + NWARPS * m;
    if (mt >= MT) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * mt + 2 * g + e / 2, i = 2 * tg + e % 2;
      if (d >= D || i >= r) continue;
      float o = float(acc[m][e]);
      if (MODE != STATS) o = __fmul_rn(o, osc_s[i]);
      io.out[i * D + d] = o;
    }
  }
  STAMP_FINISH();
}

__device__ __forceinline__ void poison(float* out, int count) {
  for (int idx = threadIdx.x; idx < count; idx += THREADS) out[idx] = __int_as_float(0x7fc00000);
}

// The kept main rows [lo, hi) of a slot: s < main_len, s > pos - window.
__device__ __forceinline__ void main_range(int mlen, int pos, int window, int S, int& lo,
                                           int& n) {
  const int hi = mlen < S ? mlen : S;
  lo = (window > 0 && pos - window + 1 > 0) ? pos - window + 1 : 0;
  n = hi > lo ? hi - lo : 0;
}

// ---------------------------------------------------------------------------
// B4
// ---------------------------------------------------------------------------

template <int R, int MW>
__global__ void __launch_bounds__(THREADS, R == 4 && MW == 1 ? 8 : 4)
decode_attention_append_kernel(const float* __restrict__ q, const int8_t* __restrict__ new_k,
                               const int8_t* __restrict__ new_v,
                               const float* __restrict__ new_ks,
                               const float* __restrict__ new_vs, int8_t* k_cache,
                               int8_t* v_cache, float* k_scale, float* v_scale,
                               const int* __restrict__ pos_arr, float* __restrict__ out,
                               float* scratch, int KV, int r, int D, int S, int window, int cap,
                               int vec, float scale, float softcap, int has_softcap) {
  STAMP_BEGIN();
  const int bk = blockIdx.x, tid = threadIdx.x;  // bk = b * KV + kv
  // what does not depend on the position first: q, and the current token
  stage_q<APPEND>(q + (long)bk * r * D, nullptr, nullptr, nullptr, r, D, cap);
  uint32_t kw = 0, vw = 0;
  if (tid < D / 4) {
    kw = reinterpret_cast<const uint32_t*>(new_k + (long)bk * D)[tid];
    vw = reinterpret_cast<const uint32_t*>(new_v + (long)bk * D)[tid];
  }
  const float ksn = new_ks[bk], vsn = new_vs[bk];
  const int pos = pos_arr[bk / KV];
  if (pos < 0 || pos >= S) {
    // outside the cache: write nothing and poison this block's output
    // (the host checks lengths before decoding; this keeps a bad position
    // from writing past the layer's buffers)
    poison(out + (long)bk * r * D, r * D);
    cp_async_wait<0>();
    return;
  }
  const long head = (long)bk * S;
  // 2. the current token into the cache, in place (nothing here reads it back)
  if (tid < D / 4) {
    reinterpret_cast<uint32_t*>(k_cache + (head + pos) * D)[tid] = kw;
    reinterpret_cast<uint32_t*>(v_cache + (head + pos) * D)[tid] = vw;
  }
  if (tid == 0) {
    k_scale[head + pos] = ksn;
    v_scale[head + pos] = vsn;
  }
  const int lo = (window > 0 && pos - window + 1 > 0) ? pos - window + 1 : 0;
  Window win;
  // rows [lo, pos) from the cache, the current token from new_k / new_v
  win.p1 = {k_cache + (head + lo) * D, v_cache + (head + lo) * D, k_scale + head + lo,
            v_scale + head + lo};
  win.p2 = {new_k + (long)bk * D, new_v + (long)bk * D, new_ks + bk, new_vs + bk};
  win.n1 = pos - lo;
  win.n = pos - lo + 1;
  Io io{};
  io.out = out + (long)bk * r * D;
  attend<APPEND, R, MW>(win, io, r, D, cap, vec, scratch ? scratch + (long)bk * r * S : nullptr,
                        S, -INFINITY, false, scale, softcap, has_softcap);
}

// ---------------------------------------------------------------------------
// B7
// ---------------------------------------------------------------------------

template <int R, int MW>
__global__ void __launch_bounds__(THREADS, R == 4 && MW == 1 ? 8 : 4)
decode_attention_kernel(const float* __restrict__ q, const int8_t* __restrict__ k_cache,
                        const int8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int8_t* __restrict__ kf,
                        const int8_t* __restrict__ vf, const float* __restrict__ ksf,
                        const float* __restrict__ vsf, const int* __restrict__ mlen_arr,
                        const int* __restrict__ pos_arr, float* __restrict__ out,
                        float* scratch, int KV, int r, int D, int S, int W, int window,
                        int t_side, int cap, int vec, float scale, float softcap,
                        int has_softcap) {
  STAMP_BEGIN();
  const int bk = blockIdx.x;  // b * KV + kv
  const int b = bk / KV;
  stage_q<TWO_PART>(q + (long)bk * r * D, nullptr, nullptr, nullptr, r, D, cap);
  const int mlen = mlen_arr[b], pos = pos_arr[b];
  int lo_m, n_m;
  main_range(mlen, pos, window, S, lo_m, n_m);
  // side lanes j <= t at position mlen + j > pos - window
  int lo_f = 0, n_f = 0;
  if (W > 0) {
    const int hi_f = t_side + 1 < W ? t_side + 1 : W;
    lo_f = (window > 0 && pos - window - mlen + 1 > 0) ? pos - window - mlen + 1 : 0;
    n_f = hi_f > lo_f ? hi_f - lo_f : 0;
  }
  const bool none_kept = n_m + n_f == 0;
  if (none_kept) {  // every lane at -1e9: the TPU kernel attends uniformly
    lo_m = 0; n_m = S; lo_f = 0; n_f = W;
  }
  const float m0 = (none_kept || n_m < S || n_f < W) ? kNegInf : -INFINITY;
  const long head = (long)bk * S, fhead = (long)bk * W;
  Window win;
  win.p1 = {k_cache + (head + lo_m) * D, v_cache + (head + lo_m) * D, k_scale + head + lo_m,
            v_scale + head + lo_m};
  win.p2 = {nullptr, nullptr, nullptr, nullptr};
  if (W > 0)
    win.p2 = {kf + (fhead + lo_f) * D, vf + (fhead + lo_f) * D, ksf + fhead + lo_f,
              vsf + fhead + lo_f};
  win.n1 = n_m;
  win.n = n_m + n_f;
  Io io{};
  io.out = out + (long)bk * r * D;
  attend<TWO_PART, R, MW>(win, io, r, D, cap, vec,
                          scratch ? scratch + (long)bk * r * (S + W) : nullptr, S + W, m0,
                          none_kept, scale, softcap, has_softcap);
}

// ---------------------------------------------------------------------------
// B6
// ---------------------------------------------------------------------------

template <int R, int MW>
__global__ void __launch_bounds__(THREADS, R == 4 && MW == 1 ? 8 : 4)
decode_attention_stats_kernel(const int8_t* __restrict__ qi_g, const float* __restrict__ qs_g,
                              const float* __restrict__ mf_g, const float* __restrict__ wfm_g,
                              const int8_t* __restrict__ k_cache,
                              const int8_t* __restrict__ v_cache,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ mlen_arr, const int* __restrict__ pos_arr,
                              float* __restrict__ o32, float* __restrict__ m_out,
                              float* __restrict__ a_out, float* __restrict__ sum_out,
                              float* scratch, int KV, int r, int D, int S, int window, int cap,
                              int vec, float scale, float softcap, int has_softcap) {
  const int bk = blockIdx.x;  // b * KV + kv
  const int b = bk / KV;
  const long head = (long)bk * S, row = (long)bk * r;
  stage_q<STATS>(qi_g + row * D, qs_g + row, mf_g + row, wfm_g + row, r, D, cap);
  int lo, n;
  main_range(mlen_arr[b], pos_arr[b], window, S, lo, n);
  Window win;
  win.p1 = {k_cache + (head + lo) * D, v_cache + (head + lo) * D, k_scale + head + lo,
            v_scale + head + lo};
  win.p2 = {nullptr, nullptr, nullptr, nullptr};
  win.n1 = n;
  win.n = n;
  Io io{};
  io.out = o32 + row * D;
  io.m = m_out + row;
  io.a = a_out + row;
  io.sum = sum_out + row;
  attend<STATS, R, MW>(win, io, r, D, cap, vec, scratch ? scratch + row * S : nullptr, S,
                       n < S ? kNegInf : -INFINITY, false, scale, softcap, has_softcap);
}

// ---------------------------------------------------------------------------
// B8
// ---------------------------------------------------------------------------

// Replaces llm_compressor_tpu/kernels/decode_attention.py::_call_write
// (:308). The whole job is one token's codes and scales: 2 * B * KV * (D + 4)
// bytes read and written (278,528 at B = 128, KV = 8, D = 64), so launch
// latency, not bytes, sets its time, and the kernel is kept short. Thread
// i < BKV * D / U copies one U-byte piece of a (slot, head) row of the K
// codes and the same piece of the V codes, both loads issued before the
// stores (U = 16 where D % 16 == 0 and every code pointer is 16-byte
// aligned, else 4, else 1: ``width``), so a warp covers 8 rows at D = 64.
// The threads after them move the scales: 4 pairs' k and v scales each,
// read as float4 (SVEC: nks, nvs 16-byte aligned and BKV % 4 == 0), else
// one pair's; written to their lanes, W floats apart. CTAs of one warp
// spread the copies over the SMs: the flagship is 136 CTAs, about one per
// SM (CTAs of 256 threads on 17 SMs took 0.0074 ms, of 64 threads 0.0060,
// of 32 threads 0.0058: tools/kernel_turns.py on an H100).
constexpr int WRITE_THREADS = 32;

template <int U, bool SVEC>
__global__ void __launch_bounds__(WRITE_THREADS)
fresh_write_kernel(int8_t* __restrict__ kf, int8_t* __restrict__ vf, float* __restrict__ ksf,
                   float* __restrict__ vsf, const int8_t* __restrict__ nk,
                   const int8_t* __restrict__ nv, const float* __restrict__ nks,
                   const float* __restrict__ nvs, int BKV, int D, int W, int layer, int t) {
  using Piece = typename std::conditional<
      U == 16, uint4, typename std::conditional<U == 4, uint32_t, int8_t>::type>::type;
  const int per = D / U, pieces = BKV * per;  // < 2^31
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < pieces) {
    const Piece k = reinterpret_cast<const Piece*>(nk)[i];
    const Piece v = reinterpret_cast<const Piece*>(nv)[i];
    const int bk = i / per;
    const long dst = (((long)layer * BKV + bk) * W + t) * per + (i - bk * per);
    reinterpret_cast<Piece*>(kf)[dst] = k;
    reinterpret_cast<Piece*>(vf)[dst] = v;
    return;
  }
  const int g = i - pieces;
  if constexpr (SVEC) {
    if (g >= BKV / 4) return;
    const float4 a = reinterpret_cast<const float4*>(nks)[g];
    const float4 b = reinterpret_cast<const float4*>(nvs)[g];
    const long lane = ((long)layer * BKV + 4 * g) * W + t;
    ksf[lane] = a.x; ksf[lane + W] = a.y; ksf[lane + 2 * W] = a.z; ksf[lane + 3 * W] = a.w;
    vsf[lane] = b.x; vsf[lane + W] = b.y; vsf[lane + 2 * W] = b.z; vsf[lane + 3 * W] = b.w;
  } else {
    if (g >= BKV) return;
    const float a = nks[g], b = nvs[g];
    const long lane = ((long)layer * BKV + g) * W + t;
    ksf[lane] = a;
    vsf[lane] = b;
  }
}

// Checks the plan the wrapper computed (cap, smem bytes) against this
// file's layout and lifts the dynamic shared memory limit where needed
// (the 48 KB default covers static and dynamic together; the static
// arrays take under 0.5 KB).
int prepare(const void* kernel, int r, int D, int cap, int smem) {
  if (r < 1 || r > RMAX || D > DMAX || D % 4 || cap < CK || cap % CK ||
      layout(r, D, cap).total != smem)
    return int(cudaErrorInvalidValue);
  if (smem <= 40 * 1024) return 0;
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// The instance for r (R = 4 or 8 query rows) and D (MW = 1, 2 or 4 P.V
// m-tiles of 16 columns per warp), launched by ``launch``.
#define LLMC_DISPATCH(K)                                                            \
  (r <= 4 ? (D <= 64 ? launch(K<4, 1>) : D <= 128 ? launch(K<4, 2>) : launch(K<4, 4>)) \
          : (D <= 64 ? launch(K<8, 1>) : D <= 128 ? launch(K<8, 2>) : launch(K<8, 4>)))

}  // namespace

// Every launcher: ``vec`` selects 16-byte copies (D % 16 == 0 and every
// K/V pointer 16-byte aligned; else 4-byte), ``cap`` and ``smem`` are the
// wrapper's plan (kernels/decode_attention.py::plan), ``scratch`` its f32
// score scratch of r * (S + W) floats per (slot, kv head), or null when
// S + W <= cap. Each returns cudaGetLastError() after the launch, or the
// error of a refused plan.

// q (B, KV, r, D) f32; new_k/new_v (B, KV, D) int8; new_ks/new_vs (B, KV)
// f32; k_cache/v_cache the layer's (B, KV, S, D) int8 codes, k_scale /
// v_scale its (B, KV, S) f32 scales, all written in place at pos[b];
// pos (B,) int32; out (B, KV, r, D) f32, NaN for a slot whose pos is
// outside [0, S). window <= 0 is full attention.
extern "C" int llmc_decode_attention_append(
    const void* q, const void* new_k, const void* new_v, const void* new_ks,
    const void* new_vs, void* k_cache, void* v_cache, void* k_scale, void* v_scale,
    const void* pos, void* out, void* scratch, int B, int KV, int r, int D, int S, int window,
    int cap, int smem, int vec, float scale, float softcap, int has_softcap, void* stream) {
  auto launch = [&](auto kernel) {
    if (int e = prepare(reinterpret_cast<const void*>(kernel), r, D, cap, smem)) return e;
    kernel<<<B * KV, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const int8_t*>(new_k),
        static_cast<const int8_t*>(new_v), static_cast<const float*>(new_ks),
        static_cast<const float*>(new_vs), static_cast<int8_t*>(k_cache),
        static_cast<int8_t*>(v_cache), static_cast<float*>(k_scale),
        static_cast<float*>(v_scale), static_cast<const int*>(pos), static_cast<float*>(out),
        static_cast<float*>(scratch), KV, r, D, S, window, cap, vec, scale, softcap, has_softcap);
    return int(cudaGetLastError());
  };
  return LLMC_DISPATCH(decode_attention_append_kernel);
}

// q (B, KV, r, D) f32; one layer's main cache k_cache/v_cache (B, KV, S, D)
// int8 and k_scale/v_scale (B, KV, S) f32; its side block kf/vf (B, KV, W,
// D) int8 and ksf/vsf (B, KV, W) f32 (W = 0: none, pointers unused);
// main_len, pos (B,) int32; out (B, KV, r, D) f32. Main rows s < main_len
// and side lanes j <= t attend; window > 0 keeps positions > pos - window.
extern "C" int llmc_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* kf, const void* vf, const void* ksf, const void* vsf,
    const void* main_len, const void* pos, void* out, void* scratch, int B, int KV, int r,
    int D, int S, int W, int window, int t, int cap, int smem, int vec, float scale,
    float softcap, int has_softcap, void* stream) {
  auto launch = [&](auto kernel) {
    if (int e = prepare(reinterpret_cast<const void*>(kernel), r, D, cap, smem)) return e;
    kernel<<<B * KV, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const int8_t*>(k_cache),
        static_cast<const int8_t*>(v_cache), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), static_cast<const int8_t*>(kf),
        static_cast<const int8_t*>(vf), static_cast<const float*>(ksf),
        static_cast<const float*>(vsf), static_cast<const int*>(main_len),
        static_cast<const int*>(pos), static_cast<float*>(out), static_cast<float*>(scratch),
        KV, r, D, S, W, window, t, cap, vec, scale, softcap, has_softcap);
    return int(cudaGetLastError());
  };
  return LLMC_DISPATCH(decode_attention_kernel);
}

// qi (B, KV, r, D) int8 and qs (B, KV, r, 1) f32, the row-quantised q;
// m_f / wfm (B, KV, r, 1) f32, the side part's statistics; the main cache
// as for llmc_decode_attention; out o32 (B, KV, r, D) f32 and m / a / sum
// (B, KV, r, 1) f32.
extern "C" int llmc_decode_attention_stats(
    const void* qi, const void* qs, const void* m_f, const void* wfm, const void* k_cache,
    const void* v_cache, const void* k_scale, const void* v_scale, const void* main_len,
    const void* pos, void* o32, void* m, void* a, void* sum, void* scratch, int B, int KV, int r,
    int D, int S, int window, int cap, int smem, int vec, float scale, float softcap,
    int has_softcap, void* stream) {
  auto launch = [&](auto kernel) {
    if (int e = prepare(reinterpret_cast<const void*>(kernel), r, D, cap, smem)) return e;
    kernel<<<B * KV, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(qi), static_cast<const float*>(qs),
        static_cast<const float*>(m_f), static_cast<const float*>(wfm),
        static_cast<const int8_t*>(k_cache), static_cast<const int8_t*>(v_cache),
        static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
        static_cast<const int*>(main_len), static_cast<const int*>(pos),
        static_cast<float*>(o32), static_cast<float*>(m), static_cast<float*>(a),
        static_cast<float*>(sum), static_cast<float*>(scratch), KV, r, D, S, window, cap, vec,
        scale, softcap, has_softcap);
    return int(cudaGetLastError());
  };
  return LLMC_DISPATCH(decode_attention_stats_kernel);
}

// The side block kf/vf (L, B, KV, W, D) int8, ksf/vsf (L, B, KV, W) f32;
// one token nk/nv (B, KV, D) int8, nks/nvs (B, KV) f32, written at
// (layer, lane t) in place. width: bytes per code copy (16, 4 or 1), refused
// unless D and the four code pointers allow it; svec: float4 scale loads,
// refused unless nks and nvs start on 16-byte boundaries and B * KV % 4 == 0.
extern "C" int llmc_fresh_write(void* kf, void* vf, void* ksf, void* vsf, const void* nk,
                                const void* nv, const void* nks, const void* nvs, int B,
                                int KV, int D, int W, int layer, int t, int width, int svec,
                                void* stream) {
  auto misaligned = [](const void* p, int a) { return reinterpret_cast<uintptr_t>(p) % a != 0; };
  const int BKV = B * KV;
  if ((width != 16 && width != 4 && width != 1) || D < 1 || D % width ||
      misaligned(kf, width) || misaligned(vf, width) || misaligned(nk, width) ||
      misaligned(nv, width) ||
      (svec && (misaligned(nks, 16) || misaligned(nvs, 16) || BKV % 4)))
    return int(cudaErrorInvalidValue);
  const long threads = (long)BKV * (D / width) + (svec ? BKV / 4 : BKV);
  if (threads >= (1L << 31)) return int(cudaErrorInvalidValue);
  const unsigned grid = unsigned((threads + WRITE_THREADS - 1) / WRITE_THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<grid, WRITE_THREADS, 0, st>>>(
        static_cast<int8_t*>(kf), static_cast<int8_t*>(vf), static_cast<float*>(ksf),
        static_cast<float*>(vsf), static_cast<const int8_t*>(nk),
        static_cast<const int8_t*>(nv), static_cast<const float*>(nks),
        static_cast<const float*>(nvs), BKV, D, W, layer, t);
    return int(cudaGetLastError());
  };
  if (svec)
    return width == 16 ? launch(fresh_write_kernel<16, true>)
                       : width == 4 ? launch(fresh_write_kernel<4, true>)
                                    : launch(fresh_write_kernel<1, true>);
  return width == 16 ? launch(fresh_write_kernel<16, false>)
                     : width == 4 ? launch(fresh_write_kernel<4, false>)
                                  : launch(fresh_write_kernel<1, false>);
}
