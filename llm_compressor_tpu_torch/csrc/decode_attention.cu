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
// One block per (slot, kv head) for B4, B6 and B7. The block
//   1. row-quantises the r query rows of its head group to int8
//      (absmax * (1/127), clamped at 1e-8, round half to even) — B6 takes
//      the codes as input,
//   2. (B4 only) stores the current token's K/V codes and scales at pos,
//   3. scores the kept rows of each part: int32 dp4a dots, then
//      ((s32 * qs) * ks) * scale, then the optional softcap,
//   4. runs the exact two-pass softmax with the normalisation folded into
//      the output scale: m = rowmax, e = exp(s - m), w = e * v_scale,
//      a = max(rowmax(w) * (1/127), 1e-8), pi = clip(rint(w / a), +-127);
//      B6 couples m and a with the side part's statistics (m_f, wfm),
//   5. takes the int32 P.V dot over every part and writes out = o32 *
//      (a / sum(e)) — B6 writes o32, m, a and the main part's sum instead.
// Masked lanes of the TPU kernels (score -1e9) contribute exp(-1e9 - m) =
// 0 and a zero prob code, so scoring only the kept rows is the same
// function; the row max starts at -1e9 where a part has masked lanes, as
// the TPU kernels' max over every lane does. B7 with no kept lane at all
// attends uniformly over every lane at -1e9, as the TPU kernel does.
// Built without fast math: rintf, IEEE division and expf keep the int8
// codes those of the plain version. The scales multiply by the f32
// reciprocal of 127, as the JAX kernels do under jit (XLA rewrites their
// division by the constant), and the plain version writes out.
//
// Bound on this card: the bytes of the window, (D + 4) bytes per token for
// K and again for V per head; at the flagship step (B=128, KV=8, S~160,
// D=64) about 22 MB a layer, 7 us at 3.35 TB/s. This first design keeps
// the (r, window) scores in shared memory (r * (S + W) * 5 bytes) and
// streams K and V rows with plain loads; 1,024 blocks cover the 132 SMs.
// B8 moves 2 (D + 4) bytes per (slot, head): a launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int RMAX = 8;
constexpr int DMAX = 256;
constexpr float kInv127 = 1.0f / 127.0f;
constexpr float kNegInf = -1e9f;  // the TPU kernels' mask value

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

// 1. row quant of the r query rows qb (r, D) f32 into codes qi (packed
// words, row i at word i * D / 4) and scales qs; one warp per row.
__device__ __forceinline__ void quant_q_rows(const float* __restrict__ qb, int r, int D,
                                             uint32_t* qi, float* qs) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int i = warp; i < r; i += NWARPS) {
    float amax = 0.0f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(qb[i * D + d]));
    amax = warp_max(amax);
    const float s = fmaxf(amax * kInv127, 1e-8f);
    if (lane == 0) qs[i] = s;
    int8_t* qrow = reinterpret_cast<int8_t*>(qi) + i * D;
    for (int d = lane; d < D; d += 32) {
      const float c = fminf(fmaxf(rintf(qb[i * D + d] / s), -127.0f), 127.0f);
      qrow[d] = int8_t(c);
    }
  }
}

// 3. scores of rows [0, n) of one part: key row t at k + t * D, its scale
// ks[t]; row i of the scores at scores[i * ld + t]. ``all_masked`` writes
// the mask value everywhere (a block with no kept lane).
__device__ __forceinline__ void score_part(const uint32_t* qi, const float* qs, int r, int D,
                                           const int8_t* k, const float* ks, int n,
                                           float scale, float softcap, int has_softcap,
                                           bool all_masked, float* scores, int ld) {
  const int DW = D / 4;
  for (int t = threadIdx.x; t < n; t += THREADS) {
    if (all_masked) {
      for (int i = 0; i < r; ++i) scores[i * ld + t] = kNegInf;
      continue;
    }
    const int* krow = reinterpret_cast<const int*>(k + (long)t * D);
    int dot[RMAX];
#pragma unroll
    for (int i = 0; i < RMAX; ++i) dot[i] = 0;
    for (int kw = 0; kw < DW; ++kw) {
      const int kv4 = krow[kw];
#pragma unroll
      for (int i = 0; i < RMAX; ++i)
        if (i < r) dot[i] = __dp4a(int(qi[i * DW + kw]), kv4, dot[i]);
    }
    const float kss = ks[t];
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      if (i >= r) break;
      float sc = __fmul_rn(__fmul_rn(__fmul_rn(float(dot[i]), qs[i]), kss), scale);
      if (has_softcap) sc = softcap * tanhf(sc / softcap);
      scores[i * ld + t] = sc;
    }
  }
}

struct RowStats {
  float m, sum, a;
};

// 4. softmax with int8 requantisation of e * v_scale for one row, by one
// warp: row[0, n) holds the scores (overwritten by w), vs_at(t) is lane
// t's v scale, pi receives the codes. ``m0`` starts the row max (-1e9 where
// the row has masked lanes). With ``couple`` (B6) the max also takes m_f
// and ``a`` the side part's wfm * exp(m_f - m).
template <typename VS>
__device__ __forceinline__ RowStats requant_row(float* row, int8_t* pi, int n, VS vs_at,
                                                float m0, bool couple, float m_f, float wfm) {
  const int lane = threadIdx.x % 32;
  float m = m0;
  for (int t = lane; t < n; t += 32) m = fmaxf(m, row[t]);
  m = warp_max(m);
  if (couple) m = fmaxf(m, m_f);
  float sum = 0.0f, wmax = 0.0f;
  for (int t = lane; t < n; t += 32) {
    const float e = expf(row[t] - m);
    sum += e;
    const float wv = __fmul_rn(e, vs_at(t));
    wmax = fmaxf(wmax, wv);
    row[t] = wv;
  }
  sum = warp_sum(sum);
  wmax = warp_max(wmax);
  if (couple) wmax = fmaxf(wmax, __fmul_rn(wfm, expf(m_f - m)));
  const float a = fmaxf(wmax * kInv127, 1e-8f);
  for (int t = lane; t < n; t += 32)
    pi[t] = int8_t(fminf(fmaxf(rintf(row[t] / a), -127.0f), 127.0f));
  return {m, sum, a};
}

// 5. sum over t < n of pi[t] * v[t * D] (one output column).
__device__ __forceinline__ int pv_part(const int8_t* pi, const int8_t* vcol, int n, int D) {
  int acc = 0;
  for (int t = 0; t < n; ++t) acc += int(pi[t]) * int(vcol[(long)t * D]);
  return acc;
}

__device__ __forceinline__ void poison(float* out, int count) {
  for (int idx = threadIdx.x; idx < count; idx += THREADS) out[idx] = __int_as_float(0x7fc00000);
}

// ---------------------------------------------------------------------------
// B4
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
decode_attention_append_kernel(const float* __restrict__ q, const int8_t* __restrict__ new_k,
                               const int8_t* __restrict__ new_v,
                               const float* __restrict__ new_ks,
                               const float* __restrict__ new_vs, int8_t* k_cache,
                               int8_t* v_cache, float* k_scale, float* v_scale,
                               const int* __restrict__ pos_arr, float* __restrict__ out,
                               int KV, int r, int D, int S, int window, float scale,
                               float softcap, int has_softcap) {
  extern __shared__ float smem[];
  __shared__ uint32_t qi[RMAX * DMAX / 4];
  __shared__ float qs[RMAX];
  __shared__ float oscale[RMAX];

  const int bk = blockIdx.x;  // b * KV + kv
  const int b = bk / KV;
  const int tid = threadIdx.x, warp = tid / 32;
  const int pos = pos_arr[b];
  if (pos < 0 || pos >= S) {
    // outside the cache: write nothing and poison this block's output
    // (the host checks lengths before decoding; this keeps a bad position
    // from writing past the layer's buffers)
    poison(out + (long)bk * r * D, r * D);
    return;
  }
  const int lo = (window > 0 && pos - window + 1 > 0) ? pos - window + 1 : 0;
  const int n = pos - lo + 1;

  float* scores = smem;                                     // (r, S) f32
  int8_t* pi = reinterpret_cast<int8_t*>(smem + r * S);     // (r, S) int8

  quant_q_rows(q + (long)bk * r * D, r, D, qi, qs);

  // 2. append the current token in place
  const long head = (long)bk * S;
  for (int d = tid; d < D; d += THREADS) {
    k_cache[(head + pos) * D + d] = new_k[(long)bk * D + d];
    v_cache[(head + pos) * D + d] = new_v[(long)bk * D + d];
  }
  if (tid == 0) {
    k_scale[head + pos] = new_ks[bk];
    v_scale[head + pos] = new_vs[bk];
  }
  __syncthreads();

  score_part(qi, qs, r, D, k_cache + (head + lo) * D, k_scale + head + lo, n, scale, softcap,
             has_softcap, false, scores, S);
  __syncthreads();

  const float* vs = v_scale + head + lo;
  for (int i = warp; i < r; i += NWARPS) {
    const RowStats st = requant_row(scores + i * S, pi + i * S, n,
                                    [&](int t) { return vs[t]; }, -INFINITY, false, 0.0f, 0.0f);
    if (tid % 32 == 0) oscale[i] = st.a / st.sum;
  }
  __syncthreads();

  for (int idx = tid; idx < r * D; idx += THREADS) {
    const int i = idx / D, d = idx % D;
    const int acc = pv_part(pi + i * S, v_cache + (head + lo) * D + d, n, D);
    out[(long)bk * r * D + idx] = __fmul_rn(float(acc), oscale[i]);
  }
}

// The kept main rows [lo, hi) of a slot: s < main_len, s > pos - window.
__device__ __forceinline__ void main_range(int mlen, int pos, int window, int S, int& lo,
                                           int& n) {
  const int hi = mlen < S ? mlen : S;
  lo = (window > 0 && pos - window + 1 > 0) ? pos - window + 1 : 0;
  n = hi > lo ? hi - lo : 0;
}

// ---------------------------------------------------------------------------
// B7
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const float* __restrict__ q, const int8_t* __restrict__ k_cache,
                        const int8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int8_t* __restrict__ kf,
                        const int8_t* __restrict__ vf, const float* __restrict__ ksf,
                        const float* __restrict__ vsf, const int* __restrict__ mlen_arr,
                        const int* __restrict__ pos_arr, float* __restrict__ out, int KV,
                        int r, int D, int S, int W, int window, int t_side, float scale,
                        float softcap, int has_softcap) {
  extern __shared__ float smem[];
  __shared__ uint32_t qi[RMAX * DMAX / 4];
  __shared__ float qs[RMAX];
  __shared__ float oscale[RMAX];

  const int bk = blockIdx.x;  // b * KV + kv
  const int b = bk / KV;
  const int tid = threadIdx.x, warp = tid / 32;
  const int mlen = mlen_arr[b], pos = pos_arr[b];
  const int ld = S + W;
  float* scores = smem;                                     // (r, S + W) f32
  int8_t* pi = reinterpret_cast<int8_t*>(smem + r * ld);    // (r, S + W) int8

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

  quant_q_rows(q + (long)bk * r * D, r, D, qi, qs);
  __syncthreads();

  const long head = (long)bk * S, fhead = (long)bk * W;
  score_part(qi, qs, r, D, k_cache + (head + lo_m) * D, k_scale + head + lo_m, n_m, scale,
             softcap, has_softcap, none_kept, scores, ld);
  if (n_f > 0)
    score_part(qi, qs, r, D, kf + (fhead + lo_f) * D, ksf + fhead + lo_f, n_f, scale, softcap,
               has_softcap, none_kept, scores + n_m, ld);
  __syncthreads();

  const float* vs_m = v_scale + head + lo_m;
  const float* vs_f = vsf + fhead + lo_f;
  for (int i = warp; i < r; i += NWARPS) {
    const RowStats st = requant_row(
        scores + i * ld, pi + i * ld, n_m + n_f,
        [&](int t) { return t < n_m ? vs_m[t] : vs_f[t - n_m]; }, m0, false, 0.0f, 0.0f);
    if (tid % 32 == 0) oscale[i] = st.a / st.sum;
  }
  __syncthreads();

  for (int idx = tid; idx < r * D; idx += THREADS) {
    const int i = idx / D, d = idx % D;
    int acc = pv_part(pi + i * ld, v_cache + (head + lo_m) * D + d, n_m, D);
    if (n_f > 0) acc += pv_part(pi + i * ld + n_m, vf + (fhead + lo_f) * D + d, n_f, D);
    out[(long)bk * r * D + idx] = __fmul_rn(float(acc), oscale[i]);
  }
}

// ---------------------------------------------------------------------------
// B6
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
decode_attention_stats_kernel(const int8_t* __restrict__ qi_g, const float* __restrict__ qs_g,
                              const float* __restrict__ mf_g, const float* __restrict__ wfm_g,
                              const int8_t* __restrict__ k_cache,
                              const int8_t* __restrict__ v_cache,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ mlen_arr, const int* __restrict__ pos_arr,
                              float* __restrict__ o32, float* __restrict__ m_out,
                              float* __restrict__ a_out, float* __restrict__ sum_out, int KV,
                              int r, int D, int S, int window, float scale, float softcap,
                              int has_softcap) {
  extern __shared__ float smem[];
  __shared__ uint32_t qi[RMAX * DMAX / 4];
  __shared__ float qs[RMAX];

  const int bk = blockIdx.x;  // b * KV + kv
  const int b = bk / KV;
  const int tid = threadIdx.x, warp = tid / 32;
  int lo, n;
  main_range(mlen_arr[b], pos_arr[b], window, S, lo, n);
  float* scores = smem;                                     // (r, S) f32
  int8_t* pi = reinterpret_cast<int8_t*>(smem + r * S);     // (r, S) int8

  const uint32_t* qsrc = reinterpret_cast<const uint32_t*>(qi_g + (long)bk * r * D);
  for (int w = tid; w < r * D / 4; w += THREADS) qi[w] = qsrc[w];
  if (tid < r) qs[tid] = qs_g[(long)bk * r + tid];
  __syncthreads();

  const long head = (long)bk * S;
  score_part(qi, qs, r, D, k_cache + (head + lo) * D, k_scale + head + lo, n, scale, softcap,
             has_softcap, false, scores, S);
  __syncthreads();

  const float* vs = v_scale + head + lo;
  for (int i = warp; i < r; i += NWARPS) {
    const long row = (long)bk * r + i;
    const RowStats st = requant_row(scores + i * S, pi + i * S, n, [&](int t) { return vs[t]; },
                                    n < S ? kNegInf : -INFINITY, true, mf_g[row], wfm_g[row]);
    if (tid % 32 == 0) {
      m_out[row] = st.m;
      a_out[row] = st.a;
      sum_out[row] = st.sum;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < r * D; idx += THREADS) {
    const int i = idx / D, d = idx % D;
    o32[(long)bk * r * D + idx] = float(pv_part(pi + i * S, v_cache + (head + lo) * D + d, n, D));
  }
}

// ---------------------------------------------------------------------------
// B8
// ---------------------------------------------------------------------------

__global__ void fresh_write_kernel(int8_t* __restrict__ kf, int8_t* __restrict__ vf,
                                   float* __restrict__ ksf, float* __restrict__ vsf,
                                   const int8_t* __restrict__ nk, const int8_t* __restrict__ nv,
                                   const float* __restrict__ nks, const float* __restrict__ nvs,
                                   int BKV, int D, int W, int layer, int t) {
  const int bk = blockIdx.x;  // b * KV + kv
  const long lane = ((long)layer * BKV + bk) * W + t;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    kf[lane * D + d] = nk[(long)bk * D + d];
    vf[lane * D + d] = nv[(long)bk * D + d];
  }
  if (threadIdx.x == 0) {
    ksf[lane] = nks[bk];
    vsf[lane] = nvs[bk];
  }
}

// Dynamic shared memory above the default: the 48 KB default covers static
// and dynamic together (the kernels' static arrays take about 2 KB).
int set_smem(const void* kernel, size_t smem) {
  if (smem <= 40 * 1024) return 0;
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(smem)));
}

}  // namespace

// q (B, KV, r, D) f32; new_k/new_v (B, KV, D) int8; new_ks/new_vs (B, KV)
// f32; k_cache/v_cache the layer's (B, KV, S, D) int8 codes, k_scale /
// v_scale its (B, KV, S) f32 scales, all written in place at pos[b];
// pos (B,) int32; out (B, KV, r, D) f32, NaN for a slot whose pos is
// outside [0, S). window <= 0 is full attention.
// Returns cudaGetLastError().
extern "C" int llmc_decode_attention_append(
    const void* q, const void* new_k, const void* new_v, const void* new_ks,
    const void* new_vs, void* k_cache, void* v_cache, void* k_scale, void* v_scale,
    const void* pos, void* out, int B, int KV, int r, int D, int S, int window,
    float scale, float softcap, int has_softcap, void* stream) {
  if (r > RMAX || D > DMAX || D % 4) return int(cudaErrorInvalidValue);
  const size_t smem = size_t(r) * S * (sizeof(float) + 1);
  if (int e = set_smem(reinterpret_cast<const void*>(decode_attention_append_kernel), smem))
    return e;
  decode_attention_append_kernel<<<B * KV, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(new_k),
      static_cast<const int8_t*>(new_v), static_cast<const float*>(new_ks),
      static_cast<const float*>(new_vs), static_cast<int8_t*>(k_cache),
      static_cast<int8_t*>(v_cache), static_cast<float*>(k_scale),
      static_cast<float*>(v_scale), static_cast<const int*>(pos),
      static_cast<float*>(out), KV, r, D, S, window, scale, softcap, has_softcap);
  return int(cudaGetLastError());
}

// q (B, KV, r, D) f32; one layer's main cache k_cache/v_cache (B, KV, S, D)
// int8 and k_scale/v_scale (B, KV, S) f32; its side block kf/vf (B, KV, W,
// D) int8 and ksf/vsf (B, KV, W) f32 (W = 0: none, pointers unused);
// main_len, pos (B,) int32; out (B, KV, r, D) f32. Main rows s < main_len
// and side lanes j <= t attend; window > 0 keeps positions > pos - window.
extern "C" int llmc_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* kf, const void* vf, const void* ksf, const void* vsf,
    const void* main_len, const void* pos, void* out, int B, int KV, int r, int D, int S,
    int W, int window, int t, float scale, float softcap, int has_softcap, void* stream) {
  if (r > RMAX || D > DMAX || D % 4) return int(cudaErrorInvalidValue);
  const size_t smem = size_t(r) * (S + W) * (sizeof(float) + 1);
  if (int e = set_smem(reinterpret_cast<const void*>(decode_attention_kernel), smem)) return e;
  decode_attention_kernel<<<B * KV, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k_cache),
      static_cast<const int8_t*>(v_cache), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int8_t*>(kf),
      static_cast<const int8_t*>(vf), static_cast<const float*>(ksf),
      static_cast<const float*>(vsf), static_cast<const int*>(main_len),
      static_cast<const int*>(pos), static_cast<float*>(out), KV, r, D, S, W, window, t, scale,
      softcap, has_softcap);
  return int(cudaGetLastError());
}

// qi (B, KV, r, D) int8 and qs (B, KV, r, 1) f32, the row-quantised q;
// m_f / wfm (B, KV, r, 1) f32, the side part's statistics; the main cache
// as for llmc_decode_attention; out o32 (B, KV, r, D) f32 and m / a / sum
// (B, KV, r, 1) f32.
extern "C" int llmc_decode_attention_stats(
    const void* qi, const void* qs, const void* m_f, const void* wfm, const void* k_cache,
    const void* v_cache, const void* k_scale, const void* v_scale, const void* main_len,
    const void* pos, void* o32, void* m, void* a, void* sum, int B, int KV, int r, int D,
    int S, int window, float scale, float softcap, int has_softcap, void* stream) {
  if (r > RMAX || D > DMAX || D % 4) return int(cudaErrorInvalidValue);
  const size_t smem = size_t(r) * S * (sizeof(float) + 1);
  if (int e = set_smem(reinterpret_cast<const void*>(decode_attention_stats_kernel), smem))
    return e;
  decode_attention_stats_kernel<<<B * KV, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qi), static_cast<const float*>(qs),
      static_cast<const float*>(m_f), static_cast<const float*>(wfm),
      static_cast<const int8_t*>(k_cache), static_cast<const int8_t*>(v_cache),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(main_len), static_cast<const int*>(pos),
      static_cast<float*>(o32), static_cast<float*>(m), static_cast<float*>(a),
      static_cast<float*>(sum), KV, r, D, S, window, scale, softcap, has_softcap);
  return int(cudaGetLastError());
}

// The side block kf/vf (L, B, KV, W, D) int8, ksf/vsf (L, B, KV, W) f32;
// one token nk/nv (B, KV, D) int8, nks/nvs (B, KV) f32, written at
// (layer, lane t) in place.
extern "C" int llmc_fresh_write(void* kf, void* vf, void* ksf, void* vsf, const void* nk,
                                const void* nv, const void* nks, const void* nvs, int B,
                                int KV, int D, int W, int layer, int t, void* stream) {
  fresh_write_kernel<<<B * KV, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(kf), static_cast<int8_t*>(vf), static_cast<float*>(ksf),
      static_cast<float*>(vsf), static_cast<const int8_t*>(nk),
      static_cast<const int8_t*>(nv), static_cast<const float*>(nks),
      static_cast<const float*>(nvs), B * KV, D, W, layer, t);
  return int(cudaGetLastError());
}
