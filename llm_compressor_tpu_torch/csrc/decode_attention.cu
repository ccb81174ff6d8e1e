// Fused-append int8-KV decode attention for Hopper (sm_90a): kernel B4.
//
// Replaces llm_compressor_tpu/kernels/decode_attention.py::_call_append
// (:469; body _kernel_append :363, _slot_attention :71, _row_quant_i8 :62).
// The TPU kernel kept the main cache read-only and merged the current
// token from a side block; here the cache is written in place, which the
// JAX package shows gives bitwise the same tokens and codes.
//
// One block per (slot, kv head). The block
//   1. row-quantises the r query rows of its head group to int8
//      (absmax * (1/127), clamped at 1e-8, round half to even),
//   2. stores the current token's K/V codes and scales at position pos,
//   3. scores the valid window [lo, pos] (lo = pos - window + 1 for a
//      sliding window): int32 dp4a dots, then ((s32 * qs) * ks) * scale,
//      then the optional softcap,
//   4. runs the exact two-pass softmax with the normalisation folded into
//      the output scale: m = rowmax, e = exp(s - m), w = e * v_scale,
//      a = max(rowmax(w) * (1/127), 1e-8), pi = clip(rint(w / a), +-127),
//   5. takes the int32 P.V dot and writes out = o32 * (a / sum(e)).
// Masked lanes of the TPU kernel (score -1e9) contribute exp(-1e9 - m) = 0
// and a zero prob code, so scoring only the valid window is the same
// function. Built without fast math: rintf, IEEE division and expf keep
// the int8 codes those of the plain version. The scales multiply by the
// f32 reciprocal of 127, as the JAX kernel does under jit (XLA rewrites
// its division by the constant), and the plain version writes out.
//
// Bound on this card: the bytes of the window, (D + 4) bytes per token for
// K and again for V per head; at the flagship step (B=128, KV=8, S~160,
// D=64) about 22 MB a layer, 7 us at 3.35 TB/s. This first design keeps
// the (r, window) scores in shared memory (r * S * 5 bytes) and streams K
// and V rows with plain loads; 1,024 blocks cover the 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int RMAX = 8;
constexpr int DMAX = 256;
constexpr float kInv127 = 1.0f / 127.0f;

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
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = THREADS / 32;
  const int pos = pos_arr[b];
  if (pos < 0 || pos >= S) {
    // outside the cache: write nothing and poison this block's output
    // (the host checks lengths before decoding; this keeps a bad position
    // from writing past the layer's buffers)
    for (int idx = tid; idx < r * D; idx += THREADS)
      out[(long)bk * r * D + idx] = __int_as_float(0x7fc00000);
    return;
  }
  const int lo = (window > 0 && pos - window + 1 > 0) ? pos - window + 1 : 0;
  const int n = pos - lo + 1;
  const int DW = D / 4;

  float* scores = smem;                                     // (r, S) f32
  int8_t* pi = reinterpret_cast<int8_t*>(smem + r * S);     // (r, S) int8

  // 1. row quant of q
  const float* qb = q + (long)bk * r * D;
  for (int i = warp; i < r; i += nwarps) {
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

  // 3. scores over the valid window
  for (int t = tid; t < n; t += THREADS) {
    const int s_pos = lo + t;
    const int* krow = reinterpret_cast<const int*>(k_cache + (head + s_pos) * D);
    int dot[RMAX];
#pragma unroll
    for (int i = 0; i < RMAX; ++i) dot[i] = 0;
    for (int kw = 0; kw < DW; ++kw) {
      const int kv4 = krow[kw];
#pragma unroll
      for (int i = 0; i < RMAX; ++i)
        if (i < r) dot[i] = __dp4a(int(qi[i * DW + kw]), kv4, dot[i]);
    }
    const float ks = k_scale[head + s_pos];
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      if (i >= r) break;
      float sc = __fmul_rn(__fmul_rn(__fmul_rn(float(dot[i]), qs[i]), ks), scale);
      if (has_softcap) sc = softcap * tanhf(sc / softcap);
      scores[i * S + t] = sc;
    }
  }
  __syncthreads();

  // 4. softmax with int8 requantisation of e * v_scale, one warp per row
  for (int i = warp; i < r; i += nwarps) {
    float* row = scores + i * S;
    float m = -INFINITY;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float sum = 0.0f, wmax = 0.0f;
    for (int t = lane; t < n; t += 32) {
      const float e = expf(row[t] - m);
      sum += e;
      const float wv = __fmul_rn(e, v_scale[head + lo + t]);
      wmax = fmaxf(wmax, wv);
      row[t] = wv;
    }
    sum = warp_sum(sum);
    wmax = warp_max(wmax);
    const float a = fmaxf(wmax * kInv127, 1e-8f);
    for (int t = lane; t < n; t += 32)
      pi[i * S + t] = int8_t(fminf(fmaxf(rintf(row[t] / a), -127.0f), 127.0f));
    if (lane == 0) oscale[i] = a / sum;
  }
  __syncthreads();

  // 5. int32 P.V and the folded normalisation
  for (int idx = tid; idx < r * D; idx += THREADS) {
    const int i = idx / D, d = idx % D;
    const int8_t* prow = pi + i * S;
    const int8_t* vcol = v_cache + head * D + (long)lo * D + d;
    int acc = 0;
    for (int t = 0; t < n; ++t) acc += int(prow[t]) * int(vcol[(long)t * D]);
    out[(long)bk * r * D + idx] = __fmul_rn(float(acc), oscale[i]);
  }
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
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_attention_append_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
    if (e != cudaSuccess) return int(e);
  }
  decode_attention_append_kernel<<<B * KV, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(new_k),
      static_cast<const int8_t*>(new_v), static_cast<const float*>(new_ks),
      static_cast<const float*>(new_vs), static_cast<int8_t*>(k_cache),
      static_cast<int8_t*>(v_cache), static_cast<float*>(k_scale),
      static_cast<float*>(v_scale), static_cast<const int*>(pos),
      static_cast<float*>(out), KV, r, D, S, window, scale, softcap, has_softcap);
  return int(cudaGetLastError());
}
