// Fast Walsh-Hadamard transform for Hopper (sm_90a): kernel B10.
//
// Replaces llm_compressor_tpu/kernels/hadamard.py::hadamard_transform_pallas
// (:271) and its body _fht_kernel (:241):
//
//   y = x (H_K kron H_m) * scale     along each row of x (rows, n), n = K * m
//
// The TPU kernel runs H_m as an H_128 matmul on the MXU followed by a
// sublane butterfly, and contracts the base H_K in XLA outside the kernel;
// that split follows Mosaic's (8, 128) tiling and is why it refuses
// m % 128 != 0. Here every power-of-two m from 1 up runs (R2 at head_dim
// 64 included), and the H_K contraction runs in the kernel too.
//
// Bound on this card: bytes. Each element is read once and written once,
// and the transform does log2(m) + K adds per element, so a row of n values
// moves n * (in + out) bytes for about 13 f32 adds per element at
// n = 8192. The first design kept the row in shared memory and ran every
// one of the log2(m) stages through it, a barrier between stages: at
// n = 8192 that is 26 passes over 32 KB per row, and shared memory, not
// device memory, set its time. This design keeps the row in registers:
//
// * Pass 1. A thread holds E consecutive values (chunk c of the row,
//   loaded with 16-byte loads). Stages h < E run in its registers; stages
//   h = E .. 16E pair chunk c with chunk c ^ (h / E), a warp shuffle with
//   lane mask h / E: the lane holding a computes u + v, the one holding
//   a + h computes u - v from the same two values, each as one
//   fma(+-1, own, other).
// * Pass 2, only for m > 32E. The row goes to shared memory as f32; each
//   thread reads the 2^r values a, a + 32E, ... of one group (r =
//   log2(m / 32E) <= log2(E)) into registers, runs stages h = 32E .. m/2
//   there and writes them back. So a row meets shared memory once or
//   twice, not log2(m) times.
// * H_K (K > 1): after the butterfly the row sits in shared memory; a
//   thread takes vc consecutive columns j (vc values fill 16 bytes of the
//   output type) and 4 outputs k, reads s[l*m + j] once for each
//   l = 0..K-1 and adds +-s to its 4 * vc sums in order l as
//   fma(+-1, s, sum), the signs of H_K as bits (sign_words in
//   kernels/hadamard.py) instead of an int8 branch. Then one __fmul_rn by
//   the scale and one cast per output.
// * A row takes gcd(n / E, 256) threads, each taking chunks in turn, and a
//   CTA 256 / that many rows (kernels/hadamard.py::plan, checked here).
//
// Shared memory holds a chunk's 16-byte units xor-swizzled by the chunk
// index (phys), so the float4 stores of pass 1, the scalar reads of
// pass 2 and the column reads of H_K meet no or few bank conflicts.
// __fadd_rn / __fsub_rn / __fmaf_rn / __fmul_rn keep the arithmetic that
// of the plain version (every stage in order h = 1, 2, 4, ..., each u + v
// / u - v rounded once; the K terms in order l; +-1 * v is exact, so
// fma(+-1, v, w) is w +- v rounded once), so the two agree bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_stamps.cuh"

namespace {

constexpr int CTA_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;
constexpr int SMEM_TARGET = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// Phase stamps (phase_stamps.cuh, tools/hadamard_phases.py): SM clocks
// after pass 1, after the exchange's barrier and after pass 2's barrier.
enum Stamp { ST_SM, ST_T0, ST_T1, ST_ENTRY, ST_PASS1, ST_SYNC1, ST_PASS2, ST_END };

template <int V>
__host__ __device__ constexpr int log2c() {
  if constexpr (V <= 1)
    return 0;
  else
    return 1 + log2c<V / 2>();
}

// 16 bytes of the row type: VO values
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int VO = 4;
  __device__ static float get(const float* p, long i) { return p[i]; }
  __device__ static void put(float* p, long i, float v) { p[i] = v; }
  __device__ static void get16(const float* p, long i, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void put16(float* p, long i, const float* v) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int VO = 8;
  __device__ static float get(const __nv_bfloat16* p, long i) { return __bfloat162float(p[i]); }
  __device__ static void put(__nv_bfloat16* p, long i, float v) { p[i] = __float2bfloat16_rn(v); }
  __device__ static void get16(const __nv_bfloat16* p, long i, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p + i);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[t]));
      v[2 * t] = f.x;
      v[2 * t + 1] = f.y;
    }
  }
  __device__ static void put16(__nv_bfloat16* p, long i, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * t], v[2 * t + 1]);
      w[t] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p + i) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Shared-memory index of the row's value a, chunks of E values: the
// chunk's 16-byte units are xor-swizzled by the chunk index, so 8
// consecutive chunks' unit f lands on 8 different bank groups.
template <int E>
__device__ __forceinline__ int phys(int a) {
  constexpr int U = E / 4;  // 16-byte units of a chunk
  if constexpr (U <= 1) {
    return a;
  } else {
    const int c = a / E, f = (a % E) >> 2;
    return c * E + ((f ^ ((c / (8 / U)) % U)) << 2) + (a & 3);
  }
}

template <int E>
__device__ __forceinline__ void chunk_to_smem(float* s, int c, const float* v) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int f = 0; f < E / 4; ++f)
      *reinterpret_cast<float4*>(s + phys<E>(c * E + 4 * f)) =
          make_float4(v[4 * f], v[4 * f + 1], v[4 * f + 2], v[4 * f + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) s[c * E + i] = v[i];
  }
}

template <int E>
__device__ __forceinline__ void chunk_from_smem(const float* s, int c, float* v) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int f = 0; f < E / 4; ++f) {
      const float4 q = *reinterpret_cast<const float4*>(s + phys<E>(c * E + 4 * f));
      v[4 * f] = q.x; v[4 * f + 1] = q.y; v[4 * f + 2] = q.z; v[4 * f + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = s[c * E + i];
  }
}

// Stages h = 1, 2, .. < min(E, lim) over v's E values: pairs (i, i + h).
template <int E>
__device__ __forceinline__ void register_stages(float* v, int lim) {
#pragma unroll
  for (int lg = 0; lg < log2c<E>(); ++lg) {
    const int h = 1 << lg;
    if (h < lim) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        if (!(i & h)) {
          const float u = v[i], w = v[i + h];
          v[i] = __fadd_rn(u, w);
          v[i + h] = __fsub_rn(u, w);
        }
      }
    }
  }
}

// Chunk c's E values (row xr) into v, scaled and cast into orow.
template <int E, typename T>
__device__ __forceinline__ void load_chunk(const T* xr, int c, bool vec, float* v) {
  constexpr int VO = Io<T>::VO;
  if (vec && E % VO == 0) {
#pragma unroll
    for (int f = 0; f < E / VO; ++f) Io<T>::get16(xr, (long)c * E + f * VO, v + f * VO);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = Io<T>::get(xr, (long)c * E + i);
  }
}

template <int E, typename T>
__device__ __forceinline__ void store_chunk(T* orow, int c, bool vec, float* v, float scale) {
  constexpr int VO = Io<T>::VO;
#pragma unroll
  for (int i = 0; i < E; ++i) v[i] = __fmul_rn(v[i], scale);
  if (vec && E % VO == 0) {
#pragma unroll
    for (int f = 0; f < E / VO; ++f) Io<T>::put16(orow, (long)c * E + f * VO, v + f * VO);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) Io<T>::put(orow, (long)c * E + i, v[i]);
  }
}

// HK: K > 1, the instance with the H_K contraction (K = 1 keeps its
// registers free of the contraction's sums). A CTA takes rpc rows. The
// register bounds keep 6 CTAs of E <= 8 (K = 1) and 4 of E = 16 on an SM.
template <int E, bool HK, typename T>
__global__ void __launch_bounds__(CTA_THREADS, HK ? 2 : E == 16 ? 4 : E == 32 ? 2 : 6)
hadamard_kernel(const T* __restrict__ x, T* __restrict__ out,
                const uint32_t* __restrict__ signs, long rows, int n, int m, int K, int tpr,
                int rpc, int passes, int vec, float scale) {
  extern __shared__ __align__(16) float smem[];
  STAMP_BEGIN();
  constexpr int VO = Io<T>::VO;
  const int tid = threadIdx.x % tpr, rloc = threadIdx.x / tpr;
  const long row = (long)blockIdx.x * rpc + rloc;
  const bool live = row < rows;  // dead rows still shuffle with their warp
  const T* xr = x + row * n;
  T* orow = out + row * n;
  float* s = smem + (long)rloc * n;
  const bool to_smem = passes == 2 || HK;
  const int nw = (K + 31) >> 5;
  uint32_t* sg = reinterpret_cast<uint32_t*>(smem + (long)rpc * n);
  if (HK)
    for (int i = threadIdx.x; i < K * nw; i += blockDim.x) sg[i] = signs[i];

  const int chunks = n / E;
  const int hs_end = min(m, 32 * E) / E;
  // pass 1: chunk c = it * tpr + tid; tpr divides the chunk count, so
  // every lane of a warp runs the same iterations and shuffles
  for (int c = tid; c < chunks; c += tpr) {
    float v[E];
    if (live) {
      load_chunk<E>(xr, c, vec, v);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) v[i] = 0.f;
    }
    register_stages<E>(v, m);
    // the lane holding a: v + o; the one holding a + h: o - v, as one
    // fma(-1, v, o) (-v is exact, so it rounds once, as o - v does)
    for (int hs = 1; hs < hs_end; hs <<= 1) {
      const float sgn = c & hs ? -1.f : 1.f;
#pragma unroll
      for (int i = 0; i < E; ++i)
        v[i] = __fmaf_rn(sgn, v[i], __shfl_xor_sync(FULL, v[i], hs));
    }
    if (to_smem)
      chunk_to_smem<E>(s, c, v);
    else if (live)
      store_chunk<E>(orow, c, vec, v, scale);
  }
  STAMP(ST_PASS1, CLOCK());
  if (!to_smem) return;
  __syncthreads();
  STAMP(ST_SYNC1, CLOCK());

  if (passes == 2) {
    // pass 2: group q = (block, c2 < 32E) holds a = block * m + j * 32E + c2
    constexpr int W = 32 * E;
    int r = 0;
    while ((W << r) < m) ++r;
    const int R2 = 1 << r, pgroups = n >> r;
    for (int q = tid; q < pgroups; q += tpr) {
      // W is 32 chunks, so a + j * W keeps a's swizzle: phys(a) + j * W
      const int pb = phys<E>((q / W) * m + q % W);
      float v[E];
#pragma unroll
      for (int j = 0; j < E; ++j)
        if (j < R2) v[j] = s[pb + j * W];
      register_stages<E>(v, R2);
#pragma unroll
      for (int j = 0; j < E; ++j)
        if (j < R2) s[pb + j * W] = v[j];
    }
    __syncthreads();
  }
  STAMP(ST_PASS2, CLOCK());

  if constexpr (!HK) {
    for (int c = tid; c < chunks; c += tpr) {
      float v[E];
      chunk_from_smem<E>(s, c, v);
      if (live) store_chunk<E>(orow, c, vec, v, scale);
    }
  } else {
    // H_K: item q = (4 outputs kc, vc columns jv); y[k*m + j] = sum_l H[k,l] s[l*m + j].
    // Where m is a multiple of 8 chunks, a + l * m keeps a's swizzle.
    const int vc = min(VO, m), ncol = m / vc, items = ncol * (K >> 2);
    const bool lin = m % (8 * E) == 0;
    for (int q = tid; q < items; q += tpr) {
      const int kc = q / ncol, jv = q - kc * ncol;
      int pt[VO / 4];
#pragma unroll
      for (int t = 0; t < VO / 4; ++t) pt[t] = phys<E>(jv * vc + 4 * t);
      float acc[4][VO];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < VO; ++c) acc[kk][c] = 0.f;
#pragma unroll 4
      for (int l = 0; l < K; ++l) {  // K % 4 == 0
        const uint32_t bits = sg[l * nw + (kc >> 3)] >> ((kc & 7) << 2);
        const int a0 = l * m + jv * vc;
        float v[VO];
        if (vc >= 4) {
#pragma unroll
          for (int t = 0; t < VO / 4; ++t) {
            if (4 * t < vc) {
              const float4 f = *reinterpret_cast<const float4*>(
                  s + (lin ? pt[t] + l * m : phys<E>(a0 + 4 * t)));
              v[4 * t] = f.x; v[4 * t + 1] = f.y; v[4 * t + 2] = f.z; v[4 * t + 3] = f.w;
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < VO; ++c)
            if (c < vc) v[c] = s[phys<E>(a0 + c)];
        }
        // +-1 * v is exact, so the fma rounds once, as acc + (+-v) does
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float sgn = (bits >> kk) & 1u ? -1.f : 1.f;
#pragma unroll
          for (int c = 0; c < VO; ++c)
            if (c < vc) acc[kk][c] = __fmaf_rn(sgn, v[c], acc[kk][c]);
        }
      }
      if (!live) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const long o = (long)(kc * 4 + kk) * m + jv * vc;
#pragma unroll
        for (int c = 0; c < VO; ++c) acc[kk][c] = __fmul_rn(acc[kk][c], scale);
        if (vec && vc == VO) {
          Io<T>::put16(orow, o, acc[kk]);
        } else {
#pragma unroll
          for (int c = 0; c < VO; ++c)
            if (c < vc) Io<T>::put(orow, o + c, acc[kk][c]);
        }
      }
    }
  }
  STAMP_FINISH();
}

// The layout kernels/hadamard.py::plan computes, recomputed here.
struct Plan {
  int E, tpr, rpc, passes, smem;
};

int gcd_int(int a, int b) { return b ? gcd_int(b, a % b) : a; }

Plan make_plan(int n, int K, int m) {
  int b = 0;
  while ((1 << (b + 1)) <= m) ++b;
  Plan p{};
  if (b <= 10) {
    p.E = 1 << (b - 5 > 3 ? b - 5 : 3);
    p.passes = 1;
  } else {
    p.E = b <= 11 ? 8 : b <= 13 ? 16 : 32;
    p.passes = 2;
  }
  const int cap = m * (K > 1 ? 4 : 1);
  if (p.E > cap) p.E = cap;
  p.tpr = gcd_int(n / p.E, CTA_THREADS);
  const long row_smem = (p.passes == 2 || K > 1) ? 4L * n : 0;
  p.rpc = CTA_THREADS / p.tpr;
  while (p.rpc > 1 && p.rpc * row_smem > SMEM_TARGET && (p.rpc / 2) * p.tpr >= 32) p.rpc /= 2;
  const int sign_bytes = K == 1 ? 0 : K * ((K + 31) / 32) * 4;
  p.smem = int(p.rpc * row_smem) + sign_bytes;
  return p;
}

template <int E, bool HK, typename T>
cudaError_t launch(const void* x, void* out, const void* signs, int rows, int n, int m, int K,
                   const Plan& p, int vec, float scale, cudaStream_t stream) {
  auto kernel = hadamard_kernel<E, HK, T>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return e;
  }
  const long grid = ((long)rows + p.rpc - 1) / p.rpc;
  kernel<<<(unsigned)grid, p.tpr * p.rpc, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const uint32_t*>(signs),
      (long)rows, n, m, K, p.tpr, p.rpc, p.passes, vec, scale);
  return cudaGetLastError();
}

// K > 1 has E >= 4 (E <= 4m, and m >= 1); E < 4 only for n = 1, 2
template <typename T>
cudaError_t dispatch(const void* x, void* out, const void* signs, int rows, int n, int m, int K,
                     const Plan& p, int vec, float scale, cudaStream_t st) {
  if (K > 1) {
    switch (p.E) {
      case 4: return launch<4, true, T>(x, out, signs, rows, n, m, K, p, vec, scale, st);
      case 8: return launch<8, true, T>(x, out, signs, rows, n, m, K, p, vec, scale, st);
      case 16: return launch<16, true, T>(x, out, signs, rows, n, m, K, p, vec, scale, st);
      case 32: return launch<32, true, T>(x, out, signs, rows, n, m, K, p, vec, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (p.E) {
    case 1: return launch<1, false, T>(x, out, signs, rows, n, m, K, p, vec, scale, st);
    case 2: return launch<2, false, T>(x, out, signs, rows, n, m, K, p, vec, scale, st);
    case 4: return launch<4, false, T>(x, out, signs, rows, n, m, K, p, vec, scale, st);
    case 8: return launch<8, false, T>(x, out, signs, rows, n, m, K, p, vec, scale, st);
    case 16: return launch<16, false, T>(x, out, signs, rows, n, m, K, p, vec, scale, st);
    case 32: return launch<32, false, T>(x, out, signs, rows, n, m, K, p, vec, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out (rows, n) contiguous, f32 (out_kind 0) or bf16 (1); signs: H_K's
// sign words, (K, ceil(K/32)) uint32 (null when K == 1); n = K * m with m a
// power of two, K a multiple of 4 or 1; E, tpr, rpc, passes, smem the
// wrapper's plan, refused unless it is this file's; vec: x and out start
// on 16-byte boundaries. Returns cudaGetLastError().
extern "C" int llmc_hadamard(const void* x, void* out, const void* signs, int rows, int n, int m,
                             int K, int E, int tpr, int rpc, int passes, int smem, int vec,
                             float scale, int out_kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n != K * m || m < 1 || (m & (m - 1)) || (K > 1 && (K % 4 || signs == nullptr)) ||
      4L * n > SMEM_LIMIT)
    return int(cudaErrorInvalidValue);
  const Plan p = make_plan(n, K, m);
  if (p.E != E || p.tpr != tpr || p.rpc != rpc || p.passes != passes || p.smem != smem ||
      p.smem > SMEM_LIMIT)
    return int(cudaErrorInvalidValue);
  switch (out_kind) {
    case 0: return int(dispatch<float>(x, out, signs, rows, n, m, K, p, vec, scale, st));
    case 1: return int(dispatch<__nv_bfloat16>(x, out, signs, rows, n, m, K, p, vec, scale, st));
    default: return int(cudaErrorInvalidValue);
  }
}
