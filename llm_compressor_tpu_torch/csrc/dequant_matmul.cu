// Dequantize-in-kernel bf16 matmul for Hopper (sm_90a): kernel B5.
//
// Replaces llm_compressor_tpu/kernels/dequant_matmul.py::_call (:216) and
// its three bodies _int4_kernel (:57, both nibble layouts, with and without
// zero points), _int8_kernel (:113) and _fp8_kernel (:143):
//
//   y[m, n] = sum_k x_bf16[m, k] * W_bf16[n, k]     (f32 accumulation)
//
// with W dequantized group by group inside the kernel, each body rounding
// as the TPU body does (not as qformats.dequantize does):
//   int4, no zeros:  bf16(code - 8) * bf16(s), the exact product rounded once
//   int4, zeros:     bf16((code - 8 - z) * s), f32
//   int8:            bf16((code - z) * s),     f32 (z = 0 without zeros)
//   fp8 e4m3/e5m2:   bf16(code * s + z),       f32, z ADDED (real-domain)
// __fmul_rn / __fadd_rn / __fsub_rn keep nvcc from contracting into FMAs.
//
// Bound on this card: at decode M (<= 256 rows) the kernel must read the
// packed weight once — the flagship qkv projection is 3.1 MB of int4 codes
// plus 0.2 MB of scales and zeros, about 1 us at 3.35 TB/s; the int8 head
// (263 MB) about 79 us. Design, simple first: one CTA per 128 x 64 output
// tile (M rows masked), the K loop walks one group at a time in 64-element
// chunks: x chunk (128 x 64 bf16) and the dequantized weight chunk (64 x 64
// bf16) staged in shared memory, then mma.sync m16n8k16 bf16 -> f32, each
// of the 8 warps owning a 32 x 32 sub-tile. No split-K, TMA, wgmma or
// double buffering yet: the small-N projections give few CTAs (48 for qkv
// at M = 128), which is later perf_opt work.
//
// Weight layouts (qformats/qtensor.py): int8 / fp8 codes (N, C), one byte
// per value; int4 "pair planes" (N, C/2), byte j of group pair t holds
// element j of group 2t (low nibble) and of group 2t+1 (high nibble); int4
// "group halves" (N, C/2), byte i of a group holds elements i and i + g/2.
// Nibbles are biased (value + 8). scales / zeros: (N, G) f32.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;
constexpr int TN = 64;
constexpr int KC = 64;          // K elements staged per step
constexpr int LDS = KC + 8;     // padded shared row (bf16): conflict-free fragments
constexpr int THREADS = 256;

enum Fmt { F_INT8 = 0, F_INT4_PAIRS = 1, F_INT4_HALVES = 2, F_FP8_E4M3 = 3, F_FP8_E5M2 = 4 };

// Weight element e (0 <= e < g) of group gi of row n, dequantized to bf16.
template <int FMT>
__device__ __forceinline__ __nv_bfloat16 dequant(const uint8_t* __restrict__ row, int gi,
                                                 int g, int e, float s, float sb, float z,
                                                 bool has_z) {
  if (FMT == F_INT4_PAIRS || FMT == F_INT4_HALVES) {
    int nib;
    if (FMT == F_INT4_PAIRS) {
      const uint8_t b = row[(long)(gi >> 1) * g + e];
      nib = (gi & 1) ? (b >> 4) : (b & 0xF);
    } else {
      const int h = g >> 1;
      const uint8_t b = row[(long)gi * h + (e < h ? e : e - h)];
      nib = (e < h) ? (b & 0xF) : (b >> 4);
    }
    const float v = float(nib - 8);
    if (!has_z) return __float2bfloat16_rn(__fmul_rn(v, sb));
    return __float2bfloat16_rn(__fmul_rn(__fsub_rn(v, z), s));
  } else if (FMT == F_INT8) {
    const float v = float(static_cast<int8_t>(row[(long)gi * g + e]));
    return __float2bfloat16_rn(__fmul_rn(__fsub_rn(v, z), s));
  } else {
    const uint8_t b = row[(long)gi * g + e];
    float v;
    if (FMT == F_FP8_E4M3) {
      __nv_fp8_e4m3 f;
      f.__x = b;
      v = float(f);
    } else {
      __nv_fp8_e5m2 f;
      f.__x = b;
      v = float(f);
    }
    return __float2bfloat16_rn(__fadd_rn(__fmul_rn(v, s), z));
  }
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename OutT> __device__ __forceinline__ OutT to_out(float v);
template <> __device__ __forceinline__ float to_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half to_out<__half>(float v) {
  return __float2half_rn(v);
}

template <int FMT, typename OutT>
__global__ void __launch_bounds__(THREADS)
dequant_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                      const float* __restrict__ scales, const float* __restrict__ zeros,
                      OutT* __restrict__ out, int M, int N, int C, int g) {
  __shared__ __align__(16) __nv_bfloat16 xs[TM * LDS];
  __shared__ __align__(16) __nv_bfloat16 ws[TN * LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;         // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int G = C / g;
  const int chunks = (g + KC - 1) / KC;
  const bool has_z = zeros != nullptr;
  const bool packed4 = (FMT == F_INT4_PAIRS || FMT == F_INT4_HALVES);
  const long row_bytes = packed4 ? C / 2 : C;

  // this thread dequantizes 16 elements of weight row wr per chunk
  const int wr = tid >> 2, wc = (tid & 3) * 16;
  const int wn_row = n0 + wr;
  const uint8_t* wrow = w + (long)wn_row * row_bytes;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  for (int gi = 0; gi < G; ++gi) {
    float s = 0.0f, sb = 0.0f, z = 0.0f;
    if (wn_row < N) {
      s = scales[(long)wn_row * G + gi];
      sb = __bfloat162float(__float2bfloat16_rn(s));
      if (has_z) z = zeros[(long)wn_row * G + gi];
    }
    for (int c = 0; c < chunks; ++c) {
      const int e0 = c * KC;
      // x chunk: TM rows x KC bf16 as 32-bit pairs (g is even, so a pair
      // never straddles the group's end)
#pragma unroll 4
      for (int i = tid; i < TM * (KC / 2); i += THREADS) {
        const int row = i / (KC / 2), pr = i % (KC / 2);
        const int e = e0 + 2 * pr;
        uint32_t v = 0;
        if (m0 + row < M && e < g)
          v = *reinterpret_cast<const uint32_t*>(x + (long)(m0 + row) * C + (long)gi * g + e);
        *reinterpret_cast<uint32_t*>(&xs[row * LDS + 2 * pr]) = v;
      }
      // weight chunk: TN rows x KC, dequantized with the body's rounding
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int e = e0 + wc + j;
        __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
        if (wn_row < N && e < g) v = dequant<FMT>(wrow, gi, g, e, s, sb, z, has_z);
        ws[wr * LDS + wc + j] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* p = &xs[(wm + mt * 16 + gid) * LDS + kk + 2 * tig];
          a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const __nv_bfloat16* p = &ws[(wn + nt * 8 + gid) * LDS + kk + 2 * tig];
          b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
          b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + mt * 16 + gid + (r >= 2 ? 8 : 0);
        const int n = n0 + wn + nt * 8 + 2 * tig + (r & 1);
        if (m < M && n < N) out[(long)m * N + n] = to_out<OutT>(acc[mt][nt][r]);
      }
}

template <typename OutT>
cudaError_t launch(const void* x, const void* w, const void* scales, const void* zeros,
                   void* out, int M, int N, int C, int g, int fmt, cudaStream_t stream) {
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  const float* zp = static_cast<const float*>(zeros);
  OutT* op = static_cast<OutT*>(out);
#define LLMC_DQ_LAUNCH(F) \
  dequant_matmul_kernel<F, OutT><<<grid, THREADS, 0, stream>>>(xp, wp, sp, zp, op, M, N, C, g)
  switch (fmt) {
    case F_INT8: LLMC_DQ_LAUNCH(F_INT8); break;
    case F_INT4_PAIRS: LLMC_DQ_LAUNCH(F_INT4_PAIRS); break;
    case F_INT4_HALVES: LLMC_DQ_LAUNCH(F_INT4_HALVES); break;
    case F_FP8_E4M3: LLMC_DQ_LAUNCH(F_FP8_E4M3); break;
    case F_FP8_E5M2: LLMC_DQ_LAUNCH(F_FP8_E5M2); break;
    default: return cudaErrorInvalidValue;
  }
#undef LLMC_DQ_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// x (M, C) bf16; w codes (N, C/2) for int4, (N, C) for int8 / fp8; scales
// (N, C/g) f32; zeros (N, C/g) f32 or null; out (M, N) f32 (out_kind 0),
// bf16 (1) or f16 (2), the caller's dtype. Returns cudaGetLastError().
extern "C" int llmc_dequant_matmul(const void* x, const void* w, const void* scales,
                                   const void* zeros, void* out, int M, int N, int C,
                                   int group, int fmt, int out_kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0: return int(launch<float>(x, w, scales, zeros, out, M, N, C, group, fmt, st));
    case 1: return int(launch<__nv_bfloat16>(x, w, scales, zeros, out, M, N, C, group, fmt, st));
    case 2: return int(launch<__half>(x, w, scales, zeros, out, M, N, C, group, fmt, st));
    default: return int(cudaErrorInvalidValue);
  }
}
