// W4A8 integer matmul family for Hopper (sm_90a): kernels B1, B2, B3.
//
// Replaces the TPU kernels of llm_compressor_tpu/kernels/w4a8_matmul.py:
//   B1 _call_stacked     (:405)  stacked weights, one layer per call
//   B3 _call             (:353)  unstacked weights, incl. the int8 branch
//   B2 _call_gateup_silu (:517)  fused [gate | up] + activation epilogue
//
//   y[m, n] = sx[m] * sum_g s_w[n, g] * (x_i8[m, g] . w[n, g])
//
// The per-group dot is exact int32 (dp4a); each group's part is scaled in
// f32 and added in group order, then multiplied by the per-token act
// scale in the epilogue. __fmul_rn / __fadd_rn keep the compiler from
// contracting the scale-accumulate into an FMA, so the kernel rounds
// exactly as the plain PyTorch version does.
//
// Bound on this card: at decode M (<= 256 rows) the kernel must read the
// packed weights once — the flagship qkv projection is 3.1 MB of codes
// plus 0.2 MB of scales, about 1 us at 3.35 TB/s. At prefill M the int8
// operations dominate (2*M*N*C int8 ops). This first design is simple:
// 64x64 output tiles, a 128-deep K chunk per step staged through shared
// memory as int8 words, int4 nibbles unpacked to int8 while staging, and
// dp4a on the CUDA cores. It re-reads the weight tile once per 64-row M
// tile (twice at M=128) and does not use the tensor cores; wgmma/TMA is
// later work.
//
// Weight layouts (qformats/qtensor.py): int8 codes (N, C); int4 "pair
// planes" codes (N, C/2) where byte j of group pair t holds element j of
// group 2t (low nibble) and of group 2t+1 (high nibble); int4 "group
// halves" codes (N, C/2) where byte i of group g holds elements i and
// i + g/2. Nibbles are biased (value + 8). A stacked call passes the base
// pointer of its layer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int KC = 128;        // K elements staged per step
constexpr int KW = KC / 4;     // int32 words per staged row
constexpr int LDS = KW + 1;    // padded shared row stride (bank-conflict free)
constexpr int THREADS = 256;

enum WFmt { W_INT8 = 0, W_PAIRS = 1, W_HALVES = 2 };
enum Act { ACT_SILU = 1, ACT_GELU = 2, ACT_GELU_TANH = 3 };

__device__ __forceinline__ uint32_t nib_word(uint32_t bytes4, int hi) {
  // four packed bytes -> four signed int8 (nibble - 8) in one word
  uint32_t out = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    uint32_t v = (bytes4 >> (8 * b)) & 0xffu;
    int nib = hi ? int(v >> 4) : int(v & 0xfu);
    out |= (uint32_t(nib - 8) & 0xffu) << (8 * b);
  }
  return out;
}

// Stage 16 K-elements of one weight row (row n, chunk-local q-th 16) into
// shared words dst[0..3].
template <int WFMT>
__device__ __forceinline__ void load_w16(const uint8_t* __restrict__ w, long row_bytes,
                                         int n, int N, int gi, int group, int c, int q,
                                         uint32_t* dst) {
  uint4 v = make_uint4(0, 0, 0, 0);
  int hi = 0;
  if (n < N) {
    const uint8_t* row = w + (long)n * row_bytes;
    int e0 = c * KC + q * 16;  // element offset inside the group
    if (WFMT == W_INT8) {
      v = *reinterpret_cast<const uint4*>(row + (long)gi * group + e0);
    } else if (WFMT == W_PAIRS) {
      hi = gi & 1;
      v = *reinterpret_cast<const uint4*>(row + (long)(gi >> 1) * group + e0);
    } else {
      int h = group / 2;
      long base = (long)gi * h;
      if (e0 < h) {
        v = *reinterpret_cast<const uint4*>(row + base + e0);
      } else {
        hi = 1;
        v = *reinterpret_cast<const uint4*>(row + base + e0 - h);
      }
    }
  }
  if (WFMT == W_INT8) {
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if (n < N) {
    // 16 packed bytes hold 16 nibbles of one plane -> 4 words of int8
    dst[0] = nib_word(v.x, hi); dst[1] = nib_word(v.y, hi);
    dst[2] = nib_word(v.z, hi); dst[3] = nib_word(v.w, hi);
  } else {
    dst[0] = dst[1] = dst[2] = dst[3] = 0;
  }
}

template <typename OutT> __device__ __forceinline__ float round_out(float v);
template <> __device__ __forceinline__ float round_out<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_out<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename OutT> __device__ __forceinline__ OutT to_out(float v);
template <> __device__ __forceinline__ float to_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float activate(int act, float g) {
  if (act == ACT_SILU) return g / (1.0f + expf(-g));
  if (act == ACT_GELU) return 0.5f * g * (1.0f + erff(g * 0.70710678118654752440f));
  // tanh approximation, as torch's gelu(approximate="tanh")
  const float kBeta = 0.79788456080286535588f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  float inner = kBeta * (g + kKappa * (g * g * g));
  return 0.5f * g * (1.0f + tanhf(inner));
}

// NW = 1: plain matmul over N rows. NW = 2: fused gate|up — output column
// j reads weight rows j (gate) and I + j (up), I = n_out.
template <int WFMT, typename OutT, int NW>
__global__ void __launch_bounds__(THREADS)
w4a8_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ scales, const float* __restrict__ sx,
            OutT* __restrict__ out, int M, int n_out, int C, int group, int act) {
  __shared__ uint32_t xs[BM * LDS];
  __shared__ uint32_t ws[NW][BN * LDS];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int G = C / group;
  const int chunks = group / KC;
  const long row_bytes = (WFMT == W_INT8) ? C : C / 2;

  float acc[NW][4][4];
#pragma unroll
  for (int h = 0; h < NW; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][i][j] = 0.0f;

  for (int gi = 0; gi < G; ++gi) {
    int part[NW][4][4];
#pragma unroll
    for (int h = 0; h < NW; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[h][i][j] = 0;

    for (int c = 0; c < chunks; ++c) {
      const int k0 = gi * group + c * KC;
#pragma unroll
      for (int rep = 0; rep < 2; ++rep) {
        const int idx = tid + rep * THREADS;  // 512 = 64 rows x 8 x 16 bytes
        const int row = idx / 8, q = idx % 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (m0 + row < M)
          v = *reinterpret_cast<const uint4*>(x + (long)(m0 + row) * C + k0 + q * 16);
        uint32_t* dx = &xs[row * LDS + q * 4];
        dx[0] = v.x; dx[1] = v.y; dx[2] = v.z; dx[3] = v.w;
#pragma unroll
        for (int h = 0; h < NW; ++h)
          load_w16<WFMT>(w, row_bytes, n0 + row + h * n_out, (h + 1) * n_out,
                         gi, group, c, q, &ws[h][row * LDS + q * 4]);
      }
      __syncthreads();
#pragma unroll 4
      for (int kw = 0; kw < KW; ++kw) {
        int a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = int(xs[(ty + 16 * i) * LDS + kw]);
#pragma unroll
        for (int h = 0; h < NW; ++h)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int b = int(ws[h][(tx + 16 * j) * LDS + kw]);
#pragma unroll
            for (int i = 0; i < 4; ++i) part[h][i][j] = __dp4a(a[i], b, part[h][i][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int h = 0; h < NW; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        const float s = (n < n_out) ? scales[(long)(n + h * n_out) * G + gi] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[h][i][j] = __fadd_rn(acc[h][i][j], __fmul_rn(float(part[h][i][j]), s));
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float sm = sx[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= n_out) continue;
      float v;
      if (NW == 1) {
        v = __fmul_rn(acc[0][i][j], sm);
      } else {
        // each half rounds through the out dtype, the activation runs in
        // f32, one rounding at the store (w4a8_matmul.py:504-512)
        const float g = round_out<OutT>(__fmul_rn(acc[0][i][j], sm));
        const float u = round_out<OutT>(__fmul_rn(acc[NW - 1][i][j], sm));
        v = activate(act, g) * u;
      }
      out[(long)m * n_out + n] = to_out<OutT>(v);
    }
  }
}

template <int NW>
int launch(const void* x, const void* w, const void* scales, const void* sx, void* out,
           int M, int n_out, int C, int group, int wfmt, int out_bf16, int act,
           cudaStream_t stream) {
  dim3 grid((n_out + BN - 1) / BN, (M + BM - 1) / BM);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const uint8_t* wi = static_cast<const uint8_t*>(w);
  const float* si = static_cast<const float*>(scales);
  const float* sxi = static_cast<const float*>(sx);
#define LLMC_W4A8_LAUNCH(WF, T)                                                     \
  w4a8_kernel<WF, T, NW><<<grid, THREADS, 0, stream>>>(xi, wi, si, sxi,             \
                                                       static_cast<T*>(out), M,    \
                                                       n_out, C, group, act)
  if (out_bf16) {
    if (wfmt == W_INT8) LLMC_W4A8_LAUNCH(W_INT8, __nv_bfloat16);
    else if (wfmt == W_PAIRS) LLMC_W4A8_LAUNCH(W_PAIRS, __nv_bfloat16);
    else LLMC_W4A8_LAUNCH(W_HALVES, __nv_bfloat16);
  } else {
    if (wfmt == W_INT8) LLMC_W4A8_LAUNCH(W_INT8, float);
    else if (wfmt == W_PAIRS) LLMC_W4A8_LAUNCH(W_PAIRS, float);
    else LLMC_W4A8_LAUNCH(W_HALVES, float);
  }
#undef LLMC_W4A8_LAUNCH
  return int(cudaGetLastError());
}

}  // namespace

// x (M, C) int8; w: layer base of the codes; scales (N, C/group) f32;
// sx (M,) f32; out (M, N) bf16 or f32. Returns cudaGetLastError().
extern "C" int llmc_w4a8_matmul(const void* x, const void* w, const void* scales,
                                const void* sx, void* out, int M, int N, int C,
                                int group, int wfmt, int out_bf16, void* stream) {
  return launch<1>(x, w, scales, sx, out, M, N, C, group, wfmt, out_bf16, 0,
                   static_cast<cudaStream_t>(stream));
}

// Fused gate|up: w holds 2I rows ([gate | up]); out (M, I).
extern "C" int llmc_w4a8_gateup(const void* x, const void* w, const void* scales,
                                const void* sx, void* out, int M, int I, int C,
                                int group, int wfmt, int out_bf16, int act,
                                void* stream) {
  return launch<2>(x, w, scales, sx, out, M, I, C, group, wfmt, out_bf16, act,
                   static_cast<cudaStream_t>(stream));
}
