// W4A8 integer matmul family for Hopper (sm_90a): kernels B1, B2, B3, B9.
//
// Replaces the TPU kernels of llm_compressor_tpu/kernels/w4a8_matmul.py:
//   B1 _call_stacked     (:405)  stacked weights, one layer per call
//   B3 _call             (:353)  unstacked weights, incl. the int8 branch
//   B2 _call_gateup_silu (:517)  fused [gate | up] + activation epilogue
//   B9 _call_actq        (:621)  B3 with the per-token int8 act quant inside
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
// B9 takes the raw bf16 / f32 activations. Each block first quantises its
// 64 rows into dynamic shared memory (64 x C int8, 128 KB at C = 2048; C
// up to 3072 fits the 227 KB a block may use): a warp per row takes the
// absmax, scale = max(absmax * (1/127), 1e-5) (the f32 reciprocal, as XLA
// computes the JAX quantizer under jit), codes = clip(rint(x / scale)) with
// an IEEE division, then runs B3's group loop staging from shared memory.
// Every N-block of a row block quantises the same rows again: at the
// int8 head (M = 128, 2,004 N-blocks) that is 4,008 passes over 256 KB of
// L2-resident activations, the price of needing no second launch.
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

#include <type_traits>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int KC = 128;        // K elements staged per step
constexpr int KW = KC / 4;     // int32 words per staged row
constexpr int LDS = KW + 1;    // padded shared row stride (bank-conflict free)
constexpr int THREADS = 256;
constexpr float kInv127 = 1.0f / 127.0f;

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// NW = 1: plain matmul over N rows. NW = 2: fused gate|up — output column
// j reads weight rows j (gate) and I + j (up), I = n_out. XT = int8_t: x
// holds the act codes and sx their scales (B1-B3); XT = float or bf16: x
// holds the raw acts, quantised here (B9; sx unused).
template <int WFMT, typename OutT, int NW, typename XT>
__global__ void __launch_bounds__(THREADS)
w4a8_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ scales, const float* __restrict__ sx,
            OutT* __restrict__ out, int M, int n_out, int C, int group, int act) {
  constexpr bool ACTQ = !std::is_same<XT, int8_t>::value;
  __shared__ uint32_t xs[BM * LDS];
  __shared__ uint32_t ws[NW][BN * LDS];
  extern __shared__ uint4 xq_words[];  // B9: the block's (BM, C) act codes
  __shared__ float sxs[ACTQ ? BM : 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int G = C / group;
  const int chunks = group / KC;
  const long row_bytes = (WFMT == W_INT8) ? C : C / 2;
  int8_t* xq = reinterpret_cast<int8_t*>(xq_words);

  if constexpr (ACTQ) {
    const int lane = tid % 32;
    for (int row = tid / 32; row < BM; row += THREADS / 32) {
      const int m = m0 + row;
      int8_t* qrow = xq + (long)row * C;
      if (m >= M) {
        for (int c = lane; c < C; c += 32) qrow[c] = 0;
        continue;
      }
      const XT* xr = x + (long)m * C;
      float amax = 0.0f;
      for (int c = lane; c < C; c += 32) amax = fmaxf(amax, fabsf(to_f32(xr[c])));
      amax = warp_max(amax);
      const float s = fmaxf(__fmul_rn(amax, kInv127), 1e-5f);
      for (int c = lane; c < C; c += 32)
        qrow[c] = int8_t(fminf(fmaxf(rintf(__fdiv_rn(to_f32(xr[c]), s)), -127.0f), 127.0f));
      if (lane == 0) sxs[row] = s;
    }
    __syncthreads();
  }

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
        if constexpr (ACTQ)
          v = *reinterpret_cast<const uint4*>(xq + (long)row * C + k0 + q * 16);
        else if (m0 + row < M)
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
    const float sm = ACTQ ? sxs[ty + 16 * i] : sx[m];
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

template <int NW, typename XT>
int launch(const void* x, const void* w, const void* scales, const void* sx, void* out,
           int M, int n_out, int C, int group, int wfmt, int out_bf16, int act,
           cudaStream_t stream) {
  dim3 grid((n_out + BN - 1) / BN, (M + BM - 1) / BM);
  const XT* xi = static_cast<const XT*>(x);
  const uint8_t* wi = static_cast<const uint8_t*>(w);
  const float* si = static_cast<const float*>(scales);
  const float* sxi = static_cast<const float*>(sx);
  const size_t smem = std::is_same<XT, int8_t>::value ? 0 : size_t(BM) * C;
#define LLMC_W4A8_LAUNCH(WF, T)                                                         \
  do {                                                                                  \
    auto kern = w4a8_kernel<WF, T, NW, XT>;                                             \
    if (smem > 0) { /* static + dynamic may pass 48 KB */                                \
      cudaError_t e = cudaFuncSetAttribute(                                             \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));                \
      if (e != cudaSuccess) return int(e);                                              \
    }                                                                                   \
    kern<<<grid, THREADS, smem, stream>>>(xi, wi, si, sxi, static_cast<T*>(out), M,     \
                                          n_out, C, group, act);                        \
  } while (0)
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
  return launch<1, int8_t>(x, w, scales, sx, out, M, N, C, group, wfmt, out_bf16, 0,
                           static_cast<cudaStream_t>(stream));
}

// B9: x (M, C) raw acts, bf16 (x_bf16 = 1) or f32, quantised per row inside
// the kernel; w, scales, out as for llmc_w4a8_matmul. C * 64 bytes of
// dynamic shared memory.
extern "C" int llmc_w4a8_matmul_actq(const void* x, const void* w, const void* scales,
                                     void* out, int M, int N, int C, int group, int wfmt,
                                     int out_bf16, int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<1, __nv_bfloat16>(x, w, scales, nullptr, out, M, N, C, group, wfmt,
                                    out_bf16, 0, st);
  return launch<1, float>(x, w, scales, nullptr, out, M, N, C, group, wfmt, out_bf16, 0, st);
}

// Fused gate|up: w holds 2I rows ([gate | up]); out (M, I).
extern "C" int llmc_w4a8_gateup(const void* x, const void* w, const void* scales,
                                const void* sx, void* out, int M, int I, int C,
                                int group, int wfmt, int out_bf16, int act,
                                void* stream) {
  return launch<2, int8_t>(x, w, scales, sx, out, M, I, C, group, wfmt, out_bf16, act,
                           static_cast<cudaStream_t>(stream));
}
