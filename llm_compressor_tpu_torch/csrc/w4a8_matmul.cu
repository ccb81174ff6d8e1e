// W4A8 integer matmul family for Hopper (sm_90a): kernels B1, B2, B3, B9.
//
// Replaces the TPU kernels of llm_compressor_tpu/kernels/w4a8_matmul.py:
//   B1 _call_stacked     (:405)  stacked weights, one layer per call   -> llmc_w4a8_matmul
//   B3 _call             (:353)  unstacked weights, incl. the int8 head -> llmc_w4a8_matmul
//   B9 _call_actq        (:621)  B3 with the per-token act quant inside -> llmc_w4a8_matmul_actq
//   B2 _call_gateup_silu (:517)  fused [gate | up] + act epilogue       -> llmc_w4a8_gateup
//
//   y[m, n] = sx[m] * sum_g s_w[n, g] * (x_i8[m, g] . w[n, g])
//
// The per-group dot is exact int32; each group's part is scaled in f32 and
// added in group order, then multiplied by the per-token act scale.
// __fmul_rn / __fadd_rn keep the compiler from contracting the
// scale-accumulate into an FMA, so the kernels round exactly as the plain
// PyTorch version does (kernels/w4a8_matmul.py::w4a8_plain).
//
// What bounds each case on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8):
// * decode, M <= 256 rows (B1 qkv / o / down, the B3 int8 head): the bytes
//   of the weights, read once — qkv 3.1 MB of int4 codes + 0.2 MB of
//   scales (about 1 us), the int8 head 263 MB (0.09 ms). The first design
//   (dp4a on the CUDA cores, 64 x 64 tiles) read the head twice and gave B1
//   only 32-48 CTAs for 132 SMs, each walking all of K.
// * prefill, M = 16384 (B3 qkv and o, C / g <= 16): the int8 operations,
//   2 M N C (qkv 206 G, 0.10 ms), which dp4a cannot approach.
//
// The core of B1, B3 and B9 (w4a8_mma_kernel):
// * int8 tensor cores: mma.sync m16n8k32 s8 x s8 -> s32. A is the act codes
//   (M, K) row-major and B the weight rows (N, K) row-major, which is the
//   .col operand as it stands; both reach their fragments through ldmatrix
//   (32 bytes of K read as 16 b16 columns).
// * one CTA takes a 128 x 64 output tile (8 warps, 4 along M x 2 along N,
//   32 x 32 each), so at decode (M <= 128) every weight byte is read from
//   device memory once;
// * a chunk is 128 K elements of one group. int8: 128 code bytes. Group
//   halves: 64 packed bytes whose low nibbles hold elements i and high
//   nibbles i + g/2, so one ldmatrix of the packed tile feeds the B
//   fragments of two k-steps. Pair planes: the 128 packed bytes that hold
//   elements j of groups 2t and 2t + 1, read once for each group (low
//   nibbles, then high), so that one int32 accumulator set suffices: the
//   kernel fits 128 registers and two CTAs per SM (keeping both groups'
//   sets to read the bytes once needed 162 and ran slower). Nibbles become
//   int8 in registers, four at a time: ((v & 0x0F0F0F0F) + 0x78787878) ^
//   0x80808080 is nibble - 8 in every byte;
// * x, the codes and each row's group scale go to shared memory by 16-byte
//   (scales 4-byte) cp.async in a ring of 4 chunks, one __syncthreads per
//   chunk; rows are padded by 16 bytes so that ldmatrix reads 8 rows without
//   bank conflicts;
// * after a group's k-steps each int32 fragment entry becomes f32, is scaled
//   by s_w[n, g] and added to the f32 accumulator, group after group;
// * split-K over whole groups (whole group pairs for pair planes, so no two
//   splits read one byte), planned in Python (kernels/w4a8_matmul.py::
//   split_plan, B5's rule): with s > 1 splits each CTA writes its f32 sums,
//   before sx, to an (s, M, N) workspace, and w4a8_reduce_kernel adds them
//   in split order, applies sx and rounds once. No atomics: two launches
//   give the same bits, and so does the plain version summed in the same
//   splits.
// What bounds the core now (PERF.md section 6): the chain of copy, barrier,
// mma and epilogue inside a CTA; leaving out the mma, the copies or the
// epilogue each saves a part, none most of it. Tried, bitwise right, and
// not kept: a wgmma core (the weights as the register operand, x in the
// canonical shared-memory layout), 128-wide tiles, 64 x 32 warp tiles and
// bulk (cp.async.bulk) row copies were slower at most flagship shapes.
// B9 first runs w4a8_act_quant_kernel, one warp per row, one pass: absmax,
// scale = max(absmax * (1/127), 1e-5) (the f32 reciprocal, as XLA computes
// the JAX quantizer under jit), codes = clip(rint(x / scale)) with an IEEE
// division, into int8 (M, C) codes and (M,) scales that the wrapper
// allocates; then the core reads them. Each row is quantized once, and any
// C runs (the JAX kernel quantizes once per M tile, at its first N and K
// step).
//
// B2 still runs the first design (w4a8_kernel below, NW = 2): 64 x 64
// tiles, 128-deep chunks staged synchronously as int8 words, dp4a on the
// CUDA cores. Its fused act(g) * u epilogue needs the gate and up sums of
// one output column in one thread; on the core that is a second
// accumulator pair per thread or a [gate | up] interleaved tile, which is
// the next step (ROADMAP queue B).
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

enum WFmt { W_INT8 = 0, W_PAIRS = 1, W_HALVES = 2 };
enum Act { ACT_SILU = 1, ACT_GELU = 2, ACT_GELU_TANH = 3 };
constexpr float kInv127 = 1.0f / 127.0f;

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

// two neighbouring outputs, p 2-element aligned
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// B2: the first design (dp4a on the CUDA cores), kept for the fused gate|up
// ---------------------------------------------------------------------------

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int KC2 = 128;       // K elements staged per step
constexpr int KW = KC2 / 4;    // int32 words per staged row
constexpr int LDS = KW + 1;    // padded shared row stride (bank-conflict free)
constexpr int THREADS = 256;

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
    int e0 = c * KC2 + q * 16;  // element offset inside the group
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

__device__ __forceinline__ float activate(int act, float g) {
  if (act == ACT_SILU) return g / (1.0f + expf(-g));
  if (act == ACT_GELU) return 0.5f * g * (1.0f + erff(g * 0.70710678118654752440f));
  // tanh approximation, as torch's gelu(approximate="tanh")
  const float kBeta = 0.79788456080286535588f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  float inner = kBeta * (g + kKappa * (g * g * g));
  return 0.5f * g * (1.0f + tanhf(inner));
}

// NW = 2: fused gate|up — output column j reads weight rows j (gate) and
// I + j (up), I = n_out.
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
  const int chunks = group / KC2;
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
      const int k0 = gi * group + c * KC2;
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
      // each half rounds through the out dtype, the activation runs in
      // f32, one rounding at the store (w4a8_matmul.py:504-512)
      const float g = round_out<OutT>(__fmul_rn(acc[0][i][j], sm));
      const float u = round_out<OutT>(__fmul_rn(acc[NW - 1][i][j], sm));
      out[(long)m * n_out + n] = to_out<OutT>(activate(act, g) * u);
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
#define LLMC_W4A8_LAUNCH(WF, T)                                                          \
  w4a8_kernel<WF, T, NW><<<grid, THREADS, 0, stream>>>(xi, wi, si, sxi, static_cast<T*>(out), \
                                                       M, n_out, C, group, act)
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

// ---------------------------------------------------------------------------
// B1 / B3 / B9: the int8 tensor-core core
// ---------------------------------------------------------------------------

constexpr int TM = 128;              // x rows of a CTA
constexpr int TN = 64;               // weight rows (output columns) of a CTA
constexpr int NT = 256;              // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int KC = 128;              // K elements of a chunk
constexpr int RUN = 64;              // group halves: a chunk is two runs of 64
constexpr int STAGES = 4;
constexpr int XLD = KC + 16;         // padded x row in shared memory (bytes)
constexpr int X_BYTES = TM * XLD;

// code bytes of a weight row in one chunk, padded: 128 for int8 and pair
// planes (one plane of 128 packed bytes is read), 64 for group halves
__host__ __device__ constexpr int code_ld(int wfmt) { return (wfmt == W_HALVES ? KC / 2 : KC) + 16; }
__host__ __device__ constexpr int stage_bytes(int wfmt) {
  return X_BYTES + TN * code_ld(wfmt) + TN * 4;
}
static_assert(stage_bytes(W_INT8) % 16 == 0 && stage_bytes(W_HALVES) % 16 == 0,
              "16-byte cp.async targets");
static_assert(STAGES >= 3, "the ring keeps two chunks in flight");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
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

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four biased nibbles (the low halves of four bytes after a shift by 0 or
// 4) -> four int8 n - 8: n + 0x78 stays below 0x100, and flipping bit 7
// subtracts 0x80 mod 256
__device__ __forceinline__ uint32_t nib_s8(uint32_t v, int shift) {
  return (((v >> shift) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
}

// One CTA: a TM x TN output tile.
template <int WFMT, typename OutT>
__global__ void __launch_bounds__(NT, 2)
w4a8_mma_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ scales, const float* __restrict__ sx,
                OutT* __restrict__ out, float* __restrict__ part, int M, int N, int C,
                int g) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int MT = 2;                      // m16 tiles of a warp
  constexpr int CLD = code_ld(WFMT);
  constexpr int STAGE = stage_bytes(WFMT);
  constexpr int SC_AT = X_BYTES + TN * CLD;  // one group scale per weight row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int G = C / g;
  const long row_bytes = WFMT == W_INT8 ? C : C / 2;

  // this split's units [u0, u1): groups, or group pairs for pair planes
  // (so no two splits read one byte); the splits differ by at most one unit
  const int units = WFMT == W_PAIRS ? G / 2 : G;
  const int splits = gridDim.z, z = blockIdx.z;
  const int u0 = (int)((long)z * units / splits), u1 = (int)((long)(z + 1) * units / splits);
  const int cpg = g / KC;                                 // chunks per group
  const int cpu = WFMT == W_PAIRS ? 2 * cpg : cpg;        // chunks per unit
  const int nch = (u1 - u0) * cpu;

  // Chunk c of the split: 128 K elements of one group. int8: 128 code bytes;
  // pair planes: 128 packed bytes of the pair, one nibble plane (the low
  // nibbles for group 2u, then the high ones for 2u + 1, so one int32 set
  // suffices); group halves: 64 packed bytes, low nibbles for elements
  // i, high for i + g/2 (x in two runs of 64).
  struct Chunk {
    long boff, k0, k1;
    int group, last;
  };
  auto locate = [&](int c) {
    const int du = c / cpu, r = c - du * cpu, u = u0 + du;
    Chunk ch;
    if (WFMT == W_PAIRS) {
      const int plane = r / cpg, cc = r - plane * cpg;
      ch.boff = (long)u * g + cc * KC;
      ch.group = 2 * u + plane;
      ch.k0 = (long)ch.group * g + cc * KC;
      ch.k1 = ch.k0 + RUN;
      ch.last = cc == cpg - 1;
    } else if (WFMT == W_HALVES) {
      ch.boff = (long)u * (g >> 1) + r * RUN;
      ch.group = u;
      ch.k0 = (long)u * g + r * RUN;
      ch.k1 = ch.k0 + (g >> 1);
      ch.last = r == cpu - 1;
    } else {
      ch.boff = (long)u * g + r * KC;
      ch.group = u;
      ch.k0 = ch.boff;
      ch.k1 = ch.k0 + RUN;
      ch.last = r == cpu - 1;
    }
    return ch;
  };

  // copies of chunk c into stage st, 16 bytes a thread and piece: x rows
  // tid / 8 + j NT / 8, piece tid % 8 (run piece / 4); the code pieces of
  // the weight rows; one scale per weight row
  const int xr = tid >> 3, xp = tid & 7;
  auto issue = [&](int c, int st) {
    const Chunk ch = locate(c);
    uint8_t* const s = smem + st * STAGE;
    const long kx = ((xp >> 2) ? ch.k1 : ch.k0) + (xp & 3) * 16;
#pragma unroll
    for (int j = 0; j < TM * 8 / NT; ++j) {
      const int r = xr + j * (NT / 8);
      const bool ok = m0 + r < M;
      cp_async16(s + r * XLD + xp * 16, ok ? x + (long)(m0 + r) * C + kx : x, ok ? 16 : 0);
    }
    uint8_t* const cs = s + X_BYTES;
    if (WFMT == W_HALVES) {        // TN rows x 4 pieces
#pragma unroll
      for (int j = 0; j < TN * 4 / NT; ++j) {
        const int r = (tid >> 2) + j * (NT / 4), p = tid & 3;
        const bool ok = n0 + r < N;
        cp_async16(cs + r * CLD + p * 16,
                   ok ? w + (long)(n0 + r) * row_bytes + ch.boff + p * 16 : w, ok ? 16 : 0);
      }
    } else {                       // TN rows x 8 pieces
#pragma unroll
      for (int j = 0; j < TN * 8 / NT; ++j) {
        const int r = xr + j * (NT / 8);
        const bool ok = n0 + r < N;
        cp_async16(cs + r * CLD + xp * 16,
                   ok ? w + (long)(n0 + r) * row_bytes + ch.boff + xp * 16 : w, ok ? 16 : 0);
      }
    }
#pragma unroll
    for (int r = tid; r < TN; r += NT) {
      const bool ok = n0 + r < N;
      cp_async4(reinterpret_cast<float*>(s + SC_AT) + r,
                ok ? scales + (long)(n0 + r) * G + ch.group : scales, ok ? 4 : 0);
    }
  };

  int acc_i[MT][4][4];
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[mt][nt][r] = 0.0f;
        acc_i[mt][nt][r] = 0;
      }

  // this lane's ldmatrix rows: A rows wm + (lane & 15), 16-byte half lane >> 4;
  // B rows of n-tiles 2np and 2np + 1, both 16-byte halves of a k-step
  const int a_off = (wm + (lane & 15)) * XLD + (lane >> 4) * 16;
  const int b_off = X_BYTES + (wn + (lane & 7) + ((lane >> 4) << 3)) * CLD + ((lane >> 3) & 1) * 16;

  // Ring: chunk c sits in stage c % STAGES. After the barrier of iteration c
  // everyone's copies of chunk c have landed and every thread is done with
  // chunk c - 1, whose stage takes chunk c + STAGES - 1.
#pragma unroll 1
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nch) issue(p, p);
    cp_async_commit();
  }

#pragma unroll 1
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < nch) issue(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();

    const uint8_t* const s = smem + (c % STAGES) * STAGE;
    const Chunk ch = locate(c);
    if (WFMT != W_HALVES) {
      // int8 codes, or one nibble plane of pair planes: 4 k-steps of 32
      const int shift = WFMT == W_PAIRS ? 4 * (ch.group & 1) : 0;
#pragma unroll
      for (int ks = 0; ks < KC / 32; ++ks) {
        uint32_t a[MT][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], s + a_off + mt * 16 * XLD + ks * 32);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, s + b_off + np * 16 * CLD + ks * 32);
          if (WFMT == W_PAIRS) {
#pragma unroll
            for (int i = 0; i < 4; ++i) r[i] = nib_s8(r[i], shift);
          }
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8(acc_i[mt][nt], a[mt], b[nt]);
      }
    } else {
      // group halves: one ldmatrix of 32 packed bytes feeds the k-step of
      // run 0 (low nibbles) and of run 1 (high nibbles)
#pragma unroll
      for (int ks = 0; ks < RUN / 32; ++ks) {
        uint32_t bp[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, s + b_off + np * 16 * CLD + ks * 32);
          bp[2 * np][0] = r[0];
          bp[2 * np][1] = r[1];
          bp[2 * np + 1][0] = r[2];
          bp[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int run = 0; run < 2; ++run) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldmatrix_x4(a[mt], s + a_off + mt * 16 * XLD + run * RUN + ks * 32);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t b[2] = {nib_s8(bp[nt][0], 4 * run), nib_s8(bp[nt][1], 4 * run)};
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_s8(acc_i[mt][nt], a[mt], b);
          }
        }
      }
    }

    if (ch.last) {
      // the chunk ends a group: its exact int32 dots, scaled, into acc
      const float* const sc = reinterpret_cast<const float*>(s + SC_AT);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sw = sc[wn + nt * 8 + tig * 2 + e];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              int& d = acc_i[mt][nt][2 * h + e];
              acc[mt][nt][2 * h + e] = __fadd_rn(acc[mt][nt][2 * h + e], __fmul_rn(float(d), sw));
              d = 0;
            }
        }
    }
  }
  cp_async_wait<0>();

  const bool pairs_ok = (N & 1) == 0;  // two neighbouring outputs, aligned
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + gid + h * 8;
        const int n = n0 + wn + nt * 8 + tig * 2;
        if (m >= M || n >= N) continue;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        const long at = (long)m * N + n;
        if (splits == 1) {
          const float sm = sx[m];
          v0 = __fmul_rn(v0, sm);
          v1 = __fmul_rn(v1, sm);
          if (pairs_ok) {
            store2(out + at, v0, v1);
          } else {
            out[at] = to_out<OutT>(v0);
            if (n + 1 < N) out[at + 1] = to_out<OutT>(v1);
          }
        } else {
          float* const p = part + (long)z * M * N + at;
          if (pairs_ok) {
            store2(p, v0, v1);
          } else {
            p[0] = v0;
            if (n + 1 < N) p[1] = v1;
          }
        }
      }
}

// out[m, n] = sx[m] * (part[0] + part[1] + ... + part[s - 1]), added in
// that order, rounded once
template <typename OutT>
__global__ void __launch_bounds__(256)
w4a8_reduce_kernel(const float* __restrict__ part, const float* __restrict__ sx,
                   OutT* __restrict__ out, int M, int N, int splits) {
  const long MN = (long)M * N;
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= MN) return;
  float a = part[i];
  for (int z = 1; z < splits; ++z) a = __fadd_rn(a, part[z * MN + i]);
  out[i] = to_out<OutT>(__fmul_rn(a, sx[i / N]));
}

// value i of a 16-byte load of x, as f32 (bf16: 8 values, f32: 4; the
// bf16 -> f32 widening is exact)
template <typename XT> __device__ __forceinline__ float value_at(const uint4& a, int i);
template <> __device__ __forceinline__ float value_at<__nv_bfloat16>(const uint4& a, int i) {
  const uint32_t w = i < 2 ? a.x : i < 4 ? a.y : i < 6 ? a.z : a.w;
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}
template <> __device__ __forceinline__ float value_at<float>(const uint4& a, int i) {
  return __uint_as_float(i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w);
}

// B9's act quantizer: one warp per row of x (C a multiple of 128), one pass
// over the row for the absmax and one for the codes, 16-byte loads
template <typename XT>
__global__ void __launch_bounds__(256)
w4a8_act_quant_kernel(const XT* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ sxq, int M, int C) {
  constexpr int V = 16 / sizeof(XT);  // values per 16-byte load
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  const XT* const xr = x + (long)row * C;
  float amax = 0.0f;
  for (int c = lane * V; c < C; c += 32 * V) {
    const uint4 a = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(value_at<XT>(a, i)));
  }
  amax = warp_max(amax);
  const float s = fmaxf(__fmul_rn(amax, kInv127), 1e-5f);
  int8_t* const qr = q + (long)row * C;
  for (int c = lane * V; c < C; c += 32 * V) {
    const uint4 a = *reinterpret_cast<const uint4*>(xr + c);
    uint32_t o[V / 4] = {};
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float code = fminf(fmaxf(rintf(__fdiv_rn(value_at<XT>(a, i), s)), -127.0f), 127.0f);
      o[i / 4] |= (uint32_t(int(code)) & 0xffu) << (8 * (i % 4));
    }
    if constexpr (V == 8)
      *reinterpret_cast<uint2*>(qr + c) = make_uint2(o[0], o[1]);
    else
      *reinterpret_cast<uint32_t*>(qr + c) = o[0];
  }
  if (lane == 0) sxq[row] = s;
}

template <int WFMT, typename OutT>
cudaError_t launch_mma(const int8_t* x, const uint8_t* w, const float* s, const float* sx,
                       void* out, float* part, int M, int N, int C, int g, int splits,
                       cudaStream_t stream) {
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, splits);
  constexpr int smem = STAGES * stage_bytes(WFMT);
  auto kern = w4a8_mma_kernel<WFMT, OutT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kern<<<grid, NT, smem, stream>>>(x, w, s, sx, static_cast<OutT*>(out), part, M, N, C, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long MN = (long)M * N;
  w4a8_reduce_kernel<OutT><<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(
      part, sx, static_cast<OutT*>(out), M, N, splits);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_core(const void* x, const void* w, const void* scales, const void* sx,
                        void* out, void* part, int M, int N, int C, int g, int wfmt,
                        int splits, cudaStream_t stream) {
  const int8_t* xp = static_cast<const int8_t*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  const float* sxp = static_cast<const float*>(sx);
  float* pp = static_cast<float*>(part);
  if (wfmt == W_INT8)
    return launch_mma<W_INT8, OutT>(xp, wp, sp, sxp, out, pp, M, N, C, g, splits, stream);
  if (wfmt == W_PAIRS)
    return launch_mma<W_PAIRS, OutT>(xp, wp, sp, sxp, out, pp, M, N, C, g, splits, stream);
  return launch_mma<W_HALVES, OutT>(xp, wp, sp, sxp, out, pp, M, N, C, g, splits, stream);
}

cudaError_t launch_matmul(const void* x, const void* w, const void* scales, const void* sx,
                          void* out, void* part, int M, int N, int C, int g, int wfmt,
                          int out_bf16, int splits, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || g <= 0 || g % KC || C % g || wfmt < W_INT8 || wfmt > W_HALVES)
    return cudaErrorInvalidValue;
  const int G = C / g;
  if (wfmt == W_PAIRS && G % 2) return cudaErrorInvalidValue;
  const int units = wfmt == W_PAIRS ? G / 2 : G;
  if (splits < 1 || splits > units || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (out_bf16)
    return launch_core<__nv_bfloat16>(x, w, scales, sx, out, part, M, N, C, g, wfmt, splits,
                                      stream);
  return launch_core<float>(x, w, scales, sx, out, part, M, N, C, g, wfmt, splits, stream);
}

}  // namespace

// B1 / B3: x (M, C) int8 codes, 16-byte aligned; w the codes of the layer,
// (N, C) int8 or (N, C/2) packed int4, 16-byte aligned; scales (N, C/group)
// f32; sx (M,) f32; out (M, N) bf16 or f32; splits K-splits over whole
// groups (group pairs for pair planes), and with splits > 1 part an f32
// workspace of splits x M x N. group % 128 == 0. Returns cudaGetLastError().
extern "C" int llmc_w4a8_matmul(const void* x, const void* w, const void* scales,
                                const void* sx, void* out, void* part, int M, int N, int C,
                                int group, int wfmt, int out_bf16, int splits, void* stream) {
  return int(launch_matmul(x, w, scales, sx, out, part, M, N, C, group, wfmt, out_bf16, splits,
                           static_cast<cudaStream_t>(stream)));
}

// B9: x (M, C) raw acts, bf16 (x_bf16 = 1) or f32, 16-byte aligned; xq (M, C)
// int8 and sxq (M,) f32 scratch for the act codes and scales; w, scales,
// out, part and splits as for llmc_w4a8_matmul.
extern "C" int llmc_w4a8_matmul_actq(const void* x, const void* w, const void* scales, void* xq,
                                     void* sxq, void* out, void* part, int M, int N, int C,
                                     int group, int wfmt, int out_bf16, int x_bf16, int splits,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || C <= 0 || C % 128) return int(cudaErrorInvalidValue);
  const unsigned blocks = (unsigned)((M + 7) / 8);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sq = static_cast<float*>(sxq);
  if (x_bf16)
    w4a8_act_quant_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), q, sq, M, C);
  else
    w4a8_act_quant_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(x), q, sq,
                                                          M, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return int(launch_matmul(xq, w, scales, sxq, out, part, M, N, C, group, wfmt, out_bf16, splits,
                           st));
}

// B2, fused gate|up: w holds 2I rows ([gate | up]); out (M, I).
extern "C" int llmc_w4a8_gateup(const void* x, const void* w, const void* scales,
                                const void* sx, void* out, int M, int I, int C,
                                int group, int wfmt, int out_bf16, int act,
                                void* stream) {
  return launch<2>(x, w, scales, sx, out, M, I, C, group, wfmt, out_bf16, act,
                   static_cast<cudaStream_t>(stream));
}
