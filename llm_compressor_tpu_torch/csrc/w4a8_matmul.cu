// W4A8 integer matmul family for Hopper (sm_90a): kernels B1, B2, B3, B9.
//
// Replaces the TPU kernels of llm_compressor_tpu/kernels/w4a8_matmul.py:
//   B1 _call_stacked     (:405)  stacked weights, one layer per call   -> llmc_w4a8_matmul
//   B3 _call             (:353)  unstacked weights, incl. the int8 head -> llmc_w4a8_matmul
//   B9 _call_actq        (:621)  B3 with the per-token act quant inside -> llmc_w4a8_matmul_actq
//   B2 _call_gateup_silu (:517)  fused [gate | up] + act epilogue       -> llmc_w4a8_gateup
//
//   y[m, n] = sx[m] * sum_g s_w[n, g] * (x_i8[m, g] . w[n, g])
//   B2: h[m, j] = act(y[m, j]) * y[m, I + j], each half rounded through
//       the out dtype first, one rounding at the store
//
// The per-group dot is exact int32; each group's part is scaled in f32 and
// added in group order, then multiplied by the per-token act scale.
// __fmul_rn / __fadd_rn keep the compiler from contracting the
// scale-accumulate into an FMA, so the kernels round exactly as the plain
// PyTorch version does (kernels/w4a8_matmul.py::w4a8_plain).
//
// What bounds each case on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8):
// * decode, M <= 256 rows (B1 qkv / o / down, B2 gate|up, the B3 int8
//   head): the bytes of the weights, read once — qkv 3.1 MB of int4 codes
//   + 0.2 MB of scales (about 1 us), gate|up 16.8 MB of codes + 1 MB of
//   scales (6 us), the int8 head 263 MB (0.09 ms). The first design (dp4a
//   on the CUDA cores, 64 x 64 tiles) read the head twice and gave B1
//   only 32-48 CTAs for 132 SMs, each walking all of K.
// * prefill, M = 16384 (B3 qkv and o, B2 gate|up: C / g <= 16): the int8
//   operations, 2 M N C (qkv 206 G, 0.10 ms; gate|up 1.10 T, 0.56 ms),
//   which dp4a cannot approach.
//
// The core of B1, B2, B3 and B9 (mma_tile, launched as w4a8_mma_kernel and,
// for B2, w4a8_gateup_kernel):
// * int8 tensor cores: mma.sync m16n8k32 s8 x s8 -> s32. A is the act codes
//   (M, K) row-major and B the weight rows (N, K) row-major, which is the
//   .col operand as it stands; both reach their fragments through ldmatrix
//   (32 bytes of K read as 16 b16 columns).
// * one CTA takes 128 x rows times 64 weight rows (8 warps, 4 along M x 2
//   along N, 32 x 32 each), so at decode (M <= 128) every weight byte is
//   read from device memory once. B1/B3/B9: a 128 x 64 output tile. B2
//   (the fused [gate | up] + act(g) * u): the 64 rows are 32 gate rows and
//   the up rows of the same 32 columns, each warp's n-tiles 0, 1 gate and
//   2, 3 up, so one thread holds the gate and up sums of its outputs and
//   the epilogue applies sx, rounds each half through the out dtype, runs
//   the activation and the product in f32 and rounds once at the store: a
//   128 x 32 output tile, nothing but the row index of the copies and the
//   epilogue changed;
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
//   before sx, to an (s, M, N) workspace (B2: (s, M, 2I), gate sums at
//   column j, up at I + j), and w4a8_reduce_kernel (B2: w4a8_gateup_reduce_
//   kernel, with B2's epilogue) adds them in split order, applies sx and
//   rounds once. No atomics: two launches give the same bits, and so does
//   the plain version summed in the same splits.
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

__device__ __forceinline__ float activate(int act, float g) {
  if (act == ACT_SILU) return g / (1.0f + expf(-g));
  if (act == ACT_GELU) return 0.5f * g * (1.0f + erff(g * 0.70710678118654752440f));
  // tanh approximation, as torch's gelu(approximate="tanh")
  const float kBeta = 0.79788456080286535588f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  float inner = kBeta * (g + kKappa * (g * g * g));
  return 0.5f * g * (1.0f + tanhf(inner));
}

// B2's epilogue on one output column: g and u are the gate and up sums
// times sx; each half rounds through the out dtype, the activation and the
// product run in f32, and the caller rounds once at the store
// (llm_compressor_tpu/kernels/w4a8_matmul.py:504-512)
template <typename OutT>
__device__ __forceinline__ float gate_up(int act, float g, float u) {
  return activate(act, round_out<OutT>(g)) * round_out<OutT>(u);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// B1 / B2 / B3 / B9: the int8 tensor-core core
// ---------------------------------------------------------------------------

constexpr int TM = 128;              // x rows of a CTA
constexpr int TN = 64;               // weight rows of a CTA (B2: 32 gate + 32 up)
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

// One CTA: TM x rows times TN weight rows. B1/B3/B9 (GU false): a TM x TN
// output tile of N columns. B2 (GU true): N = I output columns, 2I weight
// rows [gate | up]; warp column wc's 32 rows are the gate rows of output
// columns n0 + 16 wc + [0, 16) (n-tiles 0, 1) and the up rows of the same
// columns (n-tiles 2, 3), so a thread holds acc[.][nt] and acc[.][nt + 2]
// of one column and the tile is TM x 32.
template <int WFMT, typename OutT, bool GU>
__device__ __forceinline__ void mma_tile(const int8_t* __restrict__ x,
                                         const uint8_t* __restrict__ w,
                                         const float* __restrict__ scales,
                                         const float* __restrict__ sx, OutT* __restrict__ out,
                                         float* __restrict__ part, int M, int N, int C, int g,
                                         int act) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int MT = 2;                      // m16 tiles of a warp
  constexpr int CLD = code_ld(WFMT);
  constexpr int STAGE = stage_bytes(WFMT);
  constexpr int SC_AT = X_BYTES + TN * CLD;  // one group scale per weight row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int n0 = blockIdx.x * (GU ? TN / 2 : TN), m0 = blockIdx.y * TM;
  // the output column of shared weight row r (it exists if < N), and its
  // weight row
  auto col_of = [&](int r) { return GU ? n0 + ((r >> 5) << 4) + (r & 15) : n0 + r; };
  auto row_of = [&](int r) -> long { return GU && (r & 16) ? N + col_of(r) : col_of(r); };
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
        const bool ok = col_of(r) < N;
        cp_async16(cs + r * CLD + p * 16,
                   ok ? w + row_of(r) * row_bytes + ch.boff + p * 16 : w, ok ? 16 : 0);
      }
    } else {                       // TN rows x 8 pieces
#pragma unroll
      for (int j = 0; j < TN * 8 / NT; ++j) {
        const int r = xr + j * (NT / 8);
        const bool ok = col_of(r) < N;
        cp_async16(cs + r * CLD + xp * 16,
                   ok ? w + row_of(r) * row_bytes + ch.boff + xp * 16 : w, ok ? 16 : 0);
      }
    }
#pragma unroll
    for (int r = tid; r < TN; r += NT) {
      const bool ok = col_of(r) < N;
      cp_async4(reinterpret_cast<float*>(s + SC_AT) + r,
                ok ? scales + row_of(r) * G + ch.group : scales, ok ? 4 : 0);
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
  if (GU) {
    // B2: with one split, sx, each half's rounding, the activation and one
    // rounding at the store; else the f32 sums before sx, gate at column
    // j and up at N + j of the (splits, M, 2N) workspace
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + mt * 16 + gid + h * 8;
          const int j = n0 + (wn >> 1) + nt * 8 + tig * 2;
          if (m >= M || j >= N) continue;
          const float g0 = acc[mt][nt][2 * h], g1 = acc[mt][nt][2 * h + 1];
          const float u0 = acc[mt][nt + 2][2 * h], u1 = acc[mt][nt + 2][2 * h + 1];
          if (splits == 1) {
            const float sm = sx[m];
            const float v0 = gate_up<OutT>(act, __fmul_rn(g0, sm), __fmul_rn(u0, sm));
            const float v1 = gate_up<OutT>(act, __fmul_rn(g1, sm), __fmul_rn(u1, sm));
            const long at = (long)m * N + j;
            if (pairs_ok) {
              store2(out + at, v0, v1);
            } else {
              out[at] = to_out<OutT>(v0);
              if (j + 1 < N) out[at + 1] = to_out<OutT>(v1);
            }
          } else {
            float* const p = part + ((long)z * M + m) * 2 * N + j;
            if (pairs_ok) {
              store2(p, g0, g1);
              store2(p + N, u0, u1);
            } else {
              p[0] = g0;
              p[N] = u0;
              if (j + 1 < N) {
                p[1] = g1;
                p[N + 1] = u1;
              }
            }
          }
        }
    return;
  }
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

// The core's two kernels (distinct names for the profiler): B1/B3/B9, and
// B2 (act: ACT_*)
template <int WFMT, typename OutT>
__global__ void __launch_bounds__(NT, 2)
w4a8_mma_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ scales, const float* __restrict__ sx,
                OutT* __restrict__ out, float* __restrict__ part, int M, int N, int C, int g,
                int act) {
  mma_tile<WFMT, OutT, false>(x, w, scales, sx, out, part, M, N, C, g, act);
}

template <int WFMT, typename OutT>
__global__ void __launch_bounds__(NT, 2)
w4a8_gateup_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scales, const float* __restrict__ sx,
                   OutT* __restrict__ out, float* __restrict__ part, int M, int N, int C, int g,
                   int act) {
  mma_tile<WFMT, OutT, true>(x, w, scales, sx, out, part, M, N, C, g, act);
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

// B2's: out[m, j] = to_out(act(g) * u) from part (splits, M, 2I), gate
// sums at column j and up sums at I + j, each added in split order, times
// sx, each half rounded through the out dtype (gate_up)
template <typename OutT>
__global__ void __launch_bounds__(256)
w4a8_gateup_reduce_kernel(const float* __restrict__ part, const float* __restrict__ sx,
                          OutT* __restrict__ out, int M, int I, int splits, int act) {
  const long MI = (long)M * I;
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= MI) return;
  const long m = i / I;
  const float* const p = part + i + m * I;  // row m of the (M, 2I) slice
  float g = p[0], u = p[I];
  for (int z = 1; z < splits; ++z) {
    g = __fadd_rn(g, p[z * 2 * MI]);
    u = __fadd_rn(u, p[z * 2 * MI + I]);
  }
  const float sm = sx[m];
  out[i] = to_out<OutT>(gate_up<OutT>(act, __fmul_rn(g, sm), __fmul_rn(u, sm)));
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

template <int WFMT, typename OutT, bool GU>
cudaError_t launch_mma(const int8_t* x, const uint8_t* w, const float* s, const float* sx,
                       void* out, float* part, int M, int N, int C, int g, int splits, int act,
                       cudaStream_t stream) {
  constexpr int tile_n = GU ? TN / 2 : TN;
  dim3 grid((N + tile_n - 1) / tile_n, (M + TM - 1) / TM, splits);
  constexpr int smem = STAGES * stage_bytes(WFMT);
  auto kern = GU ? &w4a8_gateup_kernel<WFMT, OutT> : &w4a8_mma_kernel<WFMT, OutT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  OutT* const o = static_cast<OutT*>(out);
  kern<<<grid, NT, smem, stream>>>(x, w, s, sx, o, part, M, N, C, g, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long MN = (long)M * N;
  const unsigned blocks = (unsigned)((MN + 255) / 256);
  if (GU)
    w4a8_gateup_reduce_kernel<OutT><<<blocks, 256, 0, stream>>>(part, sx, o, M, N, splits, act);
  else
    w4a8_reduce_kernel<OutT><<<blocks, 256, 0, stream>>>(part, sx, o, M, N, splits);
  return cudaGetLastError();
}

template <typename OutT, bool GU>
cudaError_t launch_core(const void* x, const void* w, const void* scales, const void* sx,
                        void* out, void* part, int M, int N, int C, int g, int wfmt,
                        int splits, int act, cudaStream_t stream) {
  const int8_t* xp = static_cast<const int8_t*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  const float* sxp = static_cast<const float*>(sx);
  float* pp = static_cast<float*>(part);
  if (wfmt == W_INT8)
    return launch_mma<W_INT8, OutT, GU>(xp, wp, sp, sxp, out, pp, M, N, C, g, splits, act,
                                        stream);
  if (wfmt == W_PAIRS)
    return launch_mma<W_PAIRS, OutT, GU>(xp, wp, sp, sxp, out, pp, M, N, C, g, splits, act,
                                         stream);
  return launch_mma<W_HALVES, OutT, GU>(xp, wp, sp, sxp, out, pp, M, N, C, g, splits, act,
                                        stream);
}

// gateup: B2 (N = I output columns over 2I weight rows, act an ACT_*)
cudaError_t launch_matmul(const void* x, const void* w, const void* scales, const void* sx,
                          void* out, void* part, int M, int N, int C, int g, int wfmt,
                          int out_bf16, int splits, bool gateup, int act, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || g <= 0 || g % KC || C % g || wfmt < W_INT8 || wfmt > W_HALVES)
    return cudaErrorInvalidValue;
  if (gateup && (act < ACT_SILU || act > ACT_GELU_TANH)) return cudaErrorInvalidValue;
  const int G = C / g;
  if (wfmt == W_PAIRS && G % 2) return cudaErrorInvalidValue;
  const int units = wfmt == W_PAIRS ? G / 2 : G;
  if (splits < 1 || splits > units || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (gateup)
    return out_bf16 ? launch_core<__nv_bfloat16, true>(x, w, scales, sx, out, part, M, N, C, g,
                                                       wfmt, splits, act, stream)
                    : launch_core<float, true>(x, w, scales, sx, out, part, M, N, C, g, wfmt,
                                               splits, act, stream);
  return out_bf16 ? launch_core<__nv_bfloat16, false>(x, w, scales, sx, out, part, M, N, C, g,
                                                      wfmt, splits, 0, stream)
                  : launch_core<float, false>(x, w, scales, sx, out, part, M, N, C, g, wfmt,
                                              splits, 0, stream);
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
                           false, 0, static_cast<cudaStream_t>(stream)));
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
                           false, 0, st));
}

// B2, fused gate|up + activation: w holds 2I rows ([gate | up]) laid out
// as for llmc_w4a8_matmul, scales (2I, C/group); out (M, I); act 1 silu,
// 2 gelu, 3 gelu (tanh); with splits > 1 part an f32 workspace of
// splits x M x 2I. Returns cudaGetLastError().
extern "C" int llmc_w4a8_gateup(const void* x, const void* w, const void* scales,
                                const void* sx, void* out, void* part, int M, int I, int C,
                                int group, int wfmt, int out_bf16, int act, int splits,
                                void* stream) {
  return int(launch_matmul(x, w, scales, sx, out, part, M, I, C, group, wfmt, out_bf16, splits,
                           true, act, static_cast<cudaStream_t>(stream)));
}
