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
// packed weight once — the qkv projection of Llama-3.2-1B is 3.1 MB of int4
// codes plus 0.2 MB of scales and zeros, about 1 us at 3.35 TB/s; the int8
// head (263 MB) about 79 us. What held the first version back was latency:
// one CTA per 128 x 64 output tile (32 CTAs for the down projection on 132
// SMs), each walking all of K with synchronous 4-byte loads, about 5 us per
// 64-wide chunk. The design now:
// * split-K over whole groups (whole group pairs for int4 pair planes, so no
//   two CTAs read one byte): the grid's z dimension is the split, planned in
//   Python (kernels/dequant_matmul.py::split_plan) so that the tiles times
//   the splits reach 1.5 x the SM count. With s > 1 splits every CTA writes
//   its f32 partial tile to a workspace (s, M, N) that the wrapper
//   allocates, and dequant_matmul_reduce_kernel adds the partials in split
//   order 0, 1, ..., s-1 and rounds once to the output type: no atomics, so
//   two launches give the same bits;
// * a chunk is 64 K elements as two runs of 32 that share the bytes they
//   come from (the low and high nibbles of int4 codes; a 64-byte span of
//   int8 / fp8 codes): x, the raw codes and the runs' scales and zero points
//   are copied into shared memory with cp.async (16 bytes a thread for x and
//   the codes, neighbouring threads on neighbouring addresses; each scale
//   once per CTA), in a ring of STAGES chunks, so that two chunks are in
//   flight while one is dequantized and one multiplied;
// * each thread dequantizes 16 codes from one 16-byte shared-memory vector
//   into a double-buffered bf16 tile (integer codes reach f32 by an exact
//   add of 2^23, not by the quarter-rate int -> float conversion; two
//   values round to bf16 in one conversion), and the 8 warps run mma.sync
//   m16n8k16 bf16 -> f32 on 32 x 32 sub-tiles, fragments through ldmatrix:
//   one __syncthreads per chunk.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, M = 128, int4
// g128 with zero points (ms, before -> now): down 0.6524 -> 0.0414 (8
// splits), o 0.1669 -> 0.0190, qkv 0.1660 -> 0.0265, gate|up 0.1766 ->
// 0.0664 (1 split), int8 head 1.1377 -> 0.4209; a bf16 torch.matmul takes
// 0.0122-0.2169. The reduce kernel takes about 0.003 ms of the split cases.
// What bounds it now is the chain of phases inside a CTA (PERF.md): no one
// phase of copy, barrier, mma and dequant holds it alone.
// Any even group size runs. Where g is not a multiple of the chunk, a
// group's last chunk is partial and its missing elements are zero-filled,
// in x and in the codes alike. Where a group does not start on a 16-byte
// boundary (g % 16 != 0 for int8 / fp8 / pair planes, g % 32 != 0 for
// group halves), the kernel's VEC = false build copies x and the codes
// into the same ring with plain loads, one element at a time.
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
constexpr int KC = 64;           // K elements per chunk: two runs of RUN
constexpr int RUN = 32;
constexpr int LDS = KC + 8;      // padded bf16 row: conflict-free fragments and ldmatrix
constexpr int THREADS = 256;
constexpr int STAGES = 4;
constexpr int RAW_LD = 64;       // bytes of raw codes per weight row and chunk (int4 uses 32)
constexpr int XS_BYTES = TM * LDS * 2;
constexpr int RAW_BYTES = TN * RAW_LD;
constexpr int SZ_FLOATS = TN * 2;    // one scale (or zero) per row and run
constexpr int STAGE_BYTES = XS_BYTES + RAW_BYTES + 2 * SZ_FLOATS * 4;
constexpr int WS_BYTES = TN * LDS * 2;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * WS_BYTES;
static_assert(STAGE_BYTES % 16 == 0 && XS_BYTES % 16 == 0, "16-byte cp.async targets");
static_assert(STAGES >= 3, "the ring keeps two chunks in flight");

enum Fmt { F_INT8 = 0, F_INT4_PAIRS = 1, F_INT4_HALVES = 2, F_FP8_E4M3 = 3, F_FP8_E5M2 = 4 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; fewer than 16 source bytes zero-fill the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// The unaligned build's copy: the first n elements (bf16 bits of x, or
// code bytes) read one at a time, the rest of the 16 bytes zero.
template <typename T>
__device__ __forceinline__ void copy16_sync(void* dst, const T* src, int n) {
  union {
    uint4 q;
    T e[16 / sizeof(T)];
  } v;
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) v.e[i] = i < n ? src[i] : T(0);
  *reinterpret_cast<uint4*>(dst) = v.q;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The value of one code (an int4 nibble, or a raw int8 / fp8 byte) as an
// exact f32. The integers skip the quarter-rate int -> float conversion:
// the bits of 2^23 + n are the float 2^23 + n, and one exact subtraction
// leaves n - 8 (int4, biased) or the signed byte (int8, n = byte ^ 0x80).
template <int FMT>
__device__ __forceinline__ float code_value(uint32_t code) {
  if (FMT == F_INT4_PAIRS || FMT == F_INT4_HALVES) {
    return __fsub_rn(__uint_as_float(0x4B000000u | code), 8388616.0f);
  } else if (FMT == F_INT8) {
    return __fsub_rn(__uint_as_float(0x4B000000u | (code ^ 0x80u)), 8388736.0f);
  } else if (FMT == F_FP8_E4M3) {
    __nv_fp8_e4m3 f;
    f.__x = static_cast<uint8_t>(code);
    return float(f);
  } else {
    __nv_fp8_e5m2 f;
    f.__x = static_cast<uint8_t>(code);
    return float(f);
  }
}

// One code dequantized in f32 with its body's arithmetic (rounded to bf16
// by the caller).
template <int FMT>
__device__ __forceinline__ float dequant(uint32_t code, float s, float sb, float z, bool has_z) {
  const float v = code_value<FMT>(code);
  if (FMT == F_INT4_PAIRS || FMT == F_INT4_HALVES) {
    return has_z ? __fmul_rn(__fsub_rn(v, z), s) : __fmul_rn(v, sb);
  } else if (FMT == F_INT8) {
    return __fmul_rn(__fsub_rn(v, z), s);
  } else {
    return __fadd_rn(__fmul_rn(v, s), z);
  }
}

// two f32 values rounded to nearest-even bf16 in one conversion, lo first
__device__ __forceinline__ uint32_t to_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <typename OutT> __device__ __forceinline__ OutT to_out(float v);
template <> __device__ __forceinline__ float to_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half to_out<__half>(float v) {
  return __float2half_rn(v);
}

// Chunks per unit (group; group pair for pair planes): the last one is
// partial where g is not a multiple of what a chunk takes of a unit.
template <int FMT>
__device__ __forceinline__ int chunks_per_unit(int g) {
  if (FMT == F_INT4_PAIRS) return (g + RUN - 1) / RUN;
  if (FMT == F_INT4_HALVES) return ((g >> 1) + RUN - 1) / RUN;
  return (g + KC - 1) / KC;
}

// Where chunk c of a split lies: the byte offset of its raw codes in a
// weight row, the K index of its two runs, their groups, and how many of
// each run's 32 elements lie in the group (v0, v1). A split walks units,
// cpu chunks per unit.
struct Chunk {
  long boff;
  long k0, k1;
  int ga, gb;
  int v0, v1;
};

template <int FMT>
__device__ __forceinline__ Chunk locate(int c, int u0, int cpu, int g) {
  const int du = c / cpu;
  const int cc = c - du * cpu;
  const int u = u0 + du;
  Chunk ch;
  if (FMT == F_INT4_PAIRS) {          // bytes of pair u: lo = group 2u, hi = group 2u + 1
    ch.boff = (long)u * g + cc * RUN;
    ch.k0 = 2L * u * g + cc * RUN;
    ch.k1 = ch.k0 + g;
    ch.ga = 2 * u;
    ch.gb = 2 * u + 1;
    ch.v0 = ch.v1 = min(RUN, g - cc * RUN);
  } else if (FMT == F_INT4_HALVES) {  // bytes of group u: lo = element i, hi = i + g/2
    ch.boff = (long)u * (g >> 1) + cc * RUN;
    ch.k0 = (long)u * g + cc * RUN;
    ch.k1 = ch.k0 + (g >> 1);
    ch.ga = ch.gb = u;
    ch.v0 = ch.v1 = min(RUN, (g >> 1) - cc * RUN);
  } else {                            // one byte per element
    ch.boff = (long)u * g + cc * KC;
    ch.k0 = ch.boff;
    ch.k1 = ch.k0 + RUN;
    ch.ga = ch.gb = u;
    ch.v0 = min(RUN, g - cc * KC);
    ch.v1 = max(0, min(RUN, g - cc * KC - RUN));
  }
  return ch;
}

template <int FMT, bool VEC, typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
dequant_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                      const float* __restrict__ scales, const float* __restrict__ zeros,
                      OutT* __restrict__ out, float* __restrict__ part, int M, int N, int C,
                      int g) {
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* const wsb = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * STAGE_BYTES);

  constexpr bool PACKED4 = (FMT == F_INT4_PAIRS || FMT == F_INT4_HALVES);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;         // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int G = C / g;
  const bool has_z = zeros != nullptr;
  const long row_bytes = PACKED4 ? C / 2 : C;

  // this split's units [u0, u1), the splits differing by at most one unit
  const int units = FMT == F_INT4_PAIRS ? G / 2 : G;
  const int splits = gridDim.z, z = blockIdx.z;
  const int u0 = (int)((long)z * units / splits), u1 = (int)((long)(z + 1) * units / splits);
  const int cpu = chunks_per_unit<FMT>(g);
  const int nch = (u1 - u0) * cpu;

  auto stage_x = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * STAGE_BYTES);
  };
  auto stage_raw = [&](int st) { return smem + st * STAGE_BYTES + XS_BYTES; };
  auto stage_sz = [&](int st) {
    return reinterpret_cast<float*>(smem + st * STAGE_BYTES + XS_BYTES + RAW_BYTES);
  };

  // copies of chunk c into stage st: x (TM rows x two runs of 32 bf16, four
  // 16-byte pieces per run), the raw codes (TN rows x 32 or 64 bytes) and
  // both runs' scales (and zero points) of each row
  // what this thread copies in every chunk: x rows xr + 32 j (j < 4), one
  // 16-byte piece (run xrun, element xk of the run) of each; one 16-byte
  // piece of weight row wr's codes; one scale or zero point of row sr
  const int xr = tid >> 3, xrun = (tid >> 2) & 1, xk = (tid & 3) * 8;
  const __nv_bfloat16* const xsrc = x + (long)(m0 + xr) * C + xk;
  const int wr = PACKED4 ? tid >> 1 : tid >> 2, wseg = PACKED4 ? tid & 1 : tid & 3;
  const uint8_t* const wsrc = w + (long)(n0 + wr) * row_bytes + wseg * 16;
  const int sr = (tid & 127) >> 1, srun = tid & 1;
  const float* const ssrc = (tid < 128 ? scales : zeros) + (long)(n0 + sr) * G;
  const bool copies_sz = tid < 128 || has_z;
  const int sz_at = (tid < 128 ? 0 : SZ_FLOATS) + sr * 2 + srun;

  // a piece holds only what lies in the group (xn elements, wb bytes)
  auto issue = [&](int c, int st) {
    const Chunk ch = locate<FMT>(c, u0, cpu, g);
    __nv_bfloat16* xs = stage_x(st) + xr * LDS + xrun * RUN + xk;
    const long kx = xrun ? ch.k1 : ch.k0;
    const int xn = min(max((xrun ? ch.v1 : ch.v0) - xk, 0), 8);
#pragma unroll
    for (int j = 0; j < TM * 8 / THREADS; ++j) {
      const int n = m0 + xr + 32 * j < M ? xn : 0;
      const __nv_bfloat16* src = xsrc + 32L * j * C + kx;
      if (VEC)
        cp_async16(xs + 32 * j * LDS, n ? src : x, 2 * n);
      else
        copy16_sync(xs + 32 * j * LDS, reinterpret_cast<const uint16_t*>(src), n);
    }
    if (!PACKED4 || tid < TN * 2) {
      const int wv = PACKED4 ? ch.v0 : (wseg >> 1 ? ch.v1 : ch.v0);
      const int wb = min(max(wv - (PACKED4 ? wseg : wseg & 1) * 16, 0), 16);
      uint8_t* dst = stage_raw(st) + wr * RAW_LD + wseg * 16;
      if (VEC)
        cp_async16(dst, wb ? wsrc + ch.boff : w, wb);
      else
        copy16_sync(dst, wsrc + ch.boff, wb);
    }
    if (copies_sz) cp_async4(stage_sz(st) + sz_at, ssrc + (srun ? ch.gb : ch.ga));
  };

  // raw stage st -> bf16 weight tile buf: thread (row, q) turns one 16-byte
  // vector of codes into 16 values of one run
  auto dequant_chunk = [&](int st, int buf) {
    const int row = tid >> 2, q = tid & 3;
    const int seg = PACKED4 ? (q & 1) : q;   // int4: q >> 1 picks the nibble
    const int run = q >> 1;
    const int kbase = PACKED4 ? run * RUN + seg * 16 : q * 16;
    const uint4 v = *reinterpret_cast<const uint4*>(stage_raw(st) + row * RAW_LD + seg * 16);
    const float* sz = stage_sz(st);
    const float s = sz[row * 2 + run];
    const float zz = has_z ? sz[SZ_FLOATS + row * 2 + run] : 0.0f;
    const float sb = __bfloat162float(__float2bfloat16_rn(s));
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    uint32_t packed[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t wd = words[j >> 1] >> ((j & 1) * 16);
      uint32_t b0 = wd & 0xFF, b1 = (wd >> 8) & 0xFF;
      if (PACKED4) {
        b0 = (b0 >> (4 * run)) & 0xF;
        b1 = (b1 >> (4 * run)) & 0xF;
      }
      packed[j] = to_bf16x2(dequant<FMT>(b0, s, sb, zz, has_z),
                            dequant<FMT>(b1, s, sb, zz, has_z));
    }
    uint4* dst = reinterpret_cast<uint4*>(wsb + buf * (TN * LDS) + row * LDS + kbase);
    dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  // Ring: chunk c sits in stage c % STAGES. Before the barrier of
  // iteration c this thread's copies of chunk c + 1 have landed; after it,
  // everyone's have, the tile of chunk c is dequantized and every thread is
  // done with chunk c - 1, whose stage takes chunk c + STAGES - 1.
#pragma unroll 1
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nch) issue(p, p);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (nch > 0) dequant_chunk(0, 0);

#pragma unroll 1
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    if (c + STAGES - 1 < nch) issue(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();

    const __nv_bfloat16* xs = stage_x(c % STAGES);
    const __nv_bfloat16* ws = wsb + (c & 1) * (TN * LDS);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], xs + (wm + mt * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {   // n-tiles 2np and 2np + 1, both k halves
        uint32_t r[4];
        ldmatrix_x4(r, ws + (wn + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk +
                           ((lane >> 3) & 1) * 8);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    if (c + 1 < nch) dequant_chunk((c + 1) % STAGES, (c + 1) & 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + gid + h * 8;
        const int n = n0 + wn + nt * 8 + 2 * tig;
        if (m >= M) continue;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (splits == 1) {
          out[(long)m * N + n] = to_out<OutT>(v0);
          out[(long)m * N + n + 1] = to_out<OutT>(v1);
        } else {
          *reinterpret_cast<float2*>(part + ((long)z * M + m) * N + n) = make_float2(v0, v1);
        }
      }
}

// out = part[0] + part[1] + ... + part[s - 1], added in that order, rounded
// once; four outputs per thread (N is a multiple of 64)
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
dequant_matmul_reduce_kernel(const float* __restrict__ part, OutT* __restrict__ out, long MN,
                             int splits) {
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;
  if (4 * i >= MN) return;
  float4 a = reinterpret_cast<const float4*>(part)[i];
  for (int z = 1; z < splits; ++z) {
    const float4 b = reinterpret_cast<const float4*>(part + z * MN)[i];
    a.x = __fadd_rn(a.x, b.x);
    a.y = __fadd_rn(a.y, b.y);
    a.z = __fadd_rn(a.z, b.z);
    a.w = __fadd_rn(a.w, b.w);
  }
  out[4 * i] = to_out<OutT>(a.x);
  out[4 * i + 1] = to_out<OutT>(a.y);
  out[4 * i + 2] = to_out<OutT>(a.z);
  out[4 * i + 3] = to_out<OutT>(a.w);
}

// vec: every group starts on a 16-byte boundary, so x and the codes go
// through cp.async (the VEC build); else through plain loads
template <int FMT, typename OutT>
cudaError_t launch_fmt(dim3 grid, bool vec, cudaStream_t stream, const __nv_bfloat16* x,
                       const uint8_t* w, const float* s, const float* z, OutT* out, float* part,
                       int M, int N, int C, int g) {
  auto kern = vec ? dequant_matmul_kernel<FMT, true, OutT>
                  : dequant_matmul_kernel<FMT, false, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, SMEM_BYTES, stream>>>(x, w, s, z, out, part, M, N, C, g);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch(const void* x, const void* w, const void* scales, const void* zeros,
                   void* out, void* part, int M, int N, int C, int g, int fmt, int splits,
                   cudaStream_t stream) {
  if (M <= 0 || N % TN || g <= 0 || g % 2 || C % g || splits < 1 ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  dim3 grid(N / TN, (M + TM - 1) / TM, splits);
  const bool vec = g % (fmt == F_INT4_HALVES ? 32 : 16) == 0;
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  const float* zp = static_cast<const float*>(zeros);
  OutT* op = static_cast<OutT*>(out);
  float* pp = static_cast<float*>(part);
  cudaError_t err;
  switch (fmt) {
    case F_INT8:
      err = launch_fmt<F_INT8>(grid, vec, stream, xp, wp, sp, zp, op, pp, M, N, C, g);
      break;
    case F_INT4_PAIRS:
      err = launch_fmt<F_INT4_PAIRS>(grid, vec, stream, xp, wp, sp, zp, op, pp, M, N, C, g);
      break;
    case F_INT4_HALVES:
      err = launch_fmt<F_INT4_HALVES>(grid, vec, stream, xp, wp, sp, zp, op, pp, M, N, C, g);
      break;
    case F_FP8_E4M3:
      err = launch_fmt<F_FP8_E4M3>(grid, vec, stream, xp, wp, sp, zp, op, pp, M, N, C, g);
      break;
    case F_FP8_E5M2:
      err = launch_fmt<F_FP8_E5M2>(grid, vec, stream, xp, wp, sp, zp, op, pp, M, N, C, g);
      break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long MN = (long)M * N;
  const long blocks = (MN / 4 + THREADS - 1) / THREADS;
  dequant_matmul_reduce_kernel<OutT><<<(unsigned)blocks, THREADS, 0, stream>>>(pp, op, MN, splits);
  return cudaGetLastError();
}

}  // namespace

// x (M, C) bf16, 16-byte aligned; w codes (N, C/2) for int4, (N, C) for
// int8 / fp8, 16-byte aligned; scales (N, C/g) f32; zeros (N, C/g) f32 or
// null; out (M, N) f32 (out_kind 0), bf16 (1) or f16 (2), the caller's
// dtype; splits K-splits over whole groups (pairs for pair planes), and with
// splits > 1 part an f32 workspace of splits x M x N. N % 64 == 0 and g
// even. Returns cudaGetLastError().
extern "C" int llmc_dequant_matmul(const void* x, const void* w, const void* scales,
                                   const void* zeros, void* out, void* part, int M, int N, int C,
                                   int group, int fmt, int out_kind, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0:
      return int(launch<float>(x, w, scales, zeros, out, part, M, N, C, group, fmt, splits, st));
    case 1:
      return int(launch<__nv_bfloat16>(x, w, scales, zeros, out, part, M, N, C, group, fmt,
                                       splits, st));
    case 2:
      return int(launch<__half>(x, w, scales, zeros, out, part, M, N, C, group, fmt, splits, st));
    default: return int(cudaErrorInvalidValue);
  }
}
