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
// m % 128 != 0. Here one block takes one row, so nothing of that shape
// constraint remains: every power-of-two m from 1 up runs here (R2 at
// head_dim 64 included), and the H_K contraction runs in the kernel too.
//
// Bound on this card: bytes. Each element is read once and written once,
// and the transform does log2(m) + K adds per element, so a row of n values
// moves n * (in + out) bytes for about 13 f32 adds per element at
// n = 8192 — far below the card's 295 operations per byte. At the
// flagship's widths (4096 x 8192 bf16: 134 MB) that is about 40 us at
// 3.35 TB/s. Design, simple first: the row lives in shared memory as f32
// (at most 232,448 bytes, so n <= 58,112), loaded once and written once;
// the log2(m) butterfly stages run over shared memory in the plain
// version's order (stage h pairs a with a + h inside each 2h block), a
// barrier between stages; then each output (k, j) sums its K terms
// +-s[l*m + j] in order l = 0..K-1 and is scaled and rounded once to the
// output type. __fadd_rn / __fsub_rn / __fmul_rn keep the arithmetic that
// of the plain version, so the two agree bitwise. Not done yet: register
// butterflies with warp shuffles for the first five stages, several rows
// per block for small n, vector loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
hadamard_kernel(const T* __restrict__ x, T* __restrict__ out, const int8_t* __restrict__ base,
                int n, int m, int K, float scale) {
  extern __shared__ float s[];
  const long row = blockIdx.x;
  const T* xr = x + row * n;
  T* orow = out + row * n;
  for (int i = threadIdx.x; i < n; i += THREADS) s[i] = load_f(xr + i);
  __syncthreads();

  // butterfly stages over every m-block of the row: pair p of stage h sits
  // at a = (p / h) * 2h + p % h; m-blocks are 2h-aligned, so pairs never
  // cross them
  const int half = n >> 1;
  for (int lg = 0; (1 << lg) < m; ++lg) {
    const int h = 1 << lg;
    for (int p = threadIdx.x; p < half; p += THREADS) {
      const int a = ((p >> lg) << (lg + 1)) + (p & (h - 1));
      const float u = s[a], v = s[a + h];
      s[a] = __fadd_rn(u, v);
      s[a + h] = __fsub_rn(u, v);
    }
    __syncthreads();
  }

  if (K == 1) {
    for (int i = threadIdx.x; i < n; i += THREADS) store_f(orow + i, __fmul_rn(s[i], scale));
    return;
  }
  // base contraction: y[k*m + j] = sum_l H_K[k, l] * s[l*m + j], in order l
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int k = i / m, j = i - k * m;
    const int8_t* hrow = base + k * K;
    float acc = 0.f;
    for (int l = 0; l < K; ++l) {
      const float v = s[l * m + j];
      acc = hrow[l] > 0 ? __fadd_rn(acc, v) : __fsub_rn(acc, v);
    }
    store_f(orow + i, __fmul_rn(acc, scale));
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, const void* base, int rows, int n, int m, int K,
                   float scale, cudaStream_t stream) {
  const size_t smem = size_t(n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hadamard_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  hadamard_kernel<T><<<rows, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const int8_t*>(base), n, m,
      K, scale);
  return cudaGetLastError();
}

}  // namespace

// x, out (rows, n) contiguous, f32 (out_kind 0) or bf16 (1); base: the
// K x K +-1 matrix as int8, row-major (null when K == 1); n = K * m with m a
// power of two. Returns cudaGetLastError().
extern "C" int llmc_hadamard(const void* x, void* out, const void* base, int rows, int n, int m,
                             int K, float scale, int out_kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n != K * m || m < 1 || (m & (m - 1)) || (K > 1 && base == nullptr))
    return int(cudaErrorInvalidValue);
  switch (out_kind) {
    case 0: return int(launch<float>(x, out, base, rows, n, m, K, scale, st));
    case 1: return int(launch<__nv_bfloat16>(x, out, base, rows, n, m, K, scale, st));
    default: return int(cudaErrorInvalidValue);
  }
}
