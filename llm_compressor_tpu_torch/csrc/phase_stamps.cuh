// Phase stamps for tools/phase_stamps.py, compiled in only with
// -DLLMC_CLOCKS. A source numbers its stamps in an enum that holds ST_SM,
// ST_T0, ST_T1, ST_ENTRY and ST_END (at most MAX_STAMPS in all) and
// includes this header outside any namespace. STAMP_BEGIN() at a CTA's
// entry and STAMP_FINISH() at its exit record its SM, the global timer (ns)
// and SM clocks; STAMP(k, v) records any other value, as thread 0 sees it.
#pragma once

#ifdef LLMC_CLOCKS
constexpr int MAX_STAMPED = 1 << 16;
constexpr int MAX_STAMPS = 16;
__device__ long long llmc_stamp_buf[MAX_STAMPED][MAX_STAMPS];
__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k, v) \
  if (threadIdx.x == 0 && blockIdx.x < MAX_STAMPED) llmc_stamp_buf[blockIdx.x][k] = (v)
#define CLOCK() clock64()
#define STAMP_BEGIN()         \
  STAMP(ST_T0, gtimer());     \
  STAMP(ST_ENTRY, CLOCK())
#define STAMP_FINISH()                                  \
  do {                                                  \
    __syncthreads();                                    \
    unsigned sm_;                                       \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));    \
    STAMP(ST_SM, sm_);                                  \
    STAMP(ST_END, CLOCK());                             \
    STAMP(ST_T1, gtimer());                             \
  } while (0)

// The first ``count`` CTAs' stamps of the last launch, (count, MAX_STAMPS)
// int64, into host memory ``dst``.
extern "C" int llmc_stamps(void* dst, int count) {
  return int(cudaMemcpyFromSymbol(dst, llmc_stamp_buf,
                                  size_t(count) * MAX_STAMPS * sizeof(long long)));
}
#else
#define STAMP(k, v)
#define CLOCK() 0LL
#define STAMP_BEGIN()
#define STAMP_FINISH()
#endif
