// Sorted-merge rank count on Hopper (sm_90a): B5.
//
// Replaces particles_tpu/ops/merge_rank_kernel.py::_merge_kernel (launched
// by _merge_pallas, public function merge_rank_counts).  For uniforms su
// ((L,) f32, sorted) and cumulative weights cs ((N,) f32, nondecreasing) it
// computes
//
//   z_i = min(#{j < L : su_j <= cs_i}, M)        (int32)
//
// the counts' inclusive cumsum of every inverse-CDF resampling scheme (a
// uniform tied with cs_i counts, as searchsorted side='left' on cs has it).
//
// What bounds it: bytes.  It reads su and cs and writes z (12 bytes a
// particle at L = N, 12 MB at N = 2^20), plus the binary searches' reads of
// su.  Design: one thread per cs_i finds the count by an upper-bound binary
// search in su; neighbouring threads search neighbouring keys, so their
// probes share cache lines, and su (4 MB at N = 2^20) stays in the 50 MB
// L2.  A binary search's result is nondecreasing in its key whatever the
// array holds, so z stays nondecreasing even where a float cumsum left su
// one ulp out of order.  The TPU kernel's chunked compare-and-count with
// scalar-prefetched block windows existed because the TPU has no fast
// search; there is no alignment gate and no L = N requirement here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void k_merge_rank(const float* __restrict__ su, int64_t L,
                             const float* __restrict__ cs, int64_t N,
                             int64_t M, int32_t* __restrict__ z) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  const float c = cs[i];
  int64_t lo = 0, hi = L;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(su + mid) <= c) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  z[i] = (int32_t)(lo < M ? lo : M);
}

}  // namespace

extern "C" {

// su: (L,) f32, cs: (N,) f32, z: (N,) int32 out, all on the device.
// Returns cudaGetLastError().
int pt_merge_rank_counts(const void* su, long long L, const void* cs,
                         long long N, long long M, void* z, void* stream) {
  const int64_t nb = (N + kThreads - 1) / kThreads;
  k_merge_rank<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)su, L, (const float*)cs, N, M, (int32_t*)z);
  return (int)cudaGetLastError();
}

}  // extern "C"
