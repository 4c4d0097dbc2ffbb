// Inclusive running maximum of int32 on Hopper (sm_90a): B6.
//
// Replaces particles_tpu/ops/cummax_kernel.py::_cummax_kernel (launched by
// _running_max_pallas, public function running_max), which enforces the
// nondecreasing z contract where a z-form is built from a float cumsum:
//
//   y_i = max(z_0, ..., z_i)
//
// What bounds it: bytes.  The least traffic is one read of z and one write
// of y (8 bytes a particle, 8 MB at N = 2^20); it reads z twice, the second
// time from the 50 MB L2.  The TPU kernel carried the running max through
// its sequential grid in SMEM; CUDA blocks run in no order, so this is a
// scan across blocks in three launches: each block's maximum, a one-block
// exclusive max-scan of those maxima, then each block's own scan seeded
// with its prefix.  INT_MIN is the identity, so negative values and a
// ragged last block need no special case.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;               // threads per streaming block
constexpr int kItems = 4;                   // consecutive elements a thread
constexpr int kTile = kThreads * kItems;    // elements per streaming block
constexpr int kScanThreads = 1024;          // the single-block pass

// Pass 0: each block's maximum.
__global__ void k_block_max(const int32_t* __restrict__ z, int64_t N,
                            int32_t* __restrict__ bmax) {
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  int32_t m = INT_MIN;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < N) m = max(m, z[i]);
  }
  int32_t tot;
  pt::block_exclusive_scan<int32_t, kThreads>(m, INT_MIN, pt::Max(), &tot);
  if (threadIdx.x == 0) bmax[blockIdx.x] = tot;
}

// One block: exclusive max-scan of the block maxima, in place.
__global__ void k_scan_max(int32_t* __restrict__ bmax, int64_t nb) {
  int32_t carry = INT_MIN;
  for (int64_t c = 0; c < nb; c += kScanThreads) {
    const int64_t i = c + threadIdx.x;
    const int32_t v = i < nb ? bmax[i] : INT_MIN;
    int32_t tot;
    const int32_t ex = pt::block_exclusive_scan<int32_t, kScanThreads>(
        v, INT_MIN, pt::Max(), &tot);
    if (i < nb) bmax[i] = max(carry, ex);
    carry = max(carry, tot);
  }
}

// Pass 1: scan inside the block from the block's prefix.
__global__ void k_apply(const int32_t* __restrict__ z, int64_t N,
                        const int32_t* __restrict__ bmax,
                        int32_t* __restrict__ y) {
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  int32_t v[kItems];
  int32_t m = INT_MIN;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    v[k] = i < N ? z[i] : INT_MIN;
    m = max(m, v[k]);
  }
  int32_t tot;
  int32_t run = max(bmax[blockIdx.x],
                    pt::block_exclusive_scan<int32_t, kThreads>(
                        m, INT_MIN, pt::Max(), &tot));
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    run = max(run, v[k]);
    if (i < N) y[i] = run;
  }
}

}  // namespace

extern "C" {

// Elements per streaming block: the caller sizes the scratch buffer as
// nb = ceil(N / pt_cummax_tile()).
int pt_cummax_tile(void) { return kTile; }

// z: (N,) int32, y: (N,) int32 out, bmax: (nb,) int32 scratch, all on the
// device.  Returns cudaGetLastError().
int pt_running_max(const void* z, long long N, void* y, void* bmax,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nb = (N + kTile - 1) / kTile;
  k_block_max<<<(unsigned)nb, kThreads, 0, s>>>((const int32_t*)z, N,
                                                (int32_t*)bmax);
  k_scan_max<<<1, kScanThreads, 0, s>>>((int32_t*)bmax, nb);
  k_apply<<<(unsigned)nb, kThreads, 0, s>>>((const int32_t*)z, N,
                                            (const int32_t*)bmax,
                                            (int32_t*)y);
  return (int)cudaGetLastError();
}

}  // extern "C"
