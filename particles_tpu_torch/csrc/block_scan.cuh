// Block-wide prefix sums built from warp shuffles, shared by the kernels of
// this directory.  NT (threads per block) must be a multiple of 32 and at
// most 1024, so that the per-warp totals fit one warp.
#pragma once

#include <cuda_runtime.h>

namespace pt {

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const T n = __shfl_up_sync(0xffffffffu, v, k);
    if (lane >= k) v += n;
  }
  return v;
}

// Exclusive scan of one value per thread in thread order; *total receives
// the block's sum (the same in every thread).  For integer T the result is
// exact; for floating T only *total is meant to be used (a fixed-order
// sum).  Every thread of the block must call it.
template <typename T, int NT>
__device__ __forceinline__ T block_exclusive_scan(T v, T* total) {
  static_assert(NT % 32 == 0 && NT <= 1024, "NT: multiple of 32, <= 1024");
  constexpr int kWarps = NT / 32;
  __shared__ T warp_incl[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T incl = warp_inclusive_scan(v);
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T s = lane < kWarps ? warp_incl[lane] : T(0);
    s = warp_inclusive_scan(s);
    if (lane < kWarps) warp_incl[lane] = s;
  }
  __syncthreads();
  const T before = warp == 0 ? T(0) : warp_incl[warp - 1];
  *total = warp_incl[kWarps - 1];
  __syncthreads();  // warp_incl is reused by the next call
  return before + (incl - v);
}

}  // namespace pt
