// Block-wide prefix scans built from warp shuffles, shared by the kernels of
// this directory.  NT (threads per block) must be a multiple of 32 and at
// most 1024, so that the per-warp totals fit one warp.  Op is an
// associative and commutative operator (Sum, Max) with `identity` as its
// neutral element.
#pragma once

#include <cuda_runtime.h>

namespace pt {

struct Sum {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

struct Max {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a > b ? a : b;
  }
};

template <typename T, typename Op>
__device__ __forceinline__ T warp_inclusive_scan(T v, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const T n = __shfl_up_sync(0xffffffffu, v, k);
    if (lane >= k) v = op(v, n);
  }
  return v;
}

// Exclusive scan of one value per thread in thread order; *total receives
// the block's reduction (the same in every thread).  For integer T the
// result is exact; for floating T only *total is meant to be used (a
// fixed-order sum).  Every thread of the block must call it.
template <typename T, int NT, typename Op>
__device__ __forceinline__ T block_exclusive_scan(T v, T identity, Op op,
                                                  T* total) {
  static_assert(NT % 32 == 0 && NT <= 1024, "NT: multiple of 32, <= 1024");
  constexpr int kWarps = NT / 32;
  __shared__ T warp_incl[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T incl = warp_inclusive_scan(v, op);
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T s = lane < kWarps ? warp_incl[lane] : identity;
    s = warp_inclusive_scan(s, op);
    if (lane < kWarps) warp_incl[lane] = s;
  }
  __syncthreads();
  const T before = warp == 0 ? identity : warp_incl[warp - 1];
  *total = warp_incl[kWarps - 1];
  __syncthreads();  // warp_incl is reused by the next call
  T in_warp = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) in_warp = identity;
  return op(before, in_warp);
}

// The sum form, used by the fixed-point cumsums.
template <typename T, int NT>
__device__ __forceinline__ T block_exclusive_scan(T v, T* total) {
  return block_exclusive_scan<T, NT>(v, T(0), Sum(), total);
}

}  // namespace pt
