// Systematic-resampling z-form on Hopper (sm_90a).
//
// Replaces particles_tpu/ops/z_kernel.py::_z_kernel (launched by _z_pallas,
// public function systematic_z_fused).  It computes, for weights W >= 0,
//
//   S     = sum(W)                              (float, rounded to f32)
//   scale = 2^30 / max(S, 1e-37)                (f32)
//   q_i   = round_half_even(W_i * scale)        (int64)
//   Q     = sum(q),  minv = M / max(Q, 1)       (f32)
//   csq   = inclusive cumsum(q)                 (exact int64)
//   z_i   = clip(floor(f32(csq_i) * minv - u) + 1, 0, M),  z[N-1] = M
//
// Each stage after the integer cumsum (int -> f32 convert, multiply by a
// positive constant, subtract a constant, floor) is monotone, so z is
// nondecreasing by construction.  The stages are written with explicit
// round-to-nearest intrinsics: nvcc would otherwise contract the
// multiply-subtract into one FMA, which rounds once instead of twice and
// would no longer be the JAX package's arithmetic.
//
// What bounds it: bytes.  It reads W three times (the S pass, the block-sum
// pass, the z pass) and writes z: 16 bytes a particle, 16 MB at N = 2^20,
// where W (4 MB) stays in the 50 MB L2 between passes.  The TPU kernel
// carried the running prefix through the sequential grid in SMEM; CUDA
// blocks run in no order, so the prefix comes from a separate scan of the
// per-block totals instead.  Five launches, no atomics, deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;               // threads per streaming block
constexpr int kItems = 4;                   // consecutive elements a thread
constexpr int kTile = kThreads * kItems;    // elements per streaming block
constexpr int kScanThreads = 1024;          // the single-block passes

__device__ __forceinline__ int64_t quantise(float w, float scale) {
  return __float2ll_rn(__fmul_rn(w, scale));  // round half to even
}

// Pass 0: per-block sums of W, accumulated in double.
__global__ void k_wsum(const float* __restrict__ W, int64_t N,
                       double* __restrict__ part) {
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < N) s += (double)W[i];
  }
  double tot;
  pt::block_exclusive_scan<double, kThreads>(s, &tot);
  if (threadIdx.x == 0) part[blockIdx.x] = tot;
}

// S from the block sums, then scale = 2^30 / max(S, 1e-37) in f32.
__global__ void k_scale(const double* __restrict__ part, int64_t nb,
                        float* __restrict__ scal) {
  double s = 0.0;
  for (int64_t i = threadIdx.x; i < nb; i += kScanThreads) s += part[i];
  double tot;
  pt::block_exclusive_scan<double, kScanThreads>(s, &tot);
  if (threadIdx.x == 0) {
    const float S = __double2float_rn(tot);
    scal[0] = __fdiv_rn(1073741824.0f, fmaxf(S, 1e-37f));
  }
}

// Pass 1: per-block sums of the quantised weights.
__global__ void k_qsum(const float* __restrict__ W, int64_t N,
                       const float* __restrict__ scal,
                       int64_t* __restrict__ bq) {
  const float scale = scal[0];
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < N) s += quantise(W[i], scale);
  }
  int64_t tot;
  pt::block_exclusive_scan<int64_t, kThreads>(s, &tot);
  if (threadIdx.x == 0) bq[blockIdx.x] = tot;
}

// One block: exclusive scan of the block sums in place, then
// minv = M / max(Q, 1) in f32.
__global__ void k_scan(int64_t* __restrict__ bq, int64_t nb, int64_t M,
                       float* __restrict__ scal) {
  int64_t carry = 0;
  for (int64_t c = 0; c < nb; c += kScanThreads) {
    const int64_t i = c + threadIdx.x;
    const int64_t v = i < nb ? bq[i] : 0;
    int64_t tot;
    const int64_t ex = pt::block_exclusive_scan<int64_t, kScanThreads>(v, &tot);
    if (i < nb) bq[i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) {
    scal[1] = __fdiv_rn(__ll2float_rn(M), fmaxf(__ll2float_rn(carry), 1.0f));
  }
}

// Pass 2: re-quantise, scan inside the block from the block's prefix, and
// apply the monotone transform.
__global__ void k_z(const float* __restrict__ W, int64_t N, int64_t M,
                    const float* __restrict__ u_ptr,
                    const float* __restrict__ scal,
                    const int64_t* __restrict__ bq, int32_t* __restrict__ z) {
  const float scale = scal[0];
  const float minv = scal[1];
  const float u = *u_ptr;
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  int64_t q[kItems];
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    q[k] = i < N ? quantise(W[i], scale) : 0;
    s += q[k];
  }
  int64_t tot;
  int64_t run = bq[blockIdx.x] + pt::block_exclusive_scan<int64_t, kThreads>(s, &tot);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    run += q[k];
    if (i < N) {
      const float f = __fsub_rn(__fmul_rn(__ll2float_rn(run), minv), u);
      int64_t zi = __float2ll_rd(f) + 1;  // floor, then + 1
      zi = zi < 0 ? 0 : (zi > M ? M : zi);
      if (i == N - 1) zi = M;
      z[i] = (int32_t)zi;
    }
  }
}

}  // namespace

extern "C" {

// Elements per streaming block: the caller sizes the scratch buffers as
// nb = ceil(N / pt_z_tile()).
int pt_z_tile(void) { return kTile; }

// W: (N,) f32, u: one f32, z: (N,) int32 out.  Scratch: part (nb,) f64,
// bq (nb,) int64, scal (2,) f32.  Returns cudaGetLastError().
int pt_systematic_z(const void* W, long long N, long long M, const void* u,
                    void* z, void* part, void* bq, void* scal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nb = (N + kTile - 1) / kTile;
  const float* w = (const float*)W;
  k_wsum<<<(unsigned)nb, kThreads, 0, s>>>(w, N, (double*)part);
  k_scale<<<1, kScanThreads, 0, s>>>((const double*)part, nb, (float*)scal);
  k_qsum<<<(unsigned)nb, kThreads, 0, s>>>(w, N, (const float*)scal,
                                           (int64_t*)bq);
  k_scan<<<1, kScanThreads, 0, s>>>((int64_t*)bq, nb, M, (float*)scal);
  k_z<<<(unsigned)nb, kThreads, 0, s>>>(w, N, M, (const float*)u,
                                        (const float*)scal,
                                        (const int64_t*)bq, (int32_t*)z);
  return (int)cudaGetLastError();
}

}  // extern "C"
