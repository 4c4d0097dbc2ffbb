// Fixed-point cumulative weights on Hopper (sm_90a): the systematic z-form
// (B1) and the monotone normalised cumsum (B3).
//
// B1 replaces particles_tpu/ops/z_kernel.py::_z_kernel (launched by
// _z_pallas, public function systematic_z_fused); B3 replaces _cs_kernel
// (launched by _cs_pallas, public function normalised_cumsum_exact).  Both
// compute, for weights W >= 0,
//
//   S     = sum(W)                              (float, rounded to f32)
//   scale = 2^30 / max(S, 1e-37)                (f32)
//   q_i   = round_half_even(W_i * scale)        (int64)
//   Q     = sum(q)                              (exact int64)
//   csq   = inclusive cumsum(q)                 (exact int64)
//
// and differ only in the epilogue:
//
//   B1: minv = M / max(Q, 1) (f32),
//       z_i  = clip(floor(f32(csq_i) * minv - u) + 1, 0, M),  z[N-1] = M
//   B3: inv  = 1 / max(Q, 1) (f32),  cs_i = f32(csq_i) * inv
//
// Each stage after the integer cumsum (int -> f32 convert, multiply by a
// positive constant, subtract a constant, floor) is monotone, so z and cs
// are nondecreasing by construction.  The stages are written with explicit
// round-to-nearest intrinsics: nvcc would otherwise contract the
// multiply-subtract into one FMA, which rounds once instead of twice and
// would no longer be the JAX package's arithmetic.
//
// What bounds them: bytes.  Each reads W three times (the S pass, the
// block-sum pass, the epilogue pass) and writes one 4-byte output: 16 bytes
// a particle, 16 MB at N = 2^20, where W (4 MB) stays in the 50 MB L2
// between passes, so the least traffic is 8 bytes a particle.  The TPU
// kernels carried the running prefix through the sequential grid in SMEM;
// CUDA blocks run in no order, so the prefix comes from a separate scan of
// the per-block totals instead.  Five launches, no atomics, deterministic.

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
// scal[1] = numer / max(Q, 1) in f32 (numer = M for B1, 1 for B3).
__global__ void k_scan(int64_t* __restrict__ bq, int64_t nb, int64_t numer,
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
    scal[1] = __fdiv_rn(__ll2float_rn(numer), fmaxf(__ll2float_rn(carry), 1.0f));
  }
}

// Pass 2, shared by both epilogues: re-quantise, scan inside the block from
// the block's prefix, and leave each owned element's inclusive prefix csq
// (exact int64) in csq[].
__device__ __forceinline__ void block_prefix(const float* __restrict__ W,
                                             int64_t N, float scale,
                                             const int64_t* __restrict__ bq,
                                             int64_t base,
                                             int64_t csq[kItems]) {
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    csq[k] = i < N ? quantise(W[i], scale) : 0;
    s += csq[k];
  }
  int64_t tot;
  int64_t run = bq[blockIdx.x] + pt::block_exclusive_scan<int64_t, kThreads>(s, &tot);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run += csq[k];
    csq[k] = run;
  }
}

// B1 epilogue: the monotone transform to z.
__global__ void k_z(const float* __restrict__ W, int64_t N, int64_t M,
                    const float* __restrict__ u_ptr,
                    const float* __restrict__ scal,
                    const int64_t* __restrict__ bq, int32_t* __restrict__ z) {
  const float minv = scal[1];
  const float u = *u_ptr;
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  int64_t csq[kItems];
  block_prefix(W, N, scal[0], bq, base, csq);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < N) {
      const float f = __fsub_rn(__fmul_rn(__ll2float_rn(csq[k]), minv), u);
      int64_t zi = __float2ll_rd(f) + 1;  // floor, then + 1
      zi = zi < 0 ? 0 : (zi > M ? M : zi);
      if (i == N - 1) zi = M;
      z[i] = (int32_t)zi;
    }
  }
}

// B3 epilogue: cs_i = f32(csq_i) * (1 / max(Q, 1)).
__global__ void k_cs(const float* __restrict__ W, int64_t N,
                     const float* __restrict__ scal,
                     const int64_t* __restrict__ bq, float* __restrict__ cs) {
  const float inv = scal[1];
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  int64_t csq[kItems];
  block_prefix(W, N, scal[0], bq, base, csq);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < N) cs[i] = __fmul_rn(__ll2float_rn(csq[k]), inv);
  }
}

// Passes 0 to 1b, shared: S, scale, block sums of q and their scan, and
// scal[1] = numer / max(Q, 1).
void prefix_passes(const float* w, int64_t N, int64_t numer,
                          void* part, void* bq, void* scal, cudaStream_t s) {
  const int64_t nb = (N + kTile - 1) / kTile;
  k_wsum<<<(unsigned)nb, kThreads, 0, s>>>(w, N, (double*)part);
  k_scale<<<1, kScanThreads, 0, s>>>((const double*)part, nb, (float*)scal);
  k_qsum<<<(unsigned)nb, kThreads, 0, s>>>(w, N, (const float*)scal,
                                           (int64_t*)bq);
  k_scan<<<1, kScanThreads, 0, s>>>((int64_t*)bq, nb, numer, (float*)scal);
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
  prefix_passes(w, N, M, part, bq, scal, s);
  k_z<<<(unsigned)nb, kThreads, 0, s>>>(w, N, M, (const float*)u,
                                        (const float*)scal,
                                        (const int64_t*)bq, (int32_t*)z);
  return (int)cudaGetLastError();
}

// W: (N,) f32, cs: (N,) f32 out; scratch as above.  Returns
// cudaGetLastError().
int pt_normalised_cumsum(const void* W, long long N, void* cs, void* part,
                         void* bq, void* scal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nb = (N + kTile - 1) / kTile;
  const float* w = (const float*)W;
  prefix_passes(w, N, 1, part, bq, scal, s);
  k_cs<<<(unsigned)nb, kThreads, 0, s>>>(w, N, (const float*)scal,
                                         (const int64_t*)bq, (float*)cs);
  return (int)cudaGetLastError();
}

}  // extern "C"
