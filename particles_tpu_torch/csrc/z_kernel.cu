// Fixed-point cumulative weights on Hopper (sm_90a): the systematic z-form
// (B1) and the monotone normalised cumsum (B3).
//
// B1 replaces particles_tpu/ops/z_kernel.py::_z_kernel (launched by
// _z_pallas, public function systematic_z_fused); B3 replaces _cs_kernel
// (launched by _cs_pallas, public function normalised_cumsum_exact).  Both
// compute, for weights W >= 0,
//
//   S     = sum(W)                              (double, rounded to f32)
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
// would no longer be the JAX package's arithmetic.  (scale overflows to
// inf for S below 2^30 / FLT_MAX, about 3.2e-30, here as in the JAX
// package: the 1e-37 clamp only keeps S = 0 from dividing by zero.)
//
// What bounds them: bytes, 8 a particle (W read once, the output written
// once): 2.5 us at N = 2^20.  The TPU kernels carried the running prefix
// through the sequential grid in SMEM; CUDA blocks run in no order, and the
// function has two global dependencies (S before any q, Q before any
// output).
//
// B1 meets them with five launches (S, scale, block sums of q, their scan,
// the z pass), reading W three times: 16 bytes a particle.
//
// B3 meets them in one persistent cooperative launch (k_cs_coop).  The grid
// is no larger than the blocks that fit on the card at once
// (pt_cs_max_grid, queried once per device), and each block owns one
// contiguous chunk of W, whole tiles of kCsTile elements:
//
//   1. it reads its chunk once, keeps it in shared memory, and writes its
//      partial sum of W (double);                          grid barrier
//   2. every block adds the G partials in the same fixed order, so S and
//      scale are the same bits everywhere, and writes the sum of its q;
//                                                           grid barrier
//   3. every block forms its own exclusive prefix and Q from the G int64
//      partials, scans its chunk tile by tile from shared memory and
//      writes cs once, 16 bytes a thread.
//
// At N = 2^20 every chunk fits in shared memory, so W is read once.  Above
// pt_cs_max_grid() * kCsCacheTiles * kCsTile elements (about 6.5M on an
// H100) a chunk does not fit, and the block reads it again from global
// memory in passes 2 and 3: the same result, more bytes.  No atomics; the
// result does not depend on the order in which blocks run.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;               // threads per streaming block
constexpr int kItems = 4;                   // consecutive elements a thread
constexpr int kTile = kThreads * kItems;    // elements per streaming block
constexpr int kScanThreads = 1024;          // the single-block passes

// B3's persistent blocks: kCsItems consecutive elements a thread in the
// scan of pass 3, and a shared-memory cache of kCsCacheTiles tiles a block
// (96 KB: two blocks fit on an SM).
constexpr int kCsThreads = 512;
constexpr int kCsItems = 8;
constexpr int kCsTile = kCsThreads * kCsItems;
constexpr int kCsCacheTiles = 6;
constexpr int kCsCacheBytes = kCsCacheTiles * kCsTile * (int)sizeof(float);
constexpr int kMaxDevices = 64;

namespace cg = cooperative_groups;

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

// B1's passes 0 to 1b: S, scale, block sums of q and their scan, and
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

// B3 in one cooperative launch.  Block b owns W[b * chunk, b * chunk + len)
// (chunk a multiple of kCsTile, len >= 1); `cached`: the chunk lives in the
// dynamic shared memory between passes, else that memory holds one tile.
// part_s (G doubles) and part_q (G int64) are the blocks' partials.
__global__ void __launch_bounds__(kCsThreads, 2)
k_cs_coop(const float* __restrict__ W, int64_t N, int64_t chunk, int cached,
          double* part_s, int64_t* part_q, float* __restrict__ cs) {
  extern __shared__ float4 smem4[];
  float* cache = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int G = (int)gridDim.x;
  const int b = (int)blockIdx.x;
  const int t = (int)threadIdx.x;
  const int64_t start = (int64_t)b * chunk;
  const int64_t len = N - start < chunk ? N - start : chunk;
  const float* w = W + start;

  // 1. partial sum of W in double; the chunk goes to shared memory
  double s = 0.0;
  for (int64_t base = 0; base < len; base += kCsTile) {
    float v[kCsItems];
#pragma unroll
    for (int k = 0; k < kCsItems; ++k) {
      const int64_t i = base + k * kCsThreads + t;
      v[k] = i < len ? __ldg(w + i) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kCsItems; ++k) {
      const int64_t i = base + k * kCsThreads + t;
      if (cached && i < len) cache[i] = v[k];
      s += (double)v[k];
    }
  }
  double dtot;
  pt::block_exclusive_scan<double, kCsThreads>(s, &dtot);
  if (t == 0) part_s[b] = dtot;
  grid.sync();

  // 2. S from the partials in a fixed order (the same bits in every
  //    block), scale, and the block's sum of q
  s = 0.0;
  for (int i = t; i < G; i += kCsThreads) s += __ldcg(part_s + i);
  pt::block_exclusive_scan<double, kCsThreads>(s, &dtot);
  const float scale =
      __fdiv_rn(1073741824.0f, fmaxf(__double2float_rn(dtot), 1e-37f));
  int64_t sq = 0;
  for (int64_t base = 0; base < len; base += kCsTile) {
#pragma unroll
    for (int k = 0; k < kCsItems; ++k) {
      const int64_t i = base + k * kCsThreads + t;
      if (i < len) sq += quantise(cached ? cache[i] : __ldg(w + i), scale);
    }
  }
  int64_t qtot;
  pt::block_exclusive_scan<int64_t, kCsThreads>(sq, &qtot);
  if (t == 0) part_q[b] = qtot;
  grid.sync();

  // 3. the block's exclusive prefix and Q, then the scan of the chunk
  int64_t before = 0, all = 0;
  for (int i = t; i < G; i += kCsThreads) {
    const int64_t v =
        (int64_t)__ldcg(reinterpret_cast<const long long*>(part_q) + i);
    all += v;
    if (i < b) before += v;
  }
  int64_t carry, Q;
  pt::block_exclusive_scan<int64_t, kCsThreads>(before, &carry);
  pt::block_exclusive_scan<int64_t, kCsThreads>(all, &Q);
  const float inv = __fdiv_rn(1.0f, fmaxf(__ll2float_rn(Q), 1.0f));
  const bool vec = (reinterpret_cast<uintptr_t>(cs) & 15) == 0;
  for (int64_t base = 0; base < len; base += kCsTile) {
    const float* src = cache + base;
    if (!cached) {   // stage the tile, coalesced (the previous tile's reads
                     // all came before the previous scan's barriers)
#pragma unroll
      for (int k = 0; k < kCsItems; ++k) {
        const int64_t i = base + k * kCsThreads + t;
        if (i < len) cache[k * kCsThreads + t] = __ldg(w + i);
      }
      __syncthreads();
      src = cache;
    }
    const int64_t off = base + (int64_t)t * kCsItems;  // within the chunk
    const float4* s4 = reinterpret_cast<const float4*>(src + t * kCsItems);
    const float4 lo = s4[0], hi = s4[1];
    const float v[kCsItems] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    int64_t csq[kCsItems];
    int64_t mine = 0;
#pragma unroll
    for (int k = 0; k < kCsItems; ++k) {
      csq[k] = off + k < len ? quantise(v[k], scale) : 0;
      mine += csq[k];
    }
    int64_t tile_tot;
    int64_t run =
        carry + pt::block_exclusive_scan<int64_t, kCsThreads>(mine, &tile_tot);
    carry += tile_tot;
    float out[kCsItems];
#pragma unroll
    for (int k = 0; k < kCsItems; ++k) {
      run += csq[k];
      out[k] = __fmul_rn(__ll2float_rn(run), inv);
    }
    float* dst = cs + start + off;
    if (vec && off + kCsItems <= len) {
      reinterpret_cast<float4*>(dst)[0] =
          make_float4(out[0], out[1], out[2], out[3]);
      reinterpret_cast<float4*>(dst)[1] =
          make_float4(out[4], out[5], out[6], out[7]);
    } else {
#pragma unroll
      for (int k = 0; k < kCsItems; ++k) {
        if (off + k < len) dst[k] = out[k];
      }
    }
  }
}

// Blocks of k_cs_coop that fit on the current device at once, queried once
// per device (the first call also raises the kernel's shared-memory limit).
int g_cs_max_grid[kMaxDevices];

cudaError_t cs_max_grid(int* out) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_cs_max_grid[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute((const void*)k_cs_coop,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kCsCacheBytes);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_cs_coop,
                                                      kCsThreads,
                                                      kCsCacheBytes);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    g_cs_max_grid[dev] = per_sm * sms;
  }
  *out = g_cs_max_grid[dev];
  return cudaSuccess;
}

// The most blocks of one launch: those that fit on the current device at
// once, and no more than the scratch of part_words 8-byte words holds (two
// partials a block).
cudaError_t cs_grid_cap(long long part_words, int* out) {
  int g;
  const cudaError_t e = cs_max_grid(&g);
  if (e != cudaSuccess) return e;
  *out = part_words / 2 < g ? (int)(part_words / 2) : g;
  return *out >= 1 ? cudaSuccess : cudaErrorInvalidValue;
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

// B3's geometry with part_words of scratch: elements a tile, tiles a block
// keeps in shared memory, and (into *grid) the most blocks of one launch on
// the current device.  Returns a CUDA error code.
int pt_cs_geometry(long long part_words, int* tile, int* cache_tiles,
                   int* grid) {
  *tile = kCsTile;
  *cache_tiles = kCsCacheTiles;
  return (int)cs_grid_cap(part_words, grid);
}

// W: (N,) f32, cs: (N,) f32 out, part: scratch of part_words 8-byte words
// (8-byte aligned) that no other launch uses meanwhile.  One cooperative
// launch on the current device; returns its CUDA error code (for example
// cudaErrorCooperativeLaunchTooLarge), never falling back.
int pt_normalised_cumsum(const void* W, long long N, void* cs, void* part,
                         long long part_words, void* stream) {
  int gmax;
  cudaError_t e = cs_grid_cap(part_words, &gmax);
  if (e != cudaSuccess) return (int)e;
  const int64_t per = (N + gmax - 1) / gmax;
  int64_t chunk = (per + kCsTile - 1) / kCsTile * kCsTile;
  const int grid = (int)((N + chunk - 1) / chunk);
  int cached = chunk <= (int64_t)kCsCacheTiles * kCsTile;
  const size_t smem = (size_t)(cached ? chunk : kCsTile) * sizeof(float);
  const float* w = (const float*)W;
  int64_t n = N;
  double* part_s = (double*)part;
  int64_t* part_q = (int64_t*)part + gmax;
  float* out = (float*)cs;
  void* args[] = {&w, &n, &chunk, &cached, &part_s, &part_q, &out};
  e = cudaLaunchCooperativeKernel((const void*)k_cs_coop, dim3(grid),
                                  dim3(kCsThreads), args, smem,
                                  (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // extern "C"
