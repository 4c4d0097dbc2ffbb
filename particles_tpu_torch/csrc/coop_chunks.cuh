// The skeleton shared by the one-launch scans of this directory (B1 and B3
// in z_kernel.cu, B6 in cummax_kernel.cu): one persistent cooperative
// launch whose blocks each own one contiguous chunk of the input, whole
// tiles of kCoopTile elements, kept in shared memory between the passes.
//
// The grid is no larger than the blocks of the kernel that fit on the card
// at once (coop_max_grid, queried once per device and per kernel), and no
// larger than the blocks whose partials the caller's scratch holds.  At
// N = 2^20 every chunk fits in shared memory, so the input is read once.
// Above max_grid * kCoopCacheTiles * kCoopTile elements (about 6.5M on an
// H100) a chunk does not fit: the launch then keeps one tile in shared
// memory and a block reads its chunk again in its later passes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

// 512 threads a block, 8 consecutive elements a thread in a tile's scan,
// and a cache of 6 tiles of 4-byte elements (96 KB: two blocks an SM)
constexpr int kCoopThreads = 512;
constexpr int kCoopItems = 8;
constexpr int kCoopTile = kCoopThreads * kCoopItems;
constexpr int kCoopCacheTiles = 6;
constexpr int kCoopCacheBytes = kCoopCacheTiles * kCoopTile * 4;
constexpr int kMaxDevices = 64;

// The block's chunk: [start, start + len) of the input, len >= 1.
struct CoopChunk {
  int64_t start, len;
};

__device__ __forceinline__ CoopChunk coop_chunk(int64_t N, int64_t chunk) {
  const int64_t start = (int64_t)blockIdx.x * chunk;
  return {start, N - start < chunk ? N - start : chunk};
}

// Pass 1: read the chunk `src` (len elements) once, coalesced (item k of a
// tile is element base + k * kCoopThreads + t), keep it in `cache` when
// `cached`, and fold every element into the thread's accumulator,
// acc = fold(acc, x), with `pad` in place of those past the chunk's end.
template <typename T, typename A, typename F>
__device__ __forceinline__ A coop_load_chunk(const T* __restrict__ src,
                                             int64_t len, bool cached,
                                             T* cache, T pad, A acc, F fold) {
  const int t = (int)threadIdx.x;
  for (int64_t base = 0; base < len; base += kCoopTile) {
    T v[kCoopItems];
#pragma unroll
    for (int k = 0; k < kCoopItems; ++k) {
      const int64_t i = base + k * kCoopThreads + t;
      v[k] = i < len ? __ldg(src + i) : pad;
    }
#pragma unroll
    for (int k = 0; k < kCoopItems; ++k) {
      const int64_t i = base + k * kCoopThreads + t;
      if (cached && i < len) cache[i] = v[k];
      acc = fold(acc, v[k]);
    }
  }
  return acc;
}

__device__ __forceinline__ void unpack8(const float* s, float (&v)[8]) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
  const float4 lo = s4[0], hi = s4[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void unpack8(const int32_t* s, int32_t (&v)[8]) {
  const int4* s4 = reinterpret_cast<const int4*>(s);
  const int4 lo = s4[0], hi = s4[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// The thread's kCoopItems consecutive elements (base + t * kCoopItems + k)
// of the chunk's tile at `base`, from the cache, or, when the chunk is not
// cached, from the tile staged into the cache with coalesced reads.
// Entries past the chunk's end are undefined: the caller masks them.  The
// caller passes a block-wide barrier (a block scan) between two calls, so
// that no thread stages the next tile while another reads this one.
template <typename T>
__device__ __forceinline__ void coop_tile(const T* __restrict__ src,
                                          int64_t base, int64_t len,
                                          bool cached, T* cache,
                                          T (&v)[kCoopItems]) {
  static_assert(kCoopItems == 8, "unpack8 takes two 16-byte words");
  const int t = (int)threadIdx.x;
  const T* s = cache + base;
  if (!cached) {
#pragma unroll
    for (int k = 0; k < kCoopItems; ++k) {
      const int64_t i = base + k * kCoopThreads + t;
      if (i < len) cache[k * kCoopThreads + t] = __ldg(src + i);
    }
    __syncthreads();
    s = cache;
  }
  unpack8(s + t * kCoopItems, v);
}

// Writes the n (>= 1) first of a thread's 8 outputs to dst: two 16-byte
// stores where dst is aligned and all 8 are in range, else one at a time.
__device__ __forceinline__ void store8(float* dst, const float (&v)[8],
                                       int64_t n) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && n >= 8) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < n) dst[k] = v[k];
    }
  }
}

__device__ __forceinline__ void store8(int32_t* dst, const int32_t (&v)[8],
                                       int64_t n) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && n >= 8) {
    reinterpret_cast<int4*>(dst)[0] = make_int4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<int4*>(dst)[1] = make_int4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < n) dst[k] = v[k];
    }
  }
}

// Blocks of `kernel` (kCoopThreads threads, kCoopCacheBytes of dynamic
// shared memory) that fit on the current device at once.  Queried once per
// device into `cache`, which is the kernel's own: the first query also
// raises the kernel's shared-memory limit, without which its launch is
// refused.
inline cudaError_t coop_max_grid(const void* kernel, int (&cache)[kMaxDevices],
                                 int* out) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kCoopCacheBytes);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kCoopThreads, kCoopCacheBytes);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cache[dev] = per_sm * sms;
  }
  *out = cache[dev];
  return cudaSuccess;
}

// The most blocks of one launch of `kernel`: those that fit on the current
// device at once, and no more than `part_blocks`, the blocks whose partials
// the caller's scratch holds.
inline cudaError_t coop_grid_cap(const void* kernel,
                                 int (&cache)[kMaxDevices],
                                 long long part_blocks, int* out) {
  int g;
  const cudaError_t e = coop_max_grid(kernel, cache, &g);
  if (e != cudaSuccess) return e;
  *out = part_blocks < g ? (int)part_blocks : g;
  return *out >= 1 ? cudaSuccess : cudaErrorInvalidValue;
}

// One launch over N elements with at most gmax blocks: G = ceil(N / chunk)
// blocks of chunk = kCoopTile * ceil(ceil(N / gmax) / kCoopTile) elements,
// kept in shared memory when chunk <= kCoopCacheTiles * kCoopTile.
struct CoopShape {
  int64_t chunk;
  int grid;
  int cached;
  size_t smem;
};

inline CoopShape coop_shape(int64_t N, int gmax) {
  const int64_t per = (N + gmax - 1) / gmax;
  const int64_t chunk = (per + kCoopTile - 1) / kCoopTile * kCoopTile;
  const int cached = chunk <= (int64_t)kCoopCacheTiles * kCoopTile;
  return {chunk, (int)((N + chunk - 1) / chunk), cached,
          (size_t)(cached ? chunk : kCoopTile) * 4};
}

// Launches `kernel` cooperatively with `shape` and returns the launch's
// CUDA error code (for example cudaErrorCooperativeLaunchTooLarge), or the
// last error: a refused launch never runs, and the caller raises.
inline int coop_launch(const void* kernel, const CoopShape& shape,
                       void** args, void* stream) {
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(shape.grid), dim3(kCoopThreads), args, shape.smem,
      (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// The geometry a caller needs to size its cases: elements a tile, tiles a
// block keeps in shared memory, and (into *grid) the most blocks of one
// launch of `kernel` on the current device.
inline int coop_geometry(const void* kernel, int (&cache)[kMaxDevices],
                         long long part_blocks, int* tile, int* cache_tiles,
                         int* grid) {
  *tile = kCoopTile;
  *cache_tiles = kCoopCacheTiles;
  return (int)coop_grid_cap(kernel, cache, part_blocks, grid);
}

}  // namespace pt
