// Inclusive running maximum of int32 on Hopper (sm_90a): B6.
//
// Replaces particles_tpu/ops/cummax_kernel.py::_cummax_kernel (launched by
// _running_max_pallas, public function running_max), which enforces the
// nondecreasing z contract where a z-form is built from a float cumsum:
//
//   y_i = max(z_0, ..., z_i)
//
// What bounds it: bytes.  The least traffic is one read of z and one write
// of y (8 bytes a particle, 8 MB at N = 2^20: 2.5 us).  The TPU kernel
// carried the running max through its sequential grid in SMEM; CUDA blocks
// run in no order, and the function has one global dependency: each
// block's prefix, the maximum of the chunks before it.
//
// One persistent cooperative launch on the skeleton of coop_chunks.cuh
// (B1's and B3's): each block owns one contiguous chunk of z, and
//
//   1. reads its chunk once, keeps it in shared memory, and writes its
//      maximum;                                            grid barrier
//   2. takes the maximum of the partials of the blocks before it, scans
//      its chunk tile by tile from shared memory, seeded with that prefix,
//      and writes y once, 16 bytes at a time.
//
// Above the cache (about 6.5M elements on an H100) pass 2 reads the chunk
// again.  INT_MIN is the identity, so negative values and a ragged last
// chunk need no special case.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "coop_chunks.cuh"

namespace {

constexpr int kThreads = pt::kCoopThreads;
constexpr int kItems = pt::kCoopItems;
constexpr int kTile = pt::kCoopTile;

namespace cg = cooperative_groups;

// Block b owns z[b * chunk, b * chunk + len); `cached` and the dynamic
// shared memory as in coop_chunks.cuh; part (G int32) the blocks' maxima.
__global__ void __launch_bounds__(kThreads, 2)
k_running_max(const int32_t* __restrict__ z, int64_t N, int64_t chunk,
              int cached, int32_t* part, int32_t* __restrict__ y) {
  extern __shared__ int4 smem4[];
  int32_t* cache = reinterpret_cast<int32_t*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int b = (int)blockIdx.x;
  const int t = (int)threadIdx.x;
  const pt::CoopChunk ch = pt::coop_chunk(N, chunk);
  const int64_t len = ch.len;
  const int32_t* src = z + ch.start;

  // 1. the chunk's maximum; the chunk goes to shared memory
  int32_t m = pt::coop_load_chunk(
      src, len, cached, cache, (int32_t)INT_MIN, (int32_t)INT_MIN,
      [](int32_t a, int32_t x) { return a > x ? a : x; });
  int32_t tot;
  pt::block_exclusive_scan<int32_t, kThreads>(m, INT_MIN, pt::Max(), &tot);
  if (t == 0) part[b] = tot;
  grid.sync();

  // 2. the prefix of the blocks before this one, then the scan of the chunk
  int32_t before = INT_MIN;
  for (int i = t; i < b; i += kThreads) before = max(before, __ldcg(part + i));
  int32_t carry;
  pt::block_exclusive_scan<int32_t, kThreads>(before, INT_MIN, pt::Max(),
                                              &carry);
  for (int64_t base = 0; base < len; base += kTile) {
    int32_t v[kItems];
    pt::coop_tile(src, base, len, cached, cache, v);
    const int64_t off = base + (int64_t)t * kItems;  // within the chunk
    m = INT_MIN;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (off + k >= len) v[k] = INT_MIN;
      m = max(m, v[k]);
    }
    int32_t tile_tot;
    int32_t run = max(carry, pt::block_exclusive_scan<int32_t, kThreads>(
                                 m, INT_MIN, pt::Max(), &tile_tot));
    carry = max(carry, tile_tot);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      run = max(run, v[k]);
      v[k] = run;
    }
    if (off < len) pt::store8(y + ch.start + off, v, len - off);
  }
}

// The kernel's grid size, queried once per device.
int g_max_grid[pt::kMaxDevices];

const void* const kKernel = (const void*)k_running_max;

}  // namespace

extern "C" {

// z: (N,) int32, y: (N,) int32 out, all on the device; part: scratch of
// part_words int32 words (one a block) that no other launch uses
// meanwhile.  One cooperative launch on the current device; returns its
// CUDA error code, never falling back.
int pt_running_max(const void* z, long long N, void* y, void* part,
                   long long part_words, void* stream) {
  int gmax;
  const cudaError_t e = pt::coop_grid_cap(kKernel, g_max_grid, part_words,
                                          &gmax);
  if (e != cudaSuccess) return (int)e;
  pt::CoopShape shape = pt::coop_shape(N, gmax);
  const int32_t* src = (const int32_t*)z;
  int64_t n = N;
  int32_t* p = (int32_t*)part;
  int32_t* out = (int32_t*)y;
  void* args[] = {&src, &n, &shape.chunk, &shape.cached, &p, &out};
  return pt::coop_launch(kKernel, shape, args, stream);
}

// Elements a tile, tiles a block keeps in shared memory, and (into *grid)
// the most blocks of one launch on the current device with part_words of
// scratch.  Returns a CUDA error code.
int pt_cummax_geometry(long long part_words, int* tile, int* cache_tiles,
                       int* grid) {
  return pt::coop_geometry(kKernel, g_max_grid, part_words, tile,
                           cache_tiles, grid);
}

}  // extern "C"
