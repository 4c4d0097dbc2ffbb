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
// Both meet them in one persistent cooperative launch of one kernel,
// k_fixed_point<Out>, instantiated once for each epilogue (ZOut, CsOut),
// on the skeleton of coop_chunks.cuh: each block owns one contiguous chunk
// of W, whole tiles of kCoopTile elements, and
//
//   1. reads its chunk once, keeps it in shared memory, and writes its
//      partial sum of W (double);                          grid barrier
//   2. adds the G partials in the same fixed order as every other block,
//      so S and scale are the same bits everywhere, and writes the sum of
//      its q;                                              grid barrier
//   3. forms its own exclusive prefix and Q from the G int64 partials,
//      scans its chunk tile by tile from shared memory and hands each
//      thread's 8 inclusive csq to the epilogue, which writes the output
//      once, 16 bytes at a time.
//
// No atomics; the result does not depend on the order in which blocks run.
// u is read by the kernel from its device pointer, so a call never waits
// on the host.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "coop_chunks.cuh"

namespace {

constexpr int kThreads = pt::kCoopThreads;
constexpr int kItems = pt::kCoopItems;
constexpr int kTile = pt::kCoopTile;

namespace cg = cooperative_groups;

__device__ __forceinline__ int64_t quantise(float w, float scale) {
  return __float2ll_rn(__fmul_rn(w, scale));  // round half to even
}

// B3's epilogue: cs_i = f32(csq_i) * (1 / max(Q, 1)).
struct CsOut {
  float* cs;
  float inv;

  __device__ __forceinline__ void begin(int64_t Q) {
    inv = __fdiv_rn(1.0f, fmaxf(__ll2float_rn(Q), 1.0f));
  }
  // csq[k] is the inclusive prefix of element i + k; n of them are in range
  __device__ __forceinline__ void store(int64_t i, const int64_t (&csq)[8],
                                        int64_t n, int64_t N) const {
    float out[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      out[k] = __fmul_rn(__ll2float_rn(csq[k]), inv);
    }
    pt::store8(cs + i, out, n);
  }
};

// B1's epilogue: z_i = clip(floor(f32(csq_i) * (M / max(Q, 1)) - u) + 1,
// 0, M), and z[N-1] = M.
struct ZOut {
  int32_t* z;
  const float* u_ptr;
  int64_t M;
  float minv, u;

  __device__ __forceinline__ void begin(int64_t Q) {
    minv = __fdiv_rn(__ll2float_rn(M), fmaxf(__ll2float_rn(Q), 1.0f));
    u = __ldg(u_ptr);
  }
  __device__ __forceinline__ void store(int64_t i, const int64_t (&csq)[8],
                                        int64_t n, int64_t N) const {
    int32_t out[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const float f = __fsub_rn(__fmul_rn(__ll2float_rn(csq[k]), minv), u);
      int64_t zi = __float2ll_rd(f) + 1;  // floor, then + 1
      zi = zi < 0 ? 0 : (zi > M ? M : zi);
      if (i + k == N - 1) zi = M;
      out[k] = (int32_t)zi;
    }
    pt::store8(z + i, out, n);
  }
};

// One cooperative launch.  Block b owns W[b * chunk, b * chunk + len)
// (chunk a multiple of kTile, len >= 1); `cached`: the chunk lives in the
// dynamic shared memory between passes, else that memory holds one tile.
// part_s (G doubles) and part_q (G int64) are the blocks' partials.
template <class Out>
__global__ void __launch_bounds__(kThreads, 2)
k_fixed_point(const float* __restrict__ W, int64_t N, int64_t chunk,
              int cached, double* part_s, int64_t* part_q, Out out) {
  extern __shared__ float4 smem4[];
  float* cache = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int G = (int)gridDim.x;
  const int b = (int)blockIdx.x;
  const int t = (int)threadIdx.x;
  const pt::CoopChunk ch = pt::coop_chunk(N, chunk);
  const int64_t len = ch.len;
  const float* w = W + ch.start;

  // 1. partial sum of W in double; the chunk goes to shared memory
  double s = pt::coop_load_chunk(
      w, len, cached, cache, 0.0f, 0.0,
      [](double a, float x) { return a + (double)x; });
  double dtot;
  pt::block_exclusive_scan<double, kThreads>(s, &dtot);
  if (t == 0) part_s[b] = dtot;
  grid.sync();

  // 2. S from the partials in a fixed order (the same bits in every
  //    block), scale, and the block's sum of q
  s = 0.0;
  for (int i = t; i < G; i += kThreads) s += __ldcg(part_s + i);
  pt::block_exclusive_scan<double, kThreads>(s, &dtot);
  const float scale =
      __fdiv_rn(1073741824.0f, fmaxf(__double2float_rn(dtot), 1e-37f));
  int64_t sq = 0;
  for (int64_t base = 0; base < len; base += kTile) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + k * kThreads + t;
      if (i < len) sq += quantise(cached ? cache[i] : __ldg(w + i), scale);
    }
  }
  int64_t qtot;
  pt::block_exclusive_scan<int64_t, kThreads>(sq, &qtot);
  if (t == 0) part_q[b] = qtot;
  grid.sync();

  // 3. the block's exclusive prefix and Q, then the scan of the chunk
  int64_t before = 0, all = 0;
  for (int i = t; i < G; i += kThreads) {
    const int64_t v =
        (int64_t)__ldcg(reinterpret_cast<const long long*>(part_q) + i);
    all += v;
    if (i < b) before += v;
  }
  int64_t carry, Q;
  pt::block_exclusive_scan<int64_t, kThreads>(before, &carry);
  pt::block_exclusive_scan<int64_t, kThreads>(all, &Q);
  Out o = out;
  o.begin(Q);
  for (int64_t base = 0; base < len; base += kTile) {
    float v[kItems];
    pt::coop_tile(w, base, len, cached, cache, v);
    const int64_t off = base + (int64_t)t * kItems;  // within the chunk
    int64_t csq[kItems];
    int64_t mine = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      csq[k] = off + k < len ? quantise(v[k], scale) : 0;
      mine += csq[k];
    }
    int64_t tile_tot;
    int64_t run =
        carry + pt::block_exclusive_scan<int64_t, kThreads>(mine, &tile_tot);
    carry += tile_tot;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      run += csq[k];
      csq[k] = run;
    }
    if (off < len) o.store(ch.start + off, csq, len - off, N);
  }
}

// Each instantiation's grid size, queried once per device.
int g_z_max_grid[pt::kMaxDevices];
int g_cs_max_grid[pt::kMaxDevices];

const void* const kZKernel = (const void*)k_fixed_point<ZOut>;
const void* const kCsKernel = (const void*)k_fixed_point<CsOut>;

// Launches kernel with epilogue `out` over W; part holds part_words 8-byte
// words of scratch, two a block.
template <class Out>
int launch_fixed_point(const void* kernel, int (&cache)[pt::kMaxDevices],
                       const float* W, long long N, Out out, void* part,
                       long long part_words, void* stream) {
  int gmax;
  const cudaError_t e = pt::coop_grid_cap(kernel, cache, part_words / 2,
                                          &gmax);
  if (e != cudaSuccess) return (int)e;
  pt::CoopShape shape = pt::coop_shape(N, gmax);
  int64_t n = N;
  double* part_s = (double*)part;
  int64_t* part_q = (int64_t*)part + gmax;
  void* args[] = {&W, &n, &shape.chunk, &shape.cached, &part_s, &part_q,
                  &out};
  return pt::coop_launch(kernel, shape, args, stream);
}

}  // namespace

extern "C" {

// B1.  W: (N,) f32, u: one f32, z: (N,) int32 out, all on the device;
// part: scratch of part_words 8-byte words (8-byte aligned) that no other
// launch uses meanwhile.  One cooperative launch on the current device;
// returns its CUDA error code, never falling back.
int pt_systematic_z(const void* W, long long N, long long M, const void* u,
                    void* z, void* part, long long part_words,
                    void* stream) {
  ZOut out = {(int32_t*)z, (const float*)u, (int64_t)M, 0.0f, 0.0f};
  return launch_fixed_point(kZKernel, g_z_max_grid, (const float*)W, N, out,
                            part, part_words, stream);
}

// B3.  W: (N,) f32, cs: (N,) f32 out; part as for pt_systematic_z.
int pt_normalised_cumsum(const void* W, long long N, void* cs, void* part,
                         long long part_words, void* stream) {
  CsOut out = {(float*)cs, 0.0f};
  return launch_fixed_point(kCsKernel, g_cs_max_grid, (const float*)W, N,
                            out, part, part_words, stream);
}

// The launch geometry of B1 (pt_z_geometry) and of B3 (pt_cs_geometry)
// with part_words of scratch: elements a tile, tiles a block keeps in
// shared memory, and (into *grid) the most blocks of one launch on the
// current device.  Returns a CUDA error code.
int pt_z_geometry(long long part_words, int* tile, int* cache_tiles,
                  int* grid) {
  return pt::coop_geometry(kZKernel, g_z_max_grid, part_words / 2, tile,
                           cache_tiles, grid);
}

int pt_cs_geometry(long long part_words, int* tile, int* cache_tiles,
                   int* grid) {
  return pt::coop_geometry(kCsKernel, g_cs_max_grid, part_words / 2, tile,
                           cache_tiles, grid);
}

}  // extern "C"
