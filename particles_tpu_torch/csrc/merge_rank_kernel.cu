// Sorted-merge rank count on Hopper (sm_90a): B5.
//
// Replaces particles_tpu/ops/merge_rank_kernel.py::_merge_kernel (launched
// by _merge_pallas, public function merge_rank_counts).  For uniforms su
// ((L,) f32, sorted) and cumulative weights cs ((N,) f32, nondecreasing) it
// computes
//
//   z_i = min(UB(su, cs_i), M),   UB(su, c) = #{j < L : su_j <= c}   (int32)
//
// the counts' inclusive cumsum of every inverse-CDF resampling scheme (a
// uniform tied with cs_i counts, as searchsorted side='left' on cs has it).
// Three contracts, for any L, N >= 1 and 0 <= M < 2^31:
//
//   1. z equals searchsorted(su, cs, right=True) clamped to M, exactly, on
//      sorted su;
//   2. z is nondecreasing whenever cs is, on any su, even one that a float
//      cumsum left an ulp out of order (resampling.uniform_spacings);
//   3. every z_i is written exactly once, whatever su holds.
//
// What bounds it: bytes.  The least traffic is one read of su and of cs and
// one write of z: 12 bytes a particle at L = N, 3.8 us at N = 2^20.  The
// first port (one thread per cs_i, a binary search of all of su) made ~20
// dependent loads a thread and was bound by their latency.
//
// Design.  Block b owns a tile of kThreads * kItems consecutive cs, [i0,
// i1), and thread t the kItems consecutive keys [i0 + t kItems, ...).  The
// tile passes through shared memory, so that its loads, and the stores of
// z, are coalesced (16 bytes a thread; per-thread loads and stores of
// consecutive keys cost ~4 us more at N = 2^20, tools/kernel_variants).
//
//   1. The block's window of su.  While the tile loads, warp 0 finds lo =
//      UB(su, cs[i0]) and warp 1 hi = UB(su, cs[i1 - 1]), each over all of
//      su, 32 probes a round (about 4 dependent rounds at L = 2^20 instead
//      of 20).  A round keeps the gap before the FIRST probe above the key
//      (__ffs of the ballot of probes above it).
//   2. When the window holds at most kWindow floats (4x the mean at L = N),
//      the block copies su[lo, hi) into shared memory, coalesced, kCopy
//      loads in flight a thread.  Each thread counts its first key in the
//      whole window (r_t), then its other keys in [r_t, r_{t+1}) only, the
//      gap up to the next thread's first count: about 3 rounds each
//      instead of 12.  Counting is a branch-free binary search (the count
//      grows by each power of two, largest first, while the probe just
//      below the new count is <= the key), a thread's searches interleaved.
//   3. A larger window (skewed weights: one tile owns most of su) is
//      searched in place, in global memory (L2), every key in all of it,
//      but for the keys equal to the tile's first or last key, which take
//      the window's ends: with one particle holding all the weight, every
//      key of that tile is one of them.
//   4. z_i = min(lo + count, M), written once, coalesced.
//
// Why the contracts hold.  (1) On sorted su the window holds exactly the
// su_j with cs[i0] < su_j <= cs[i1 - 1]; every su_j before it is <= cs_i
// and every one after it > cs_i, so lo + count = UB(su, cs_i); the same
// holds of [r_t, r_{t+1}) inside the window.  (2) Each search is a fixed
// function of its key over a fixed array, nondecreasing in the key on ANY
// array: two keys take the same probes until the first probe that the
// larger key passes and the smaller fails, and from there the smaller
// key's result lies at or below that probe and the larger key's above it.
// So the r_t are nondecreasing, a thread's counts lie in [r_t, r_{t+1}],
// the in-place counts in [0, hi - lo] with the tile's end keys at the ends,
// and every z of block b lies in [lo_b, hi_b] with hi_b = UB(cs[i1 - 1]) <=
// UB(cs[i1]) = lo_{b+1}.  Each result p is moreover a binary search's
// answer on any su: p = 0 or su[p-1] <= cs_i, and p = L or su[p] > cs_i
// (at a range's ends, because the end is such an answer for a key at or
// beyond cs_i).  Keeping the gap before the first probe above the key is
// what keeps that when su dips: B2's count of the probes below the key
// (__popc, right on its sorted z) can step past a probe above it.  (3) The
// tiles are disjoint, and each key belongs to one thread.
//
// Residual resampling passes su with a tail of 2.0 past its draws
// (resampling.residual_counts): every window ends at UB(su, cs[N - 1]),
// before the tail, so only the warps' probes ever read it.
//
// The TPU kernel's chunked compare-and-count over scalar-prefetched block
// windows existed because the TPU has no fast search; there is no alignment
// gate and no L = N requirement here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a block's threads
constexpr int kItems = 8;       // keys a thread
constexpr int kWindow = 8192;   // su a block keeps in shared memory (32 KB)
constexpr int kCopy = 16;       // loads in flight a thread, copying a window

__device__ __forceinline__ int top_bit(int w) { return 1 << (31 - __clz(w)); }
__device__ __forceinline__ int64_t top_bit(int64_t w) {
  return (int64_t)1 << (63 - __clzll(w));
}

// UB(su, c) over su[0, L), by one warp: each round its 32 lanes probe 32
// evenly spaced points of [lo, hi), and the range shrinks to the gap between
// the probe before the first probe above c and that probe.  Every lane
// returns the result.
__device__ int64_t warp_upper_bound(const float* __restrict__ su, int64_t L,
                                    float c) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = L;
  while (hi > lo) {
    const int64_t n = hi - lo;
    const int64_t step = (n + 31) / 32;
    const int64_t reach = step * (lane + 1) < n ? step * (lane + 1) : n;
    const unsigned above =
        __ballot_sync(0xffffffffu, !(__ldg(su + lo + reach - 1) <= c));
    if (above == 0u) return hi;      // the last probe is hi - 1
    const int f = __ffs(above) - 1;  // the first probe above c
    const int64_t first = step * (f + 1) < n ? step * (f + 1) : n;
    hi = lo + first - 1;             // probe f
    lo += step * f;                  // one past probe f - 1
  }
  return lo;
}

// cnt[k] = UB(win[b, b + w), c[k]) for K keys at once, win in shared memory:
// a branch-free binary search (the count grows by each power of two,
// largest first, while the probe just below the new count is <= the key),
// the K searches interleaved.
template <int K>
__device__ __forceinline__ void window_counts(const float* win, int b, int w,
                                              const float* c, int* cnt) {
#pragma unroll
  for (int k = 0; k < K; ++k) cnt[k] = 0;
  if (w == 0) return;
  for (int step = top_bit(w); step > 0; step >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int p = cnt[k] + step;
      if (p <= w && win[b + p - 1] <= c[k]) cnt[k] = p;
    }
  }
}

// win[j] = src[j] for j < n, by the block, kCopy loads in flight a thread.
template <int NT>
__device__ __forceinline__ void copy_window(const float* __restrict__ src,
                                            int n, float* win) {
  for (int base = 0; base < n; base += NT * kCopy) {
    float v[kCopy];
#pragma unroll
    for (int k = 0; k < kCopy; ++k) {
      const int j = base + k * NT + threadIdx.x;
      v[k] = j < n ? __ldg(src + j) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kCopy; ++k) {
      const int j = base + k * NT + threadIdx.x;
      if (j < n) win[j] = v[k];
    }
  }
}

// A block of NT threads owns NT * NI consecutive cs, NI consecutive keys a
// thread, and keeps a window of up to NW su in shared memory.
// (tools/kernel_variants times other shapes.)
template <int NT, int NI, int NW>
__global__ void __launch_bounds__(NT)
k_merge_rank(const float* __restrict__ su, int64_t L,
             const float* __restrict__ cs, int64_t N, int64_t M,
             int32_t* __restrict__ z) {
  static_assert(NT >= 64 && NT % 32 == 0, "two warps search the window");
  static_assert(NI % 4 == 0, "keys move in 16-byte vectors");
  __shared__ float win[NW];
  __shared__ __align__(16) float tile[NT * NI];   // the keys, then z
  __shared__ int first[NT];   // the count of each thread's first key
  __shared__ int64_t edge[2];
  const int t = threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.x * (NT * NI);
  const int n = N - i0 < NT * NI ? (int)(N - i0) : NT * NI;
  // the tile's keys pass through shared memory, so that the loads (and the
  // stores of z) are coalesced: 16 bytes a thread where the tile is whole
  // and aligned
  const bool vec = n == NT * NI && ((uintptr_t)(cs + i0) & 15) == 0 &&
                   ((uintptr_t)(z + i0) & 15) == 0;
  float4 in[NI / 4];
  if (vec) {
#pragma unroll
    for (int q = 0; q < NI / 4; ++q) {
      in[q] = __ldg(reinterpret_cast<const float4*>(cs + i0) + q * NT + t);
    }
  } else {
#pragma unroll
    for (int q = 0; q < NI / 4; ++q) {
      float e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = (4 * q + k) * NT + t;
        e[k] = j < n ? __ldg(cs + i0 + j) : 0.0f;
      }
      in[q] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
  const int warp = t >> 5;
  if (warp < 2) {   // meanwhile, the window's ends
    const float key = __ldg(cs + (warp == 0 ? i0 : i0 + n - 1));
    const int64_t e = warp_upper_bound(su, L, key);
    if ((t & 31) == 0) edge[warp] = e;
  }
#pragma unroll
  for (int q = 0; q < NI / 4; ++q) {
    if (vec) {
      reinterpret_cast<float4*>(tile)[q * NT + t] = in[q];
    } else {
      tile[(4 * q) * NT + t] = in[q].x;
      tile[(4 * q + 1) * NT + t] = in[q].y;
      tile[(4 * q + 2) * NT + t] = in[q].z;
      tile[(4 * q + 3) * NT + t] = in[q].w;
    }
  }
  __syncthreads();
  const int nk = n - t * NI < NI ? (n - t * NI > 0 ? n - t * NI : 0) : NI;
  float c[NI];   // this thread's keys: the tile's [t NI, t NI + NI)
#pragma unroll
  for (int q = 0; q < NI / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(tile + t * NI)[q];
    c[4 * q] = v.x; c[4 * q + 1] = v.y; c[4 * q + 2] = v.z; c[4 * q + 3] = v.w;
  }
  const int64_t lo = edge[0];
  const int64_t w = edge[1] - lo;   // >= 0: the search is monotone
  int64_t got[NI];                  // counts in the window
  if (w <= NW) {                    // the same branch for the whole block
    const int wn = (int)w;
    copy_window<NT>(su + lo, wn, win);
    __syncthreads();
    // each thread's first key in the whole window, then its other keys
    // between that count and the next thread's
    int cnt[NI];
    cnt[0] = wn;
    if (nk > 0) window_counts<1>(win, 0, wn, c, cnt);
    first[t] = cnt[0];
    __syncthreads();
    const int r = cnt[0];
    const int top = t + 1 < NT ? first[t + 1] : wn;
    window_counts<NI - 1>(win, r, top - r, c + 1, cnt + 1);
    got[0] = r;
#pragma unroll
    for (int k = 1; k < NI; ++k) got[k] = r + cnt[k];
  } else {
    // Search in place (L2), every key in the whole window, but for the
    // keys equal to the tile's first or last key, whose counts are the
    // window's ends: with skewed weights most of the tile's keys are.
    const float c_lo = tile[0], c_hi = tile[n - 1];
#pragma unroll
    for (int k = 0; k < NI; ++k) got[k] = 0;
    for (int64_t step = top_bit(w); step > 0; step >>= 1) {
#pragma unroll
      for (int k = 0; k < NI; ++k) {
        const int64_t p = got[k] + step;
        if (p <= w && c[k] != c_lo && c[k] != c_hi &&
            __ldg(su + lo + p - 1) <= c[k]) {
          got[k] = p;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      if (c[k] == c_hi) got[k] = w;
    }
  }
  int32_t out[NI];
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const int64_t v = lo + got[k];
    out[k] = (int32_t)(v < M ? v : M);
  }
  __syncthreads();   // every key read from the tile: it takes z now
  int32_t* zt = reinterpret_cast<int32_t*>(tile);
#pragma unroll
  for (int q = 0; q < NI / 4; ++q) {
    reinterpret_cast<int4*>(zt + t * NI)[q] =
        make_int4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NI / 4; ++q) {
    if (vec) {
      reinterpret_cast<int4*>(z + i0)[q * NT + t] =
          reinterpret_cast<const int4*>(zt)[q * NT + t];
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = (4 * q + k) * NT + t;
        if (j < n) z[i0 + j] = zt[j];
      }
    }
  }
}

}  // namespace

extern "C" {

// Consecutive cs a block owns, and the su it keeps in shared memory.
int pt_merge_rank_tile(void) { return kThreads * kItems; }
int pt_merge_rank_window(void) { return kWindow; }

// su: (L,) f32, cs: (N,) f32, z: (N,) int32 out, all on the device; one
// launch.  Returns cudaGetLastError().
int pt_merge_rank_counts(const void* su, long long L, const void* cs,
                         long long N, long long M, void* z, void* stream) {
  constexpr int64_t tile = kThreads * kItems;
  const int64_t nb = (N + tile - 1) / tile;
  k_merge_rank<kThreads, kItems, kWindow>
      <<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)su, L, (const float*)cs, N, M, (int32_t*)z);
  return (int)cudaGetLastError();
}

}  // extern "C"
