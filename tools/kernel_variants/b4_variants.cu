// Times B4 (csrc/repeat_kernel.cu, pt_repeat_by_su: a guide table of
// 16-byte entries {G[b], G[b+1], cs[G[b]], cs[G[b]+1]}, built a lane per
// bucket, each counting the cs below the bucket's float threshold in radix
// 4, and served in two launches) on the card beside
//   - the first port's kernel (k_serve_su: one thread a query, a binary
//     search of all of cs), the baseline;
//   - B4 at K = N/4, N/2, N and 2N buckets, and each launch alone (the
//     build; the serve from a built table);
//   - B4's entries built other ways: the count in radix 2 or 8
//     (k_radix_build); a search on f(cs_i) < b with 8 or 16 probes a round
//     (k_wide_build); threads that own 2, 4 or 8 consecutive buckets
//     each, one binary search of all of cs for the first and a gallop for
//     each next one (k_gallop_build); a warp per 32 buckets, two 32-probe
//     warp searches for G[b0] and G[b0 + 32] and a binary search a lane
//     between them (k_warp_pair_build);
//   - B4 in one cooperative launch (build, grid.sync(), serve; persistent
//     blocks);
//   - the first guide design, G alone (int32 entries; the serve reads
//     G[b] and G[b+1] and searches cs[G[b], G[b+1])), at K = N/4, N and 2N,
//     in two launches and in one cooperative launch;
//   - a two-level search: every S-th cs copied into a contiguous sample
//     (one launch), then persistent blocks that keep the sample in shared
//     memory search it, and then S floats of cs, for each query;
// on unsorted uniforms over the Dirichlet(1) CDF, the same uniforms sorted,
// and unsorted uniforms over a degenerate CDF (a step from 0 to 1), all at
// N = M = 2^20, ancestors only.  Every variant's A is compared with
// std::lower_bound's, clipped to N - 1.  Also the host time to enqueue one
// call, two launches against one cooperative launch.  Build and run with
// run.sh.
#include "../../particles_tpu_torch/csrc/repeat_kernel.cu"
#include "common.cuh"
#include <algorithm>
#include <chrono>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

// The first i in [lo, hi) with f(cs_i) >= b (hi if none), a binary search
// with f computed at each probe
__device__ __forceinline__ int guide_search(const float* __restrict__ cs,
                                            int lo, int hi, int b, float s,
                                            int K) {
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (guide_bucket(__ldg(cs + mid), s, K) < b) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The same, W probes a round (the W loads of a round independent), the
// last W or fewer entries counted at once
template <int W>
__device__ __forceinline__ int guide_search_wide(const float* __restrict__ cs, int lo, int hi,
                                                 int b, float s, int K) {
  while (hi - lo > W) {
    const int64_t n = hi - lo;
    const int64_t step = (n + W - 1) / W;
    int below = 0;
#pragma unroll
    for (int k = 1; k <= W; ++k) {
      const int64_t reach = step * k < n ? step * k : n;
      below += guide_bucket(__ldg(cs + lo + reach - 1), s, K) < b;
    }
    if (below == W) return hi;
    const int64_t first = step * (below + 1) < n ? step * (below + 1) : n;
    hi = lo + (int)first - 1;
    lo += (int)(step * below);
  }
  int below = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) below += lo + k < hi && guide_bucket(__ldg(cs + lo + k), s, K) < b;
  return lo + below;
}

// the first port's B4: one thread a query, a binary search of all of cs
__global__ void k_serve_su(const float* __restrict__ su,
                           const float* __restrict__ cs, int64_t N, int64_t M,
                           int64_t* __restrict__ anc) {
  const int64_t j = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (j >= M) return;
  const float s = __ldg(su + j);
  int64_t lo = 0, hi = N;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(cs + mid) < s) lo = mid + 1; else hi = mid;
  }
  anc[j] = lo < N - 1 ? lo : N - 1;
}

// B4's serve, ancestors only, given its entry (shared by the variants)
__device__ __forceinline__ int serve_entry(const float* __restrict__ cs, int4 e, float u) {
  if (e.x == e.y || !(__int_as_float(e.z) < u)) return e.x;
  if (e.y - e.x == 1 || !(__int_as_float(e.w) < u)) return e.x + 1;
  int lo = e.x + 2, hi = e.y;
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (__ldg(cs + mid) < u) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The first i in [lo, N) with f(cs_i) >= b, galloping: probes lo, lo + 1,
// lo + 3, lo + 7, ... until one has f >= b, then searches the last gap.
__device__ __forceinline__ int guide_gallop(const float* __restrict__ cs, int N, int lo, int b,
                                            float s, int K) {
  int step = 1;
  while (lo < N && guide_bucket(__ldg(cs + lo), s, K) < b) {
    const int next = N - lo > step ? lo + step : N;
    if (next == N || guide_bucket(__ldg(cs + next), s, K) >= b) {
      return guide_search(cs, lo + 1, next, b, s, K);
    }
    lo = next + 1;
    step *= 2;
  }
  return lo;
}

// B4's entries, a thread per B consecutive buckets (search, then gallops)
template <int B>
__global__ void __launch_bounds__(256)
k_gallop_build(const float* __restrict__ cs, int N, int K, int4* __restrict__ E,
               float* __restrict__ s_out) {
  const int64_t b0 = ((int64_t)blockIdx.x * 256 + threadIdx.x) * B;
  const float s = guide_scale(cs, N, K);
  if (b0 == 0) *s_out = s;
  if (b0 >= K) return;
  int lo = guide_search(cs, 0, N, (int)b0, s, K);
  for (int q = 0; q < B && b0 + q < K; ++q) {
    const int b = (int)b0 + q;
    const int hi = guide_gallop(cs, N, lo, b + 1, s, K);
    E[b] = make_int4(lo, hi, __float_as_int(__ldg(cs + (lo < N ? lo : N - 1))),
                     __float_as_int(__ldg(cs + (lo + 1 < N ? lo + 1 : N - 1))));
    lo = hi;
  }
}

// B4's entries with a search of f(cs_i) < b, W probes a round
template <int W>
__global__ void __launch_bounds__(256)
k_wide_build(const float* __restrict__ cs, int N, int K, int4* __restrict__ E,
             float* __restrict__ s_out) {
  const int64_t t = (int64_t)blockIdx.x * 256 + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int64_t b = (t >> 5) * 31 + lane;
  const float s = guide_scale(cs, N, K);
  if (t == 0) *s_out = s;
  if (b - lane >= K) return;
  const int g = b < K ? guide_search_wide<W>(cs, 0, N, (int)b, s, K) : N;
  const int g1 = __shfl_down_sync(0xffffffffu, g, 1);
  if (lane < 31 && b < K) {
    E[b] = make_int4(g, g1, __float_as_int(__ldg(cs + (g < N ? g : N - 1))),
                     __float_as_int(__ldg(cs + (g + 1 < N ? g + 1 : N - 1))));
  }
}

// The first i in [lo, N) with f(cs_i) >= b, by one warp: 32 evenly spaced
// probes a round, the range shrinking to the gap before the first probe at
// or above b.  Every lane returns it.
__device__ int guide_warp_search(const float* __restrict__ cs, int lo, int N, int b, float s,
                                 int K) {
  const int lane = threadIdx.x & 31;
  int64_t l = lo, h = N;
  while (h > l) {
    const int64_t n = h - l;
    const int64_t step = (n + 31) / 32;
    const int64_t reach = step * (lane + 1) < n ? step * (lane + 1) : n;
    const unsigned at = __ballot_sync(0xffffffffu,
                                      guide_bucket(__ldg(cs + l + reach - 1), s, K) >= b);
    if (at == 0u) return (int)h;
    const int f = __ffs(at) - 1;
    const int64_t first = step * (f + 1) < n ? step * (f + 1) : n;
    h = l + first - 1;
    l += step * f;
  }
  return (int)l;
}

// B4's entries as k_guide_build builds them, with the count in radix R
template <int R>
__global__ void __launch_bounds__(256)
k_radix_build(const float* __restrict__ cs, int N, int K, int4* __restrict__ E,
              float* __restrict__ s_out) {
  const int64_t t = (int64_t)blockIdx.x * 256 + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int64_t b = (t >> 5) * 31 + lane;
  const float s = guide_scale(cs, N, K);
  if (t == 0) *s_out = s;
  if (b - lane >= K) return;
  const int g = guide_count<R>(cs, N, b, s, K);
  const int g1 = __shfl_down_sync(0xffffffffu, g, 1);
  if (lane < 31 && b < K) {
    E[b] = make_int4(g, g1, __float_as_int(__ldg(cs + (g < N ? g : N - 1))),
                     __float_as_int(__ldg(cs + (g + 1 < N ? g + 1 : N - 1))));
  }
}

// B4's entries, a warp per 32 buckets: warp searches for G[b0] and
// G[b0 + 32], a binary search a lane between them
__global__ void __launch_bounds__(256)
k_warp_pair_build(const float* __restrict__ cs, int N, int K, int4* __restrict__ E,
                  float* __restrict__ s_out) {
  const int lane = threadIdx.x & 31;
  const int64_t b0 = ((int64_t)blockIdx.x * 256 + threadIdx.x) & ~31LL;
  const float s = guide_scale(cs, N, K);
  if (b0 == 0 && lane == 0) *s_out = s;
  if (b0 >= K) return;
  const int end = b0 + 32 < K ? (int)b0 + 32 : K;
  const int lo = guide_warp_search(cs, 0, N, (int)b0, s, K);
  const int hi = guide_warp_search(cs, lo, N, end, s, K);
  const int b = (int)b0 + lane;
  const int g = b >= end ? hi : (lo < hi ? guide_search(cs, lo, hi, b, s, K) : lo);
  int g1 = __shfl_down_sync(0xffffffffu, g, 1);
  if (lane == 31) g1 = hi;
  if (b < K) {
    E[b] = make_int4(g, g1, __float_as_int(__ldg(cs + (g < N ? g : N - 1))),
                     __float_as_int(__ldg(cs + (g + 1 < N ? g + 1 : N - 1))));
  }
}

// B4 in one cooperative launch: every warp builds its shares of 31 entries
// as k_guide_build does, the grid syncs, and every block serves its share
// of the queries (the entries read through L2: they were written in this
// launch)
__global__ void __launch_bounds__(256)
k_fat_coop(const float* __restrict__ su, const float* __restrict__ cs, int N,
           int64_t M, int4* E, int K, int64_t* __restrict__ anc) {
  cg::grid_group grid = cg::this_grid();
  const float s = guide_scale(cs, N, K);
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t t = t0; ((t >> 5) * 31) < K; t += stride) {
    const int64_t b = (t >> 5) * 31 + lane;
    const int g = guide_count<kGuideRadix>(cs, N, b, s, K);
    const int g1 = __shfl_down_sync(0xffffffffu, g, 1);
    if (lane < 31 && b < K) {
      E[b] = make_int4(g, g1, __float_as_int(__ldg(cs + (g < N ? g : N - 1))),
                       __float_as_int(__ldg(cs + (g + 1 < N ? g + 1 : N - 1))));
    }
  }
  grid.sync();
  for (int64_t j = t0; j < M; j += stride) {
    const float u = __ldg(su + j);
    const int4 e = __ldcg(E + guide_bucket(u, s, K));
    const int a = serve_entry(cs, e, u);
    anc[j] = a < N - 1 ? a : N - 1;
  }
}

// the first guide design: G alone, one search of all of cs a bucket
__global__ void __launch_bounds__(256)
k_gonly_build(const float* __restrict__ cs, int N, int K, int32_t* __restrict__ G) {
  const int64_t b = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (b > K) return;
  G[b] = guide_search(cs, 0, N, (int)b, guide_scale(cs, N, K), K);
}

__global__ void __launch_bounds__(256)
k_gonly_serve(const float* __restrict__ su, const float* __restrict__ cs, int N,
              int64_t M, const int32_t* __restrict__ G, int K, int64_t* __restrict__ anc) {
  const int64_t j = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (j >= M) return;
  const float u = __ldg(su + j);
  const int b = guide_bucket(u, guide_scale(cs, N, K), K);
  int lo = __ldg(G + b), hi = __ldg(G + b + 1);
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (__ldg(cs + mid) < u) lo = mid + 1; else hi = mid;
  }
  anc[j] = lo < N - 1 ? lo : N - 1;
}

__global__ void __launch_bounds__(256)
k_gonly_coop(const float* __restrict__ su, const float* __restrict__ cs, int N,
             int64_t M, int32_t* G, int K, int64_t* __restrict__ anc) {
  cg::grid_group grid = cg::this_grid();
  const float s = guide_scale(cs, N, K);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t b = t0; b <= K; b += stride) G[b] = guide_search(cs, 0, N, (int)b, s, K);
  grid.sync();
  for (int64_t j = t0; j < M; j += stride) {
    const float u = __ldg(su + j);
    const int b = guide_bucket(u, s, K);
    int lo = __ldcg(G + b), hi = __ldcg(G + b + 1);
    while (lo < hi) {
      const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
      if (__ldg(cs + mid) < u) lo = mid + 1; else hi = mid;
    }
    anc[j] = lo < N - 1 ? lo : N - 1;
  }
}

// two-level search, launch 1: sample[k] = the last cs of group k (S each)
__global__ void k_sample(const float* __restrict__ cs, int64_t N, int S,
                         int64_t ns, float* __restrict__ sample) {
  const int64_t k = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (k < ns) sample[k] = __ldg(cs + ((k + 1) * S < N ? (k + 1) * S : N) - 1);
}

// launch 2: persistent blocks copy the sample (contiguous) into shared
// memory; a query finds its group there, then searches the group's S cs
__global__ void __launch_bounds__(1024)
k_two_level(const float* __restrict__ su, const float* __restrict__ cs,
            int64_t N, int64_t M, const float* __restrict__ sample,
            int64_t ns, int S, int64_t* __restrict__ anc) {
  extern __shared__ float sm[];
  for (int64_t i = threadIdx.x; i < ns; i += blockDim.x) sm[i] = __ldg(sample + i);
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < M; j += stride) {
    const float u = __ldg(su + j);
    int64_t lo = 0, hi = ns;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (sm[mid] < u) lo = mid + 1; else hi = mid;
    }
    int64_t a = N;
    if (lo < ns) {
      int64_t l2 = lo * S, h2 = l2 + S < N ? l2 + S : N;
      while (l2 < h2) {
        const int64_t mid = (l2 + h2) >> 1;
        if (__ldg(cs + mid) < u) l2 = mid + 1; else h2 = mid;
      }
      a = l2;
    }
    anc[j] = a < N - 1 ? a : N - 1;
  }
}

template <int B>
void gallop_build(const float* cs, int N, int K, int32_t* g) {
  const int64_t per = 256LL * B;
  k_gallop_build<B><<<(unsigned)((K + per - 1) / per), 256>>>(cs, N, K, (int4*)g,
                                                              (float*)(g + 4LL * K));
}

}  // namespace

int main() {
  std::mt19937_64 rng(4);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  const int64_t N = 1 << 20, M = N;
  int sms = 0;
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  int fat_per_sm = 0, gonly_per_sm = 0;
  CK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fat_per_sm, k_fat_coop, 256, 0));
  CK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&gonly_per_sm, k_gonly_coop, 256, 0));
  const int S = 32;
  const int64_t ns = (N + S - 1) / S;
  const size_t two_smem = ns * sizeof(float);   // 128 KB at N = 2^20
  CK(cudaFuncSetAttribute((const void*)k_two_level,
                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)two_smem));
  const char* names[] = {"dirichlet1_unsorted", "dirichlet1_sorted", "degenerate_unsorted"};
  std::vector<float> hcs(N), hsu(M);
  {
    std::gamma_distribution<double> gam(1.0, 1.0);
    std::vector<double> w(N); double s = 0;
    for (auto& x : w) { x = gam(rng); s += x; }
    double c = 0;
    for (int64_t i = 0; i < N; ++i) { c += w[i]; hcs[i] = (float)(c / s); }
    hcs[N - 1] = 1.0f;   // pinned, as resampling._pinned_cdf does
  }
  for (auto& x : hsu) x = (float)uni(rng);
  float *su, *cs, *sample; int64_t* anc; int32_t* g;
  CK(cudaMalloc(&su, M * 4)); CK(cudaMalloc(&cs, N * 4)); CK(cudaMalloc(&anc, M * 8));
  CK(cudaMalloc(&sample, ns * 4)); CK(cudaMalloc(&g, (8 * N + 4) * 4));
  std::vector<int64_t> ref(M), ha(M);
  for (int kind = 0; kind < 3; ++kind) {
    std::vector<float> c = hcs, u = hsu;
    if (kind == 1) std::sort(u.begin(), u.end());
    if (kind == 2) for (int64_t i = 0; i < N; ++i) c[i] = i < N / 3 ? 0.0f : 1.0f;
    for (int64_t j = 0; j < M; ++j) {
      const int64_t r = std::lower_bound(c.begin(), c.end(), u[j]) - c.begin();
      ref[j] = std::min<int64_t>(r, N - 1);
    }
    CK(cudaMemcpy(su, u.data(), M * 4, cudaMemcpyHostToDevice));
    CK(cudaMemcpy(cs, c.data(), N * 4, cudaMemcpyHostToDevice));
    auto check = [&]() {
      CK(cudaDeviceSynchronize());
      CK(cudaMemcpy(ha.data(), anc, M * 8, cudaMemcpyDeviceToHost));
      long long d = 0;
      for (int64_t j = 0; j < M; ++j) d += ha[j] != ref[j];
      CK(cudaMemset(anc, 0xff, M * 8));
      return d;
    };
    printf("{\"kind\": \"%s\", \"N\": %lld, \"M\": %lld, \"bound_us\": %.3f", names[kind],
           (long long)N, (long long)M, (4.0 * M + 4.0 * N + 8.0 * M) / 3.35e12 * 1e6);
#define RUN(tag, expr) { float us = device_us([&] { expr; }); long long d = check(); \
    printf(", \"%s_us\": %.3f, \"%s_differs\": %lld", tag, us, tag, d); }
#define TIME(tag, expr) { float us = device_us([&] { expr; }); printf(", \"%s_us\": %.3f", tag, us); }
    RUN("first_port", (k_serve_su<<<(unsigned)((M + 255) / 256), 256>>>(su, cs, N, M, anc)));
    char tag[64];
    const int64_t Ks[] = {N / 8, N / 4, N / 2, N, 2 * N};
    const char* kn[] = {"N8", "N4", "N2", "N", "2N"};
    for (int q = 0; q < 5; ++q) {
      const int K = (int)Ks[q];
      snprintf(tag, sizeof tag, "b4_K%s", kn[q]);
      RUN(tag, CK((cudaError_t)pt_repeat_by_su(su, M, cs, N, g, K, 1, 0, nullptr, anc, 0)));
      snprintf(tag, sizeof tag, "b4_K%s_serve_only", kn[q]);
      RUN(tag, CK((cudaError_t)pt_repeat_by_su(su, M, cs, N, g, K, 0, 0, nullptr, anc, 0)));
      const unsigned wide_blocks = (unsigned)(((K + 30) / 31 * 32 + 255) / 256);
      snprintf(tag, sizeof tag, "b4_K%s_build_only", kn[q]);
      TIME(tag, (k_guide_build<<<wide_blocks, 256>>>(cs, (int)N, K, (int4*)g,
                                                    (float*)(g + 4LL * K))));
      snprintf(tag, sizeof tag, "radix2_K%s_build_only", kn[q]);
      TIME(tag, (k_radix_build<2><<<wide_blocks, 256>>>(cs, (int)N, K, (int4*)g,
                                                       (float*)(g + 4LL * K))));
      snprintf(tag, sizeof tag, "radix8_K%s_build_only", kn[q]);
      TIME(tag, (k_radix_build<8><<<wide_blocks, 256>>>(cs, (int)N, K, (int4*)g,
                                                       (float*)(g + 4LL * K))));
      snprintf(tag, sizeof tag, "wide8_K%s_build_only", kn[q]);
      TIME(tag, (k_wide_build<8><<<wide_blocks, 256>>>(cs, (int)N, K, (int4*)g,
                                                      (float*)(g + 4LL * K))));
      snprintf(tag, sizeof tag, "wide16_K%s_build_only", kn[q]);
      TIME(tag, (k_wide_build<16><<<wide_blocks, 256>>>(cs, (int)N, K, (int4*)g,
                                                       (float*)(g + 4LL * K))));
      auto wide16_then_serve = [&] {
        k_wide_build<16><<<wide_blocks, 256>>>(cs, (int)N, K, (int4*)g, (float*)(g + 4LL * K));
        CK((cudaError_t)pt_repeat_by_su(su, M, cs, N, g, K, 0, 0, nullptr, anc, 0));
      };
      snprintf(tag, sizeof tag, "wide16_K%s_then_serve", kn[q]);
      RUN(tag, wide16_then_serve());
      snprintf(tag, sizeof tag, "warp_pair_K%s_build_only", kn[q]);
      TIME(tag, (k_warp_pair_build<<<(unsigned)((K + 255) / 256), 256>>>(
                     cs, (int)N, K, (int4*)g, (float*)(g + 4LL * K))));
      snprintf(tag, sizeof tag, "gallop_K%s_build_only_items2", kn[q]);
      TIME(tag, gallop_build<2>(cs, (int)N, K, g));
      snprintf(tag, sizeof tag, "gallop_K%s_build_only_items4", kn[q]);
      TIME(tag, gallop_build<4>(cs, (int)N, K, g));
      snprintf(tag, sizeof tag, "gallop_K%s_build_only_items8", kn[q]);
      TIME(tag, gallop_build<8>(cs, (int)N, K, g));
      // the serve again, from a gallop-built table (the same entries)
      snprintf(tag, sizeof tag, "gallop_K%s_then_serve", kn[q]);
      auto gallop_then_serve = [&] {
        gallop_build<4>(cs, (int)N, K, g);
        CK((cudaError_t)pt_repeat_by_su(su, M, cs, N, g, K, 0, 0, nullptr, anc, 0));
      };
      RUN(tag, gallop_then_serve());
      int n = (int)N, k = K; int64_t m = M;
      const float* a_su = su; const float* a_cs = cs; int64_t* a_anc = anc;
      int4* a_e = (int4*)g;
      void* args[] = {&a_su, &a_cs, &n, &m, &a_e, &k, &a_anc};
      snprintf(tag, sizeof tag, "b4_K%s_one_coop_launch", kn[q]);
      RUN(tag, CK(cudaLaunchCooperativeKernel((const void*)k_fat_coop,
                                              dim3(fat_per_sm * sms), dim3(256), args, 0, 0)));
    }
    const int64_t Kg[] = {N / 4, N, 2 * N};
    const char* kgn[] = {"N4", "N", "2N"};
    for (int q = 0; q < 3; ++q) {
      const int K = (int)Kg[q];
      auto two = [&] {
        k_gonly_build<<<(unsigned)((K + 256) / 256), 256>>>(cs, (int)N, K, g);
        k_gonly_serve<<<(unsigned)((M + 255) / 256), 256>>>(su, cs, (int)N, M, g, K, anc);
      };
      snprintf(tag, sizeof tag, "g_only_K%s", kgn[q]);
      RUN(tag, two());
      snprintf(tag, sizeof tag, "g_only_K%s_serve_only", kgn[q]);
      RUN(tag, (k_gonly_serve<<<(unsigned)((M + 255) / 256), 256>>>(su, cs, (int)N, M, g, K, anc)));
      snprintf(tag, sizeof tag, "g_only_K%s_build_only", kgn[q]);
      TIME(tag, (k_gonly_build<<<(unsigned)((K + 256) / 256), 256>>>(cs, (int)N, K, g)));
      int n = (int)N, k = K; int64_t m = M;
      const float* a_su = su; const float* a_cs = cs; int64_t* a_anc = anc; int32_t* a_g = g;
      void* args[] = {&a_su, &a_cs, &n, &m, &a_g, &k, &a_anc};
      snprintf(tag, sizeof tag, "g_only_K%s_one_coop_launch", kgn[q]);
      RUN(tag, CK(cudaLaunchCooperativeKernel((const void*)k_gonly_coop, dim3(gonly_per_sm * sms),
                                              dim3(256), args, 0, 0)));
    }
    auto two_level = [&] {
      k_sample<<<(unsigned)((ns + 255) / 256), 256>>>(cs, N, S, ns, sample);
      k_two_level<<<(unsigned)sms, 1024, two_smem>>>(su, cs, N, M, sample, ns, S, anc);
    };
    RUN("two_level_S32", two_level());
    printf("}\n");
    fflush(stdout);
  }
  // host time to enqueue one call: 100 calls back to back, no sync between
  auto host_us = [&](auto launch) {
    launch(); CK(cudaDeviceSynchronize());
    const auto t0 = std::chrono::steady_clock::now();
    for (int r = 0; r < 100; ++r) launch();
    const auto t1 = std::chrono::steady_clock::now();
    CK(cudaDeviceSynchronize());
    return std::chrono::duration<double, std::micro>(t1 - t0).count() / 100;
  };
  const int K = (int)(N >> 2);
  int n = (int)N, k = K; int64_t m = M;
  const float* a_su = su; const float* a_cs = cs; int64_t* a_anc = anc; int4* a_e = (int4*)g;
  void* args[] = {&a_su, &a_cs, &n, &m, &a_e, &k, &a_anc};
  const double two = host_us([&] {
    CK((cudaError_t)pt_repeat_by_su(su, M, cs, N, g, K, 1, 0, nullptr, anc, 0)); });
  const double one = host_us([&] {
    CK(cudaLaunchCooperativeKernel((const void*)k_fat_coop, dim3(fat_per_sm * sms),
                                   dim3(256), args, 0, 0)); });
  printf("{\"host_enqueue_us\": {\"two_launches\": %.3f, \"one_coop_launch\": %.3f}, "
         "\"coop_grid\": %d, \"sms\": %d}\n", two, one, fat_per_sm * sms, sms);
  return 0;
}
