// Times B5 (csrc/merge_rank_kernel.cu, k_merge_rank) on the card beside
// variants of its block shape (threads, keys a thread, the window of su a
// block keeps in shared memory), the first port's kernel (one thread per
// key, a binary search of all of su) and its shared-memory path with
// uncoalesced key I/O cut after each stage (k_stages), on Dirichlet(1) and
// Dirichlet(0.05) weights, a degenerate CDF (a step from 0 to 1: one
// block's window is all of su) and L = 2N + 1 uniforms.  Every variant's z
// is compared with std::upper_bound's (a cut stage's differs by design).
// Build and run with run.sh.
#include "../../particles_tpu_torch/csrc/merge_rank_kernel.cu"
#include "common.cuh"
#include <algorithm>

namespace {

// the first port's B5: one thread per cs_i, a binary search of all of su
__global__ void k_one_search(const float* __restrict__ su, int64_t L,
                             const float* __restrict__ cs, int64_t N,
                             int64_t M, int32_t* __restrict__ z) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= N) return;
  const float c = cs[i];
  int64_t lo = 0, hi = L;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(su + mid) <= c) lo = mid + 1; else hi = mid;
  }
  z[i] = (int32_t)(lo < M ? lo : M);
}

template <int NT, int NI, int NW>
void launch_v(const float* su, int64_t L, const float* cs, int64_t N, int64_t M, int32_t* z) {
  const int64_t nb = (N + NT * NI - 1) / (NT * NI);
  k_merge_rank<NT, NI, NW><<<(unsigned)nb, NT>>>(su, L, cs, N, M, z);
}

// The window search with K probes a lane, 32 K a round (K = 1 is B5's).
template <int K>
__device__ int64_t warp_upper_bound_k(const float* __restrict__ su, int64_t L, float c) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = L;
  while (hi > lo) {
    const int64_t n = hi - lo;
    const int64_t step = (n + 32 * K - 1) / (32 * K);
    int mine = K;   // this lane's first probe above c
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const int64_t q = (int64_t)lane * K + k;
      const int64_t reach = step * (q + 1) < n ? step * (q + 1) : n;
      if (!(__ldg(su + lo + reach - 1) <= c)) mine = k;
    }
    const unsigned any = __ballot_sync(0xffffffffu, mine < K);
    if (any == 0u) return hi;
    const int fl = __ffs(any) - 1;
    const int f = fl * K + __shfl_sync(0xffffffffu, mine, fl);
    const int64_t first = step * (f + 1) < n ? step * (f + 1) : n;
    hi = lo + first - 1;
    lo += step * f;
  }
  return lo;
}

// B5's shared-memory path as first written, each thread loading its NI
// keys and storing its NI outputs itself (stride NI between the lanes: not
// coalesced), cut after a stage to see where its time went: 0 the keys'
// load, the window searches and z = lo stored; 1 and the window copied;
// 2 and each thread's first key counted (z = lo + that count); 3 all of
// it.  Only stage 3 gives B5's answer.
template <int NT, int NI, int NW, int STAGE, int K>
__global__ void __launch_bounds__(NT)
k_stages(const float* __restrict__ su, int64_t L, const float* __restrict__ cs, int64_t N, int64_t M, int32_t* __restrict__ z) {
  __shared__ float win[NW];
  __shared__ int first[NT];
  __shared__ int64_t edge[2];
  const int64_t i0 = (int64_t)blockIdx.x * (NT * NI);
  const int64_t i1 = i0 + NT * NI < N ? i0 + NT * NI : N;
  const int64_t k0 = i0 + (int64_t)threadIdx.x * NI;
  const int nk = k0 < i1 ? (i1 - k0 < NI ? (int)(i1 - k0) : NI) : 0;
  float c[NI];
#pragma unroll
  for (int k = 0; k < NI; ++k) c[k] = k < nk ? __ldg(cs + k0 + k) : 0.0f;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t e = warp_upper_bound_k<K>(su, L, __ldg(cs + (warp == 0 ? i0 : i1 - 1)));
    if ((threadIdx.x & 31) == 0) edge[warp] = e;
  }
  __syncthreads();
  const int64_t lo = edge[0];
  const int wn = edge[1] - lo < NW ? (int)(edge[1] - lo) : NW;   // cut
  int cnt[NI];
#pragma unroll
  for (int k = 0; k < NI; ++k) cnt[k] = 0;
  if (STAGE >= 1) {
    copy_window<NT>(su + lo, wn, win);
    __syncthreads();
  }
  if (STAGE >= 2) {
    cnt[0] = wn;
    if (nk > 0) window_counts<1>(win, 0, wn, c, cnt);
    first[threadIdx.x] = cnt[0];
    __syncthreads();
#pragma unroll
    for (int k = 1; k < NI; ++k) cnt[k] = cnt[0];
  }
  if (STAGE >= 3) {
    const int r = cnt[0];
    const int top = threadIdx.x + 1 < NT ? first[threadIdx.x + 1] : wn;
    window_counts<NI - 1>(win, r, top - r, c + 1, cnt + 1);
#pragma unroll
    for (int k = 1; k < NI; ++k) cnt[k] += r;
  }
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const int64_t v = lo + cnt[k];
    if (k < nk) z[k0 + k] = (int32_t)(v < M ? v : M);
  }
}

template <int STAGE, int K>
void launch_s(const float* su, int64_t L, const float* cs, int64_t N, int64_t M, int32_t* z) {
  k_stages<256, 8, 8192, STAGE, K><<<(unsigned)((N + 2047) / 2048), 256>>>(su, L, cs, N, M, z);
}

}  // namespace

int main() {
  std::mt19937_64 rng(5);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  const int64_t N = 1 << 20;
  const char* names[] = {"dirichlet1", "dirichlet0.05", "degenerate", "dirichlet1_L2N+1"};
  for (int kind = 0; kind < 4; ++kind) {
    const int64_t L = kind == 3 ? 2 * N + 1 : N;
    const int64_t M = N;
    std::vector<float> hcs(N), hsu(L);
    if (kind == 2) {  // one particle takes all
      for (int64_t i = 0; i < N; ++i) hcs[i] = i < N / 3 ? 0.0f : 1.0f;
    } else {
      std::gamma_distribution<double> gam(kind == 1 ? 0.05 : 1.0, 1.0);
      std::vector<double> w(N); double s = 0;
      for (auto& x : w) { x = gam(rng); s += x; }
      double c = 0;
      for (int64_t i = 0; i < N; ++i) { c += w[i]; hcs[i] = (float)(c / s); }
    }
    for (auto& x : hsu) x = (float)uni(rng);
    std::sort(hsu.begin(), hsu.end());
    std::vector<int32_t> ref(N), hz(N);
    for (int64_t i = 0; i < N; ++i) {
      const int64_t r = std::upper_bound(hsu.begin(), hsu.end(), hcs[i]) - hsu.begin();
      ref[i] = (int32_t)std::min<int64_t>(r, M);
    }
    float *su, *cs; int32_t* z;
    CK(cudaMalloc(&su, L * 4)); CK(cudaMalloc(&cs, N * 4)); CK(cudaMalloc(&z, N * 4));
    CK(cudaMemcpy(su, hsu.data(), L * 4, cudaMemcpyHostToDevice));
    CK(cudaMemcpy(cs, hcs.data(), N * 4, cudaMemcpyHostToDevice));
    auto check = [&]() { CK(cudaDeviceSynchronize()); CK(cudaMemcpy(hz.data(), z, N * 4, cudaMemcpyDeviceToHost));
      long long d = 0; for (int64_t i = 0; i < N; ++i) d += hz[i] != ref[i]; CK(cudaMemset(z, 0xff, N * 4)); return d; };
    printf("{\"kind\": \"%s\", \"N\": %lld, \"L\": %lld, \"bound_us\": %.3f", names[kind], (long long)N, (long long)L,
           (4.0 * L + 8.0 * N) / 3.35e12 * 1e6);
#define RUN(tag, expr) { float us = device_us([&] { expr; }); long long d = check(); \
    printf(", \"%s_us\": %.3f, \"%s_differs\": %lld", tag, us, tag, d); }
    RUN("cur", CK((cudaError_t)pt_merge_rank_counts(su, L, cs, N, M, z, 0)));
    RUN("first_port", (k_one_search<<<(unsigned)((N + 255) / 256), 256>>>(su, L, cs, N, M, z)));
    if (kind == 0) {
      RUN("stage0", (launch_s<0, 1>(su, L, cs, N, M, z)));
      RUN("stage1", (launch_s<1, 1>(su, L, cs, N, M, z)));
      RUN("stage2", (launch_s<2, 1>(su, L, cs, N, M, z)));
      RUN("stage3", (launch_s<3, 1>(su, L, cs, N, M, z)));
      RUN("stage0_k4", (launch_s<0, 4>(su, L, cs, N, M, z)));
      RUN("stage3_k4", (launch_s<3, 4>(su, L, cs, N, M, z)));
    }
    RUN("t512i8w4096", (launch_v<512, 8, 4096>(su, L, cs, N, M, z)));
    RUN("t128i8w4096", (launch_v<128, 8, 4096>(su, L, cs, N, M, z)));
    RUN("t256i16w4096", (launch_v<256, 16, 4096>(su, L, cs, N, M, z)));
    RUN("t256i4w4096", (launch_v<256, 4, 4096>(su, L, cs, N, M, z)));
    RUN("t256i8w4096", (launch_v<256, 8, 4096>(su, L, cs, N, M, z)));
    RUN("t128i16w4096", (launch_v<128, 16, 4096>(su, L, cs, N, M, z)));
    printf("}\n");
    cudaFree(su); cudaFree(cs); cudaFree(z);
  }
  return 0;
}
