// Times B2 (csrc/repeat_kernel.cu, k_merge_serve) on the card beside
// variants of its block shape (threads, items a thread, the width of the
// ancestors it keeps in shared memory) and of its split search (a first
// round by the whole block), ancestors only on Dirichlet(1), degenerate and
// M = 4N offspring, and one f32 column.  Every variant's ancestors are
// compared with std::upper_bound's.  Build and run with run.sh.
#include "../../particles_tpu_torch/csrc/repeat_kernel.cu"
#include "common.cuh"
#include <algorithm>
#include <cmath>

namespace {

// the first round of the split search by all NT threads (NT probes), then
// the warp rounds
template <int NT>
__device__ int64_t block_split(const int32_t* __restrict__ z, int64_t M, int64_t d, int64_t lo, int64_t hi, int* s_cnt) {
  const int64_t n = hi - lo;
  if (n > 32) {
    const int64_t step = (n + NT - 1) / NT;
    const int64_t reach = step * (threadIdx.x + 1) < n ? step * (threadIdx.x + 1) : n;
    const int64_t pr = lo + reach - 1;
    const int64_t c = min(max(__ldg(z + pr), 0), (int)M);
    const int below = __syncthreads_count(pr + c < d);
    if (below == NT) return hi;
    const int64_t first = step * (below + 1) < n ? step * (below + 1) : n;
    const int64_t nhi = lo + first - 1;
    if (below > 0) lo += step * below;
    hi = nhi;
  }
  if (threadIdx.x < 32) return warp_split(z, M, d, lo, hi);
  return -1;
}

template <int NT, int NI, bool WIDE, typename SA = int64_t>
__global__ void __launch_bounds__(NT)
k_merge_v(const int32_t* __restrict__ z, int64_t N, int64_t M, Payloads p, int64_t* __restrict__ anc) {
  constexpr int TILE = NT * NI;
  __shared__ int32_t sz[TILE];
  __shared__ SA sa[TILE];
  __shared__ int64_t split[2];
  __shared__ int cnt;
  const int64_t total = N + M;
  int64_t d0 = (int64_t)blockIdx.x * TILE;
  d0 = d0 < total ? d0 : total;
  const int64_t d1 = d0 + TILE < total ? d0 + TILE : total;
  if (WIDE) {
    for (int w = 0; w < 2; ++w) {
      const int64_t d = w == 0 ? d0 : d1;
      const int64_t a = block_split<NT>(z, M, d, d - M > 0 ? d - M : 0, d < N ? d : N, &cnt);
      if (threadIdx.x == 0) split[w] = a;
      __syncthreads();
    }
  } else {
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const int64_t d = warp == 0 ? d0 : d1;
      const int64_t a = warp_split(z, M, d, d - M > 0 ? d - M : 0, d < N ? d : N);
      if ((threadIdx.x & 31) == 0) split[warp] = a;
    }
    __syncthreads();
  }
  const int64_t a0 = split[0], b0 = d0 - a0;
  const int na = (int)(split[1] - a0);
  const int nb = (int)((d1 - split[1]) - b0);
  for (int i = threadIdx.x; i < na; i += NT) sz[i] = min(max(__ldg(z + a0 + i), 0), (int)M);
  __syncthreads();
  const int n = na + nb;
  const int dl = min((int)threadIdx.x * NI, n);
  int lo = max(0, dl - nb), hi = min(dl, na);
  while (lo < hi) { const int mid = (lo + hi) >> 1; if ((int64_t)sz[mid] <= b0 + (dl - 1 - mid)) lo = mid + 1; else hi = mid; }
  int a = lo, b = dl - lo;
  const int end = min(dl + NI, n);
  for (int k = dl; k < end; ++k) {
    if (a < na && (b >= nb || (int64_t)sz[a] <= b0 + b)) ++a; else sa[b++] = a0 + a;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += NT) {
    int64_t a_j = sa[i];
    if (a_j > N - 1) a_j = N - 1;
    serve(p, anc, a_j, b0 + i);
  }
}

template <int NT, int NI, bool WIDE, typename SA = int64_t>
void launch_v(const int32_t* z, int64_t N, int64_t M, const Payloads& p, int64_t* anc) {
  const int64_t nb = (N + M + NT * NI - 1) / (NT * NI);
  k_merge_v<NT, NI, WIDE, SA><<<(unsigned)nb, NT>>>(z, N, M, p, anc);
}

}  // namespace

int main() {
  std::mt19937_64 rng(2);
  std::gamma_distribution<double> gam(1.0, 1.0);
  const int64_t N = 1 << 20;
  for (int kind = 0; kind < 3; ++kind) {
    const int64_t M = kind == 2 ? 4 * N : N;
    std::vector<int32_t> hz(N);
    if (kind == 1) {  // degenerate: one particle takes all
      for (int64_t i = 0; i < N; ++i) hz[i] = i < N / 3 ? 0 : (int32_t)M;
    } else {
      std::vector<double> w(N); double s = 0;
      for (auto& x : w) { x = gam(rng); s += x; }
      double c = 0;
      for (int64_t i = 0; i < N; ++i) { c += w[i]; hz[i] = (int32_t)std::min<double>(M, std::floor(M * c / s + 0.37)); }
      hz[N - 1] = (int32_t)M;
    }
    std::vector<int64_t> ref(M);
    for (int64_t j = 0; j < M; ++j) ref[j] = std::min<int64_t>(std::upper_bound(hz.begin(), hz.end(), (int32_t)j) - hz.begin(), N - 1);
    int32_t* z; int64_t* A; float *x, *y;
    CK(cudaMalloc(&z, N * 4)); CK(cudaMalloc(&A, M * 8)); CK(cudaMalloc(&x, N * 4)); CK(cudaMalloc(&y, M * 4));
    CK(cudaMemcpy(z, hz.data(), N * 4, cudaMemcpyHostToDevice));
    CK(cudaMemset(x, 0, N * 4));
    Payloads none{}; none.P = 0;
    Payloads one{}; one.P = 1; one.x[0] = x; one.y[0] = y; one.width[0] = 1; one.esize[0] = 4;
    const long long desc1[4] = {(long long)x, (long long)y, 1, 4};
    std::vector<int64_t> hA(M);
    auto check = [&]() { CK(cudaDeviceSynchronize()); CK(cudaMemcpy(hA.data(), A, M * 8, cudaMemcpyDeviceToHost));
      int64_t d = 0; for (int64_t j = 0; j < M; ++j) d += hA[j] != ref[j]; CK(cudaMemset(A, 0xff, M * 8)); return (long long)d; };
    const char* names[] = {"dirichlet1", "degenerate", "dirichlet1_M4N"};
    printf("{\"kind\": \"%s\", \"N\": %lld, \"M\": %lld, \"bound_us\": %.3f", names[kind], (long long)N, (long long)M, (4.0 * N + 8.0 * M) / 3.35e12 * 1e6);
#define RUN(tag, expr) { float us = device_us([&] { expr; }); long long d = check(); \
    printf(", \"%s_us\": %.3f, \"%s_differs\": %lld", tag, us, tag, d); }
    RUN("cur", CK((cudaError_t)pt_repeat_by_z(z, N, M, 0, nullptr, A, 0)));
    RUN("t256i8sa64", (launch_v<256, 8, false>(z, N, M, none, A)));
    RUN("t256i8sa64wide", (launch_v<256, 8, true>(z, N, M, none, A)));
    RUN("t256i8", (launch_v<256, 8, false, int32_t>(z, N, M, none, A)));
    RUN("t256i16", (launch_v<256, 16, false, int32_t>(z, N, M, none, A)));
    RUN("t256i16wide", (launch_v<256, 16, true, int32_t>(z, N, M, none, A)));
    RUN("t512i8", (launch_v<512, 8, false, int32_t>(z, N, M, none, A)));
    RUN("t128i8", (launch_v<128, 8, false, int32_t>(z, N, M, none, A)));
    RUN("t128i16", (launch_v<128, 16, false, int32_t>(z, N, M, none, A)));
    RUN("t256i4", (launch_v<256, 4, false, int32_t>(z, N, M, none, A)));
    {
      float us = device_us([&] { CK((cudaError_t)pt_repeat_by_z(z, N, M, 1, desc1, nullptr, 0)); });
      printf(", \"one_col_cur_us\": %.3f", us);
      us = device_us([&] { launch_v<256, 8, false>(z, N, M, one, nullptr); });
      printf(", \"one_col_t256i8sa64_us\": %.3f", us);
    }
    printf("}\n");
    cudaFree(z); cudaFree(A); cudaFree(x); cudaFree(y);
  }
  return 0;
}
