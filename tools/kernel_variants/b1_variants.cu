// Times B1 (csrc/z_kernel.cu, k_fixed_point<ZOut>: one cooperative launch)
// on the card beside its first port, kept here as the baseline: five
// launches (S, scale, block sums of q, their scan, the z pass) that read W
// three times.  Also B3 (k_fixed_point<CsOut>) on the same weights, since
// B1 differs from it only in the epilogue, and the host time to enqueue
// one call of each.  N = 2^20 and 2^24, Dirichlet(1) and degenerate
// weights (one particle takes nearly all), u = 0.37, M = N.  The
// baseline's z is checked against the shipped one before it is timed:
// within 1 elementwise (S is summed in another order), both nondecreasing
// with z[N-1] = M.  Build and run with run.sh.
#include "../../particles_tpu_torch/csrc/z_kernel.cu"
#include "common.cuh"
#include <cstdlib>
#include <string>

namespace five {

constexpr int kThreads = 256;               // threads per streaming block
constexpr int kItems = 4;                   // consecutive elements a thread
constexpr int kTile = kThreads * kItems;    // elements per streaming block
constexpr int kScanThreads = 1024;          // the single-block passes

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
// scal[1] = M / max(Q, 1) in f32.
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

// Pass 2: re-quantise, scan inside the block from the block's prefix, and
// the monotone transform to z.
__global__ void k_z(const float* __restrict__ W, int64_t N, int64_t M,
                    const float* __restrict__ u_ptr,
                    const float* __restrict__ scal,
                    const int64_t* __restrict__ bq, int32_t* __restrict__ z) {
  const float scale = scal[0];
  const float minv = scal[1];
  const float u = *u_ptr;
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  int64_t csq[kItems];
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
    const int64_t i = base + k;
    run += csq[k];
    if (i < N) {
      const float f = __fsub_rn(__fmul_rn(__ll2float_rn(run), minv), u);
      int64_t zi = __float2ll_rd(f) + 1;  // floor, then + 1
      zi = zi < 0 ? 0 : (zi > M ? M : zi);
      if (i == N - 1) zi = M;
      z[i] = (int32_t)zi;
    }
  }
}

// The first port's five launches; part (nb doubles), bq (nb int64) and
// scal (2 floats) are scratch, nb = ceil(N / kTile).
void systematic_z(const float* w, int64_t N, int64_t M, const float* u,
                  int32_t* z, double* part, int64_t* bq, float* scal) {
  const int64_t nb = (N + kTile - 1) / kTile;
  k_wsum<<<(unsigned)nb, kThreads>>>(w, N, part);
  k_scale<<<1, kScanThreads>>>(part, nb, scal);
  k_qsum<<<(unsigned)nb, kThreads>>>(w, N, scal, bq);
  k_scan<<<1, kScanThreads>>>(bq, nb, M, scal);
  k_z<<<(unsigned)nb, kThreads>>>(w, N, M, u, scal, bq, z);
}

}  // namespace five

// The z epilogue in 32 bits: floor(f) + 1 clipped to [0, M] with one
// 32-bit conversion (0 <= f < M: floor(f) < 2^31), M where f >= M (the
// least float >= M), 0 where f < 0 or NaN; z[N-1] = M once a thread.
struct ZOut32 {
  int32_t* z;
  const float* u_ptr;
  int64_t M;
  float minv, u, Mup;

  __device__ __forceinline__ void begin(int64_t Q) {
    minv = __fdiv_rn(__ll2float_rn(M), fmaxf(__ll2float_rn(Q), 1.0f));
    u = __ldg(u_ptr);
    Mup = __ll2float_ru(M);
  }
  __device__ __forceinline__ void store(int64_t i, const int64_t (&csq)[8],
                                        int64_t n, int64_t N) const {
    int32_t out[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const float f = __fsub_rn(__fmul_rn(__ll2float_rn(csq[k]), minv), u);
      out[k] = f >= Mup ? (int32_t)M
                        : (f >= 0.0f ? (int32_t)(__float2uint_rd(f) + 1u) : 0);
    }
    if (n <= kItems) out[n - 1] = n == N - i ? (int32_t)M : out[n - 1];
    pt::store8(z + i, out, n);
  }
};

int g_z32_max_grid[pt::kMaxDevices];

int main() {
  std::mt19937_64 rng(1);
  std::gamma_distribution<double> gam(1.0, 1.0);
  float* u;
  CK(cudaMalloc(&u, 4));
  const float u_host = 0.37f;
  CK(cudaMemcpy(u, &u_host, 4, cudaMemcpyHostToDevice));
  for (int64_t N : {1LL << 20, 1LL << 24}) {
    for (const char* kind : {"dirichlet1", "degenerate"}) {
      std::vector<double> g(N);
      if (std::string(kind) == "dirichlet1") {
        for (auto& x : g) x = gam(rng);
      } else {
        for (auto& x : g) x = 1e-12;
        g[rng() % N] = 1.0;
      }
      double tot = 0;
      for (double x : g) tot += x;
      std::vector<float> h(N);
      for (int64_t i = 0; i < N; ++i) h[i] = (float)(g[i] / tot);
      const int64_t nb = (N + five::kTile - 1) / five::kTile;
      float *W, *cs, *scal;
      int32_t *z, *zb;
      double* part_s;
      int64_t *part, *bq;
      CK(cudaMalloc(&W, N * 4)); CK(cudaMalloc(&cs, N * 4));
      CK(cudaMalloc(&z, N * 4)); CK(cudaMalloc(&zb, N * 4));
      CK(cudaMalloc(&part, 4096 * 8)); CK(cudaMalloc(&part_s, nb * 8));
      CK(cudaMalloc(&bq, nb * 8)); CK(cudaMalloc(&scal, 8));
      CK(cudaMemcpy(W, h.data(), N * 4, cudaMemcpyHostToDevice));
      auto shipped = [&] {
        CK((cudaError_t)pt_systematic_z(W, N, N, u, z, part, 4096, 0));
      };
      auto baseline = [&] {
        five::systematic_z(W, N, N, u, zb, part_s, bq, scal);
      };
      int64_t M32 = N;
      auto z32 = [&] {
        ZOut32 out = {zb, u, M32, 0.0f, 0.0f, 0.0f};
        CK((cudaError_t)launch_fixed_point(
            (const void*)k_fixed_point<ZOut32>, g_z32_max_grid, W, N, out,
            part, 4096, 0));
      };
      auto b3 = [&] {
        CK((cudaError_t)pt_normalised_cumsum(W, N, cs, part, 4096, 0));
      };
      shipped(); baseline(); CK(cudaDeviceSynchronize());
      std::vector<int32_t> hz(N), hb(N);
      CK(cudaMemcpy(hz.data(), z, N * 4, cudaMemcpyDeviceToHost));
      CK(cudaMemcpy(hb.data(), zb, N * 4, cudaMemcpyDeviceToHost));
      long long differ = 0, worst = 0;
      bool mono = hz[N - 1] == N && hb[N - 1] == N;
      for (int64_t i = 0; i < N; ++i) {
        const long long d = std::llabs((long long)hz[i] - hb[i]);
        differ += d != 0;
        worst = d > worst ? d : worst;
        if (i > 0) mono = mono && hz[i] >= hz[i - 1] && hb[i] >= hb[i - 1];
      }
      if (worst > 1 || !mono) {
        printf("{\"error\": \"baseline disagrees\", \"N\": %lld, \"kind\": "
               "\"%s\", \"max_abs_dz\": %lld, \"monotone\": %d}\n",
               (long long)N, kind, worst, (int)mono);
        return 1;
      }
      bool z32_same = true;
      for (int64_t M : {N, 4 * N, (int64_t)INT32_MAX, (int64_t)1}) {
        M32 = M;
        z32();
        CK((cudaError_t)pt_systematic_z(W, N, M, u, z, part, 4096, 0));
        CK(cudaDeviceSynchronize());
        CK(cudaMemcpy(hz.data(), z, N * 4, cudaMemcpyDeviceToHost));
        CK(cudaMemcpy(hb.data(), zb, N * 4, cudaMemcpyDeviceToHost));
        z32_same = z32_same && hb == hz;
      }
      M32 = N;
      printf("{\"N\": %lld, \"weights\": \"%s\", \"max_abs_dz\": %lld, "
             "\"elements_differing\": %lld, \"z32_equal\": %d",
             (long long)N, kind, worst, differ, (int)z32_same);
      printf(", \"z32_one_coop_launch_us\": %.3f", device_us(z32));
      printf(", \"one_coop_launch_us\": %.3f", device_us(shipped));
      printf(", \"five_launches_us\": %.3f", device_us(baseline));
      printf(", \"b3_one_coop_launch_us\": %.3f", device_us(b3));
      printf(", \"host_enqueue_us\": {\"one_coop_launch\": %.3f, "
             "\"five_launches\": %.3f}", host_us(shipped), host_us(baseline));
      printf(", \"bound_us\": %.3f}\n", 8.0 * N / 3.35e12 * 1e6);
      fflush(stdout);
      cudaFree(W); cudaFree(cs); cudaFree(z); cudaFree(zb); cudaFree(part);
      cudaFree(part_s); cudaFree(bq); cudaFree(scal);
    }
  }
  return 0;
}
