// Times B6 (csrc/cummax_kernel.cu, k_running_max: one cooperative launch,
// one grid barrier) on the card beside its first port, kept here as the
// baseline: three launches (each block's maximum, a one-block scan of the
// maxima, each block's scan from its prefix), and the host time to enqueue
// one call of each.  N = 2^20 and 2^24, int32 over the whole range and a
// descending input.  Each output is checked against std::max's running
// maximum on the host before it is timed.  Build and run with run.sh.
#include "../../particles_tpu_torch/csrc/cummax_kernel.cu"
#include "common.cuh"
#include <algorithm>

namespace three {

constexpr int kThreads = 256;               // threads per streaming block
constexpr int kItems = 4;                   // consecutive elements a thread
constexpr int kTile = kThreads * kItems;    // elements per streaming block
constexpr int kScanThreads = 1024;          // the single-block pass

// Pass 0: each block's maximum.
__global__ void k_block_max(const int32_t* __restrict__ z, int64_t N,
                            int32_t* __restrict__ bmax) {
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  int32_t m = INT_MIN;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < N) m = max(m, z[i]);
  }
  int32_t tot;
  pt::block_exclusive_scan<int32_t, kThreads>(m, INT_MIN, pt::Max(), &tot);
  if (threadIdx.x == 0) bmax[blockIdx.x] = tot;
}

// One block: exclusive max-scan of the block maxima, in place.
__global__ void k_scan_max(int32_t* __restrict__ bmax, int64_t nb) {
  int32_t carry = INT_MIN;
  for (int64_t c = 0; c < nb; c += kScanThreads) {
    const int64_t i = c + threadIdx.x;
    const int32_t v = i < nb ? bmax[i] : INT_MIN;
    int32_t tot;
    const int32_t ex = pt::block_exclusive_scan<int32_t, kScanThreads>(
        v, INT_MIN, pt::Max(), &tot);
    if (i < nb) bmax[i] = max(carry, ex);
    carry = max(carry, tot);
  }
}

// Pass 1: scan inside the block from the block's prefix.
__global__ void k_apply(const int32_t* __restrict__ z, int64_t N,
                        const int32_t* __restrict__ bmax,
                        int32_t* __restrict__ y) {
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  int32_t v[kItems];
  int32_t m = INT_MIN;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    v[k] = i < N ? z[i] : INT_MIN;
    m = max(m, v[k]);
  }
  int32_t tot;
  int32_t run = max(bmax[blockIdx.x],
                    pt::block_exclusive_scan<int32_t, kThreads>(
                        m, INT_MIN, pt::Max(), &tot));
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    run = max(run, v[k]);
    if (i < N) y[i] = run;
  }
}

// The first port's three launches; bmax (ceil(N / kTile) int32) is scratch.
void running_max(const int32_t* z, int64_t N, int32_t* y, int32_t* bmax) {
  const int64_t nb = (N + kTile - 1) / kTile;
  k_block_max<<<(unsigned)nb, kThreads>>>(z, N, bmax);
  k_scan_max<<<1, kScanThreads>>>(bmax, nb);
  k_apply<<<(unsigned)nb, kThreads>>>(z, N, bmax, y);
}

}  // namespace three

int main() {
  std::mt19937_64 rng(1);
  for (int64_t N : {1LL << 20, 1LL << 24}) {
    for (int descending = 0; descending < 2; ++descending) {
      std::vector<int32_t> h(N), want(N), got(N);
      for (int64_t i = 0; i < N; ++i) {
        const int64_t down = (int64_t)(4294967295.0 * i / N);
        h[i] = descending ? (int32_t)(INT_MAX - down) : (int32_t)(uint32_t)rng();
        want[i] = i ? std::max(want[i - 1], h[i]) : h[i];
      }
      const int64_t nb = (N + three::kTile - 1) / three::kTile;
      int32_t *z, *y, *yb, *part, *bmax;
      CK(cudaMalloc(&z, N * 4)); CK(cudaMalloc(&y, N * 4));
      CK(cudaMalloc(&yb, N * 4)); CK(cudaMalloc(&part, 4096 * 4));
      CK(cudaMalloc(&bmax, nb * 4));
      CK(cudaMemcpy(z, h.data(), N * 4, cudaMemcpyHostToDevice));
      auto shipped = [&] {
        CK((cudaError_t)pt_running_max(z, N, y, part, 4096, 0));
      };
      auto baseline = [&] { three::running_max(z, N, yb, bmax); };
      shipped(); baseline(); CK(cudaDeviceSynchronize());
      for (int32_t* out : {y, yb}) {
        CK(cudaMemcpy(got.data(), out, N * 4, cudaMemcpyDeviceToHost));
        if (got != want) {
          printf("{\"error\": \"%s differs from the running max\", \"N\": "
                 "%lld}\n", out == y ? "shipped" : "baseline", (long long)N);
          return 1;
        }
      }
      printf("{\"N\": %lld, \"input\": \"%s\"", (long long)N,
             descending ? "descending" : "whole_range");
      printf(", \"one_coop_launch_us\": %.3f", device_us(shipped));
      printf(", \"three_launches_us\": %.3f", device_us(baseline));
      printf(", \"host_enqueue_us\": {\"one_coop_launch\": %.3f, "
             "\"three_launches\": %.3f}", host_us(shipped), host_us(baseline));
      printf(", \"bound_us\": %.3f}\n", 8.0 * N / 3.35e12 * 1e6);
      fflush(stdout);
      cudaFree(z); cudaFree(y); cudaFree(yb); cudaFree(part); cudaFree(bmax);
    }
  }
  return 0;
}
