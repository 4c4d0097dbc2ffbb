// Times B3 (csrc/z_kernel.cu, k_fixed_point<CsOut>) on the card beside
// variants of its block size and of its grid barrier (cooperative_groups'
// grid sync, or a barrier on one counter with release/acquire atomics),
// and the floor of an empty cooperative launch with 0 and 2 grid syncs.
// Every variant's output is compared with the kernel's, bit for bit.
// Build and run with run.sh.
#include "../../particles_tpu_torch/csrc/z_kernel.cu"
#include "common.cuh"

namespace {

__device__ __forceinline__ void ra_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int nb = gridDim.x;
    const unsigned int inc = blockIdx.x == 0 ? 0x80000000u - (nb - 1) : 1u;
    unsigned int old, cur;
    asm volatile("atom.add.release.gpu.u32 %0, [%1], %2;" : "=r"(old) : "l"(bar), "r"(inc) : "memory");
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(cur) : "l"(bar) : "memory");
    } while (((old ^ cur) & 0x80000000u) == 0);
  }
  __syncthreads();
}

template <int NT, int MINB, bool RA>
__global__ void __launch_bounds__(NT, MINB)
k_cs_t(const float* __restrict__ W, int64_t N, int64_t chunk, int cached,
       double* part_s, int64_t* part_q, float* __restrict__ cs, unsigned int* bar) {
  constexpr int kI = kItems, kT = NT * kItems;
  extern __shared__ float4 smem4[];
  float* cache = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int G = (int)gridDim.x, b = (int)blockIdx.x, t = (int)threadIdx.x;
  const int64_t start = (int64_t)b * chunk;
  const int64_t len = N - start < chunk ? N - start : chunk;
  const float* w = W + start;
  double s = 0.0;
  for (int64_t base = 0; base < len; base += kT) {
    float v[kI];
#pragma unroll
    for (int k = 0; k < kI; ++k) { const int64_t i = base + k * NT + t; v[k] = i < len ? __ldg(w + i) : 0.0f; }
#pragma unroll
    for (int k = 0; k < kI; ++k) { const int64_t i = base + k * NT + t; if (cached && i < len) cache[i] = v[k]; s += (double)v[k]; }
  }
  double dtot;
  pt::block_exclusive_scan<double, NT>(s, &dtot);
  if (t == 0) part_s[b] = dtot;
  if (RA) ra_barrier(bar); else grid.sync();
  s = 0.0;
  for (int i = t; i < G; i += NT) s += __ldcg(part_s + i);
  pt::block_exclusive_scan<double, NT>(s, &dtot);
  const float scale = __fdiv_rn(1073741824.0f, fmaxf(__double2float_rn(dtot), 1e-37f));
  int64_t sq = 0;
  for (int64_t base = 0; base < len; base += kT) {
#pragma unroll
    for (int k = 0; k < kI; ++k) { const int64_t i = base + k * NT + t; if (i < len) sq += quantise(cached ? cache[i] : __ldg(w + i), scale); }
  }
  int64_t qtot;
  pt::block_exclusive_scan<int64_t, NT>(sq, &qtot);
  if (t == 0) part_q[b] = qtot;
  if (RA) ra_barrier(bar); else grid.sync();
  int64_t before = 0, all = 0;
  for (int i = t; i < G; i += NT) {
    const int64_t v = (int64_t)__ldcg(reinterpret_cast<const long long*>(part_q) + i);
    all += v; if (i < b) before += v;
  }
  int64_t carry, Q;
  pt::block_exclusive_scan<int64_t, NT>(before, &carry);
  pt::block_exclusive_scan<int64_t, NT>(all, &Q);
  const float inv = __fdiv_rn(1.0f, fmaxf(__ll2float_rn(Q), 1.0f));
  const bool vec = (reinterpret_cast<uintptr_t>(cs) & 15) == 0;
  for (int64_t base = 0; base < len; base += kT) {
    const float* src = cache + base;
    if (!cached) {
#pragma unroll
      for (int k = 0; k < kI; ++k) { const int64_t i = base + k * NT + t; if (i < len) cache[k * NT + t] = __ldg(w + i); }
      __syncthreads();
      src = cache;
    }
    const int64_t off = base + (int64_t)t * kI;
    const float4* s4 = reinterpret_cast<const float4*>(src + t * kI);
    const float4 lo = s4[0], hi = s4[1];
    const float v[kI] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    int64_t csq[kI]; int64_t mine = 0;
#pragma unroll
    for (int k = 0; k < kI; ++k) { csq[k] = off + k < len ? quantise(v[k], scale) : 0; mine += csq[k]; }
    int64_t tile_tot;
    int64_t run = carry + pt::block_exclusive_scan<int64_t, NT>(mine, &tile_tot);
    carry += tile_tot;
    float out[kI];
#pragma unroll
    for (int k = 0; k < kI; ++k) { run += csq[k]; out[k] = __fmul_rn(__ll2float_rn(run), inv); }
    float* dst = cs + start + off;
    if (vec && off + kI <= len) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(out[0], out[1], out[2], out[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(out[4], out[5], out[6], out[7]);
    } else {
#pragma unroll
      for (int k = 0; k < kI; ++k) if (off + k < len) dst[k] = out[k];
    }
  }
}

template <int NT, int MINB, bool RA>
struct Variant {
  int gmax, cache_tiles;
  explicit Variant(int cache_bytes) {
    int sms, per_sm;
    CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
    CK(cudaFuncSetAttribute((const void*)k_cs_t<NT, MINB, RA>, cudaFuncAttributeMaxDynamicSharedMemorySize, cache_bytes));
    CK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_cs_t<NT, MINB, RA>, NT, cache_bytes));
    gmax = per_sm * sms;
    cache_tiles = cache_bytes / (NT * kItems * 4);
  }
  cudaError_t launch(const float* W, int64_t N, float* cs, int64_t* part, unsigned int* bar) {
    const int tile = NT * kItems;
    const int64_t per = (N + gmax - 1) / gmax;
    int64_t chunk = (per + tile - 1) / tile * tile;
    const int grid = (int)((N + chunk - 1) / chunk);
    int cached = chunk <= (int64_t)cache_tiles * tile;
    const size_t smem = (size_t)(cached ? chunk : tile) * 4;
    double* ps = (double*)part; int64_t* pq = part + gmax;
    void* args[] = {&W, &N, &chunk, &cached, &ps, &pq, &cs, &bar};
    return cudaLaunchCooperativeKernel((const void*)k_cs_t<NT, MINB, RA>, dim3(grid), dim3(NT), args, smem, 0);
  }
};

__global__ void k_coop_syncs(int nsync) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < nsync; ++i) grid.sync();
}

}  // namespace

int main() {
  Variant<512, 2, false> a(96 * 1024);
  Variant<512, 2, true> b(96 * 1024);
  Variant<256, 4, false> c(48 * 1024);
  Variant<256, 4, true> d(48 * 1024);
  Variant<128, 8, true> e(24 * 1024);
  printf("{\"max_grid\": [%d, %d, %d, %d, %d]}\n", a.gmax, b.gmax, c.gmax, d.gmax, e.gmax);
  std::mt19937_64 rng(1);
  std::gamma_distribution<float> gam(1.0f, 1.0f);
  unsigned int* bar; CK(cudaMalloc(&bar, 4)); CK(cudaMemset(bar, 0, 4));
  for (int64_t N : {1LL << 16, 1LL << 20, 1LL << 22}) {
    std::vector<float> h(N);
    for (auto& x : h) x = gam(rng);
    float *W, *ref, *out; int64_t* part;
    CK(cudaMalloc(&W, N * 4)); CK(cudaMalloc(&ref, N * 4)); CK(cudaMalloc(&out, N * 4));
    CK(cudaMalloc(&part, 2 * 4096 * 8));
    CK(cudaMemcpy(W, h.data(), N * 4, cudaMemcpyHostToDevice));
    std::vector<float> hr(N), ho(N);
    const float v0 = device_us([&] { CK((cudaError_t)pt_normalised_cumsum(W, N, ref, part, 2 * 4096, 0)); });
    CK(cudaMemcpy(hr.data(), ref, N * 4, cudaMemcpyDeviceToHost));
    printf("{\"N\": %lld, \"prod_us\": %.3f", (long long)N, v0);
#define V(tag, var) { float us = device_us([&] { CK(var.launch(W, N, out, part, bar)); }); \
      CK(cudaMemcpy(ho.data(), out, N * 4, cudaMemcpyDeviceToHost)); long long dd = 0; \
      for (int64_t i = 0; i < N; ++i) dd += ho[i] != hr[i]; printf(", \"%s_us\": %.3f, \"%s_differs\": %lld", tag, us, tag, dd); }
    V("t512cg", a); V("t512ra", b); V("t256cg", c); V("t256ra", d); V("t128ra", e);
    for (int nsync : {0, 2}) {
      void* args[] = {&nsync};
      const float us = device_us([&] { CK(cudaLaunchCooperativeKernel(
          (const void*)k_coop_syncs, dim3(a.gmax), dim3(512), args, 0, 0)); });
      printf(", \"empty_coop_%dsync_us\": %.3f", nsync, us);
    }
    printf(", \"bound_us\": %.3f}\n", 8.0 * N / 3.35e12 * 1e6);
    cudaFree(W); cudaFree(ref); cudaFree(out); cudaFree(part);
  }
  return 0;
}
