// Resampling moves on Hopper (sm_90a): by the z-form (B2) and by the
// inverse CDF of uniforms (B4).
//
// B2 replaces particles_tpu/ops/repeat_kernel.py::_make_visit_kernel in
// z-mode (launched by _repeat_pallas_n, plan from make_repeat_plan, public
// functions repeat_with_plan_cols, serve_by_z, ancestors_by_z).  For z, the
// inclusive cumsum of offspring counts ((N,) int32, nondecreasing,
// z[N-1] == M), it serves
//
//   Y_p[j] = X_p[A_j],   A_j = #{k : z_k <= j},   j < M.
//
// B4 replaces the same kernel in su-mode (plan from make_repeat_plan_su).
// For uniforms su ((M,) f32, in any order) and cumulative weights cs ((N,)
// f32, nondecreasing, cs[N-1] >= every su) it serves
//
//   Y_p[j] = X_p[A_j],   A_j = #{i : cs_i < su_j},
//
// that is cs_{A_j - 1} < su_j <= cs_{A_j} (searchsorted side='left').
//
// Both serve up to kMaxPayloads payloads in one launch, and can also write
// A itself (int64) as the ancestor output; A is clipped to N - 1.  A
// payload is rows of `width` elements of 1, 2, 4 or 8 bytes, copied as raw
// bits: any dtype, (N,) or (N, d), comes back exact, with no float round
// trip.
//
// What bounds them: bytes.  B2 reads z and X and writes Y (12 bytes a
// particle for one f32 column, 12 MB at N = 2^20); B4 with ancestors only
// reads su and cs and writes A (16 bytes a particle), plus the binary
// searches' reads.  Design: one thread per output finds A_j by a binary
// search, in z (upper bound of j) or in cs (lower bound of su_j).  For B2
// neighbouring threads search neighbouring j, so their probes share cache
// lines; for B4 the queries may come in any order, and each search's
// probes hit cs (4 MB at N = 2^20) in the 50 MB L2.  The TPU kernel's
// visit plan, z transpose, one-hot select, bitcast of su and the sort
// around an unsorted query stream existed to avoid gathers and searches on
// the TPU; here a search is log2(N) cached loads and a gather is a load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPayloads = 8;

struct Payloads {
  const void* x[kMaxPayloads];
  void* y[kMaxPayloads];
  int64_t width[kMaxPayloads];  // elements per row
  int esize[kMaxPayloads];      // bytes per element: 1, 2, 4 or 8
  int P;
};

// B2's search: #{k < N : z_k <= j}
struct ByZ {
  const int32_t* z;
  int64_t N;
  __device__ __forceinline__ int64_t operator()(int64_t j) const {
    int64_t lo = 0, hi = N;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if ((int64_t)__ldg(z + mid) <= j) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    return lo;
  }
};

// B4's search: #{i < N : cs_i < su_j}
struct BySu {
  const float* su;
  const float* cs;
  int64_t N;
  __device__ __forceinline__ int64_t operator()(int64_t j) const {
    const float s = __ldg(su + j);
    int64_t lo = 0, hi = N;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(cs + mid) < s) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    return lo;
  }
};

template <typename T>
__device__ __forceinline__ void copy_row(const void* x, void* y, int64_t a,
                                         int64_t j, int64_t d) {
  const T* src = static_cast<const T*>(x) + a * d;
  T* dst = static_cast<T*>(y) + j * d;
  for (int64_t c = 0; c < d; ++c) dst[c] = src[c];
}

template <typename Search>
__global__ void k_serve(Search search, int64_t N, int64_t M, Payloads p,
                        int64_t* __restrict__ anc) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= M) return;
  int64_t a = search(j);
  if (a > N - 1) a = N - 1;  // reached only off the contract (z or cs too low)
  for (int q = 0; q < p.P; ++q) {
    switch (p.esize[q]) {
      case 1: copy_row<uint8_t>(p.x[q], p.y[q], a, j, p.width[q]); break;
      case 2: copy_row<uint16_t>(p.x[q], p.y[q], a, j, p.width[q]); break;
      case 4: copy_row<uint32_t>(p.x[q], p.y[q], a, j, p.width[q]); break;
      default: copy_row<uint64_t>(p.x[q], p.y[q], a, j, p.width[q]); break;
    }
  }
  if (anc != nullptr) anc[j] = a;
}

// Packs the host arrays into a Payloads; false for a P or an element size
// the kernel does not take.
bool pack(int P, const void* xs, const void* ys, const void* width,
          const void* esize, Payloads* p) {
  if (P < 0 || P > kMaxPayloads) return false;
  *p = Payloads{};
  p->P = P;
  for (int q = 0; q < P; ++q) {
    p->x[q] = static_cast<const void* const*>(xs)[q];
    p->y[q] = static_cast<void* const*>(ys)[q];
    p->width[q] = static_cast<const long long*>(width)[q];
    p->esize[q] = static_cast<const int*>(esize)[q];
    const int e = p->esize[q];
    if (e != 1 && e != 2 && e != 4 && e != 8) return false;
  }
  return true;
}

template <typename Search>
int launch(Search search, int64_t N, int64_t M, const Payloads& p, void* anc,
           void* stream) {
  const int64_t nb = (M + kThreads - 1) / kThreads;
  k_serve<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      search, N, M, p, (int64_t*)anc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pt_repeat_max_payloads(void) { return kMaxPayloads; }

// B2.  z: (N,) int32 on the device.  xs, ys: host arrays of P device
// pointers; width, esize: host arrays of P entries.  anc: (M,) int64 device
// pointer or null.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a P or an element size the kernel does not take.
int pt_repeat_by_z(const void* z, long long N, long long M, int P,
                   const void* xs, const void* ys, const void* width,
                   const void* esize, void* anc, void* stream) {
  Payloads p;
  if (!pack(P, xs, ys, width, esize, &p)) return (int)cudaErrorInvalidValue;
  return launch(ByZ{(const int32_t*)z, N}, N, M, p, anc, stream);
}

// B4.  su: (M,) f32 and cs: (N,) f32 on the device; the rest as for B2.
int pt_repeat_by_su(const void* su, long long M, const void* cs, long long N,
                    int P, const void* xs, const void* ys, const void* width,
                    const void* esize, void* anc, void* stream) {
  Payloads p;
  if (!pack(P, xs, ys, width, esize, &p)) return (int)cudaErrorInvalidValue;
  return launch(BySu{(const float*)su, (const float*)cs, N}, N, M, p, anc,
                stream);
}

}  // extern "C"
