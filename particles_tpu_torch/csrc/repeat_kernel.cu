// Resampling move by the z-form on Hopper (sm_90a).
//
// Replaces particles_tpu/ops/repeat_kernel.py::_make_visit_kernel in z-mode
// (launched by _repeat_pallas_n, public functions repeat_with_plan_cols,
// serve_by_z, ancestors_by_z).  For z, the inclusive cumsum of offspring
// counts ((N,) int32, nondecreasing, z[N-1] == M), it serves
//
//   Y_p[j] = X_p[A_j],   A_j = #{k : z_k <= j},   j < M,
//
// for up to kMaxPayloads payloads in one launch, and can also write A
// itself (int64) as the ancestor output.  A payload is rows of `width`
// elements of 1, 2, 4 or 8 bytes, copied as raw bits: any dtype, (N,) or
// (N, d), comes back exact, with no float round trip.
//
// What bounds it: bytes.  It reads z and X and writes Y (12 bytes a
// particle for one f32 column, 12 MB at N = 2^20) plus the binary
// searches' reads of z.  Design: one thread per output finds A_j by an
// upper-bound binary search in z.  Neighbouring threads search
// neighbouring j, so their probes share cache lines, and z (4 MB at
// N = 2^20) stays in the 50 MB L2.  The TPU kernel's visit plan, z
// transpose and one-hot select existed to avoid gathers on the TPU; a
// gather is a plain load here.

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

// #{k < N : z_k <= j}
__device__ __forceinline__ int64_t upper_bound(const int32_t* __restrict__ z,
                                               int64_t N, int64_t j) {
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

template <typename T>
__device__ __forceinline__ void copy_row(const void* x, void* y, int64_t a,
                                         int64_t j, int64_t d) {
  const T* src = static_cast<const T*>(x) + a * d;
  T* dst = static_cast<T*>(y) + j * d;
  for (int64_t c = 0; c < d; ++c) dst[c] = src[c];
}

__global__ void k_repeat(const int32_t* __restrict__ z, int64_t N, int64_t M,
                         Payloads p, int64_t* __restrict__ anc) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= M) return;
  int64_t a = upper_bound(z, N, j);
  if (a > N - 1) a = N - 1;  // only reached if z[N-1] <= j breaks the contract
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

}  // namespace

extern "C" {

int pt_repeat_max_payloads(void) { return kMaxPayloads; }

// z: (N,) int32 on the device.  xs, ys: host arrays of P device pointers;
// width, esize: host arrays of P entries.  anc: (M,) int64 device pointer
// or null.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a P
// or an element size the kernel does not take.
int pt_repeat_by_z(const void* z, long long N, long long M, int P,
                   const void* xs, const void* ys, const void* width,
                   const void* esize, void* anc, void* stream) {
  if (P < 0 || P > kMaxPayloads) return (int)cudaErrorInvalidValue;
  Payloads p = {};
  p.P = P;
  for (int q = 0; q < P; ++q) {
    p.x[q] = static_cast<const void* const*>(xs)[q];
    p.y[q] = static_cast<void* const*>(ys)[q];
    p.width[q] = static_cast<const long long*>(width)[q];
    p.esize[q] = static_cast<const int*>(esize)[q];
    const int e = p.esize[q];
    if (e != 1 && e != 2 && e != 4 && e != 8) return (int)cudaErrorInvalidValue;
  }
  const int64_t nb = (M + kThreads - 1) / kThreads;
  k_repeat<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)z, N, M, p, (int64_t*)anc);
  return (int)cudaGetLastError();
}

}  // extern "C"
