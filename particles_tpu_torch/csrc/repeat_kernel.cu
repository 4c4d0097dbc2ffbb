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
// particle for one f32 column, 3.8 us at N = M = 2^20); B4 with ancestors
// only reads su and cs and writes A (16 bytes a particle).
//
// B2 is a merge path (k_merge_serve).  A_j is the number of z entries
// before j in the merge of z with 0, 1, ..., M-1 in which a tie puts z_k
// first, so one pass over the merge serves every j, whatever the counts:
// each block owns kMergeTile consecutive items of the merge (diagonals),
// finds where its slice starts and ends in z by two searches of one warp
// each (32 probes a round, ~5 dependent rounds instead of log2 N), copies
// its slice of z into shared memory, coalesced, and each thread merges
// kMergeItems items serially there, recording A_j for every j it meets.
// Then the block's threads serve consecutive j, so A and the payload rows
// are written coalesced and read near-coalesced (A is nondecreasing).  One
// particle with all M offspring, long runs of zero counts, M < N and
// M = 4N cost the same per item of the merge.  A block is 256 threads of
// 16 items: of the shapes timed on the H100 (128 to 512 threads, 4 to 16
// items, a first search round by the whole block) it was the fastest.
//
// B4 keeps one thread per output finding A_j by a binary search of cs for
// su_j (the queries come in any order; cs, 4 MB at N = 2^20, stays in the
// 50 MB L2).  The TPU kernel's visit plan, z transpose, one-hot select,
// bitcast of su and the sort around an unsorted query stream existed to
// avoid gathers and searches on the TPU; here a gather is a load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // B4: one thread per output
constexpr int kMaxPayloads = 8;
constexpr int kMergeThreads = 256;   // B2: a block's threads
constexpr int kMergeItems = 16;      // items of the merge a thread
constexpr int kMergeTile = kMergeThreads * kMergeItems;

struct Payloads {
  const void* x[kMaxPayloads];
  void* y[kMaxPayloads];
  int64_t width[kMaxPayloads];  // elements per row
  int esize[kMaxPayloads];      // bytes per element: 1, 2, 4 or 8
  int P;
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

// Output j of every payload, and of the ancestors, from row a.
__device__ __forceinline__ void serve(const Payloads& p, int64_t* anc,
                                      int64_t a, int64_t j) {
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

// B4: one thread per output.
__global__ void k_serve_su(BySu search, int64_t N, int64_t M, Payloads p,
                           int64_t* __restrict__ anc) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= M) return;
  int64_t a = search(j);
  if (a > N - 1) a = N - 1;  // reached only off the contract (cs too low)
  serve(p, anc, a, j);
}

// B2's merge.  Item k of z sits at position k + c_k of the merge, with
// c_k = clamp(z_k, 0, M) (the j < z_k come before it), so the number of z
// entries among the first d items is the first a in [lo, hi) with
// a + c_a >= d (hi if none).  One warp finds it: each round its 32 lanes
// probe 32 evenly spaced points and the range shrinks to the gap between
// the last probe below the split and the first at or above it.
__device__ int64_t warp_split(const int32_t* __restrict__ z, int64_t M,
                              int64_t d, int64_t lo, int64_t hi) {
  const int lane = threadIdx.x & 31;
  while (hi > lo) {
    const int64_t n = hi - lo;
    const int64_t step = (n + 31) / 32;
    const int64_t reach = step * (lane + 1) < n ? step * (lane + 1) : n;
    const int64_t pr = lo + reach - 1;
    const int64_t c = min(max(__ldg(z + pr), 0), (int)M);
    const unsigned below = __ballot_sync(0xffffffffu, pr + c < d);
    const int nb = __popc(below);  // the probes below the split come first
    if (nb == 32) return hi;       // the last probe is hi - 1
    const int64_t first = step * (nb + 1) < n ? step * (nb + 1) : n;
    hi = lo + first - 1;           // probe nb: at or above the split
    if (nb > 0) lo += step * nb;   // one past probe nb - 1
  }
  return lo;
}

__global__ void __launch_bounds__(kMergeThreads)
k_merge_serve(const int32_t* __restrict__ z, int64_t N, int64_t M,
              Payloads p, int64_t* __restrict__ anc) {
  __shared__ int32_t sz[kMergeTile];   // c_k of the block's slice of z
  __shared__ int32_t sa[kMergeTile];   // A_j of the block's j (N < 2^31)
  __shared__ int64_t split[2];
  const int64_t total = N + M;
  int64_t d0 = (int64_t)blockIdx.x * kMergeTile;
  d0 = d0 < total ? d0 : total;
  const int64_t d1 = d0 + kMergeTile < total ? d0 + kMergeTile : total;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t d = warp == 0 ? d0 : d1;
    const int64_t a = warp_split(z, M, d, d - M > 0 ? d - M : 0,
                                 d < N ? d : N);
    if ((threadIdx.x & 31) == 0) split[warp] = a;
  }
  __syncthreads();
  const int64_t a0 = split[0], b0 = d0 - a0;
  const int na = (int)(split[1] - a0);
  const int nb = (int)((d1 - split[1]) - b0);
  for (int i = threadIdx.x; i < na; i += kMergeThreads) {
    sz[i] = min(max(__ldg(z + a0 + i), 0), (int)M);
  }
  __syncthreads();

  // this thread's items of the block's merge: [dl, dl + kMergeItems)
  const int n = na + nb;
  const int dl = min((int)threadIdx.x * kMergeItems, n);
  int lo = max(0, dl - nb), hi = min(dl, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((int64_t)sz[mid] <= b0 + (dl - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int a = lo, b = dl - lo;
  const int end = min(dl + kMergeItems, n);
  for (int k = dl; k < end; ++k) {
    if (a < na && (b >= nb || (int64_t)sz[a] <= b0 + b)) {
      ++a;                   // z entry a goes first (ties too)
    } else {
      sa[b++] = (int32_t)(a0 + a);  // A_j for j = b0 + b
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nb; i += kMergeThreads) {
    int64_t a_j = sa[i];
    if (a_j > N - 1) a_j = N - 1;  // reached only off the contract (z too low)
    serve(p, anc, a_j, b0 + i);
  }
}

// Packs the host array desc (P source pointers, P destination pointers, P
// row widths, P element sizes) into a Payloads; false for a P or an
// element size the kernel does not take.
bool pack(int P, const long long* desc, Payloads* p) {
  if (P < 0 || P > kMaxPayloads) return false;
  *p = Payloads{};
  p->P = P;
  for (int q = 0; q < P; ++q) {
    p->x[q] = reinterpret_cast<const void*>(desc[q]);
    p->y[q] = reinterpret_cast<void*>(desc[P + q]);
    p->width[q] = desc[2 * P + q];
    const int e = (int)desc[3 * P + q];
    if (e != 1 && e != 2 && e != 4 && e != 8) return false;
    p->esize[q] = e;
  }
  return true;
}

}  // namespace

extern "C" {

int pt_repeat_max_payloads(void) { return kMaxPayloads; }

// Items of the merge a block of B2 owns.
int pt_repeat_merge_tile(void) { return kMergeTile; }

// B2.  z: (N,) int32 on the device, N < 2^31.  desc: host array of 4 P
// entries (see pack).  anc: (M,) int64 device pointer or null.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a P or an element size
// the kernel does not take.
int pt_repeat_by_z(const void* z, long long N, long long M, int P,
                   const void* desc, void* anc, void* stream) {
  Payloads p;
  if (!pack(P, (const long long*)desc, &p)) return (int)cudaErrorInvalidValue;
  const int64_t nb = (N + M + kMergeTile - 1) / kMergeTile;
  k_merge_serve<<<(unsigned)nb, kMergeThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)z, N, M, p, (int64_t*)anc);
  return (int)cudaGetLastError();
}

// B4.  su: (M,) f32 and cs: (N,) f32 on the device; the rest as for B2.
int pt_repeat_by_su(const void* su, long long M, const void* cs, long long N,
                    int P, const void* desc, void* anc, void* stream) {
  Payloads p;
  if (!pack(P, (const long long*)desc, &p)) return (int)cudaErrorInvalidValue;
  const int64_t nb = (M + kThreads - 1) / kThreads;
  k_serve_su<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      BySu{(const float*)su, (const float*)cs, N}, N, M, p, (int64_t*)anc);
  return (int)cudaGetLastError();
}

}  // extern "C"
