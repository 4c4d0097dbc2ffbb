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
// f32, nondecreasing, any range) it serves
//
//   Y_p[j] = X_p[A_j],   A_j = min(#{i : cs_i < su_j}, N - 1),
//
// that is cs_{A_j - 1} < su_j <= cs_{A_j} (searchsorted side='left').
//
// Both serve up to kMaxPayloads payloads in one launch, and can also write
// A itself (int64) as the ancestor output; A is clipped to N - 1.  A
// payload is rows of `width` elements of 1, 2, 4 or 8 bytes, copied as raw
// bits: any dtype, (N,) or (N, d), comes back exact, with no float round
// trip.
//
// Their byte bounds: B2 reads z and X and writes Y (12 bytes a particle for
// one f32 column, 3.8 us at N = M = 2^20); B4 with ancestors only reads su
// and cs and writes A (16 bytes a particle, 5.0 us).
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
// B4 is a cutpoint (guide) table, Chen and Asau's method for the inverse
// CDF.  The queries come in any order, so the first port's binary search
// of all of cs for each one made ~10 random loads a query below the levels
// that stay in L1, and a random load is what a query costs on this card
// (each divergent warp load is up to 32 separate L2 requests).  With a
// bucket function f(x) = clamp(floor(x s), 0, K - 1), K a power of two
// (N/8 by default, ops.guide_buckets) and s = K / cs[N-1]:
//
//   1. k_guide_build writes, for each bucket b < K, the 16-byte entry
//      {G[b], G[b+1], cs[G[b]], cs[G[b]+1]}, G[b] = #{i : f(cs_i) < b}.
//      A lane a bucket: it takes the least float t_b with f(t_b) >= b (b / s
//      moved by an ulp or two) and counts the cs below t_b by a branch-free
//      search in radix 4 (11 rounds of three independent loads at 2^20); it
//      takes G[b+1] from the next lane, so a warp writes 31 entries as one
//      contiguous run.  Neighbouring lanes search for neighbouring
//      thresholds, so a round's loads share their sectors; on a degenerate
//      CDF every search takes the same path.  It stores s after the table.
//   2. k_serve_guide: one thread a query loads the entry of f(su_j), one
//      16-byte load.  An empty range, or cs[G[b]] >= su_j, gives G[b]; one
//      entry, or cs[G[b]+1] >= su_j, gives G[b] + 1; else cs[G[b]+2, G[b+1])
//      is binary-searched (about 8 entries on Dirichlet(1) weights at K =
//      N/8, none on the filter's degenerate ones).
//
// The result is exact for any f that is monotone and computed the same way
// in both launches: cs_i >= u gives f(cs_i) >= f(u), so G[f(u)] <= A, and
// cs_i < u gives f(cs_i) <= f(u), so A <= G[f(u) + 1].  The build counts
// by thresholds, which is the same G: for 1 <= b < K, f(x) >= b exactly
// when RN(x s) >= b (K <= 2^24, so b is an exact float), a monotone test.
// A bad scale costs only speed: where s is not a positive finite float
// (cs[N-1] <= 0, too small or not finite) s = 0, f is constant, G[b] = N
// for every b >= 1, and every query searches all of cs.  f multiplies with
// __fmul_rn and floors by comparisons and __float2int_rd, so that nvcc
// cannot contract it differently in the two launches; the serve reads the
// s that the build stored.
//
// What bounds B4 now: the random 16-byte load of each query's entry (the
// serve alone on a degenerate CDF, where it reads no cs, is ~2.7x the byte
// bound) and the build's latency (11 dependent rounds a lane).  K trades
// them: a larger K shortens the searches of the serve and lengthens the
// build; tools/kernel_variants/b4_variants.cu times K = N/8 to 2N, the
// build's other shapes, one cooperative launch against two, the first
// port and a two-level search.

// The TPU kernel's visit plan, z transpose, one-hot select, bitcast of su
// and the sort around an unsorted query stream existed to avoid gathers
// and searches on the TPU; here a gather is a load.

#include <cfloat>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // B4: a block's threads
constexpr int kGuideRadix = 4;       // B4: the build's search radix
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

// B4's bucket scale: K / cs[N-1], or 0 (f constant) where that is not a
// positive finite float.
__device__ __forceinline__ float guide_scale(const float* __restrict__ cs,
                                             int N, int K) {
  const float s = __fdiv_rn((float)K, __ldg(cs + N - 1));
  return s > 0.0f && s <= FLT_MAX ? s : 0.0f;
}

// B4's bucket of x: clamp(floor(x s), 0, K - 1), with 0 for a NaN product
// (an infinite x at s = 0).  Monotone in x for every s >= 0.
__device__ __forceinline__ int guide_bucket(float x, float s, int K) {
  const float v = __fmul_rn(x, s);
  if (!(v > 0.0f)) return 0;
  if (v >= (float)K) return K - 1;
  return __float2int_rd(v);
}

// The least float t with f(t) >= b, for b in [1, K - 1] and s > 0: there
// f(x) >= b exactly when RN(x s) >= b (b <= 2^24 is an exact float), which
// is monotone in x.  t starts at b / s, within an ulp or two of it, and
// moves by ulps.
__device__ __forceinline__ float guide_threshold(int b, float s) {
  const float fb = (float)b;
  float t = __fdiv_rn(fb, s);
  if (__fmul_rn(t, s) >= fb) {
    for (float d = nextafterf(t, -INFINITY); __fmul_rn(d, s) >= fb;
         d = nextafterf(d, -INFINITY)) {
      t = d;
    }
  } else {
    do {
      t = nextafterf(t, INFINITY);
    } while (!(__fmul_rn(t, s) >= fb));
  }
  return t;
}

// #{i < N : cs_i < t} by a branch-free search in radix R: the count grows
// by each power of R, largest first, by as many steps as the R - 1 probes
// above it find entries < t (those probes are a prefix: cs is
// nondecreasing).  A round's R - 1 loads are independent, so 2^20 entries
// take 11 dependent rounds at R = 4 instead of 21 at R = 2.
template <int R>
__device__ __forceinline__ int count_below(const float* __restrict__ cs,
                                           int N, float t) {
  int64_t step = 1;
  while (step * R <= N) step *= R;
  int64_t pos = 0;
  for (; step > 0; step /= R) {
    int c = 0;
#pragma unroll
    for (int j = 1; j < R; ++j) {
      const int64_t p = pos + step * j;
      c += p <= N && __ldg(cs + p - 1) < t;
    }
    pos += step * c;
  }
  return (int)pos;
}

// G[b] = #{i : f(cs_i) < b}: 0 for b = 0, N for b >= K or s = 0 (f is 0
// everywhere), else #{i : cs_i < t_b}.
template <int R>
__device__ __forceinline__ int guide_count(const float* __restrict__ cs,
                                           int N, int64_t b, float s, int K) {
  if (b == 0) return 0;
  if (b >= K || s == 0.0f) return N;
  return count_below<R>(cs, N, guide_threshold((int)b, s));
}

// B4, launch 1: for each bucket b < K the entry {G[b], G[b+1], cs[G[b]],
// cs[G[b] + 1]} (indices clamped to N - 1 for the loads), and s in *s_out.
// Warp w owns the 31 buckets [31 w, 31 w + 31): lane l counts G[31 w + l]
// (radix kGuideRadix) and takes G[b + 1] from lane l + 1, so every lane
// counts once and the warp writes its 31 entries as 496 contiguous bytes.
// Neighbouring lanes search for neighbouring thresholds, so a round's
// loads share their sectors (on one particle with all the weight, every
// search takes the same path).
__global__ void __launch_bounds__(kThreads)
k_guide_build(const float* __restrict__ cs, int N, int K,
              int4* __restrict__ E, float* __restrict__ s_out) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int64_t b = (t >> 5) * 31 + lane;
  const float s = guide_scale(cs, N, K);
  if (t == 0) *s_out = s;
  if (b - lane >= K) return;         // the whole warp
  const int g = guide_count<kGuideRadix>(cs, N, b, s, K);
  const int g1 = __shfl_down_sync(0xffffffffu, g, 1);
  if (lane < 31 && b < K) {
    const float c0 = __ldg(cs + (g < N ? g : N - 1));
    const float c1 = __ldg(cs + (g + 1 < N ? g + 1 : N - 1));
    E[b] = make_int4(g, g1, __float_as_int(c0), __float_as_int(c1));
  }
}

// B4, launch 2: one thread per output.  A_j = #{i : cs_i < su_j} lies in
// [lo, hi] of the entry of b = f(su_j); the entry's two cs settle it when
// the range holds at most two, else cs[lo + 2, hi) is searched.
__global__ void __launch_bounds__(kThreads)
k_serve_guide(const float* __restrict__ su, const float* __restrict__ cs,
              int N, int64_t M, const int4* __restrict__ E,
              const float* __restrict__ s_in, int K, Payloads p,
              int64_t* __restrict__ anc) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= M) return;
  const float u = __ldg(su + j);
  const int4 e = __ldg(E + guide_bucket(u, __ldg(s_in), K));
  int a;
  if (e.x == e.y || !(__int_as_float(e.z) < u)) {
    a = e.x;
  } else if (e.y - e.x == 1 || !(__int_as_float(e.w) < u)) {
    a = e.x + 1;
  } else {
    int lo = e.x + 2, hi = e.y;
    while (lo < hi) {
      const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
      if (__ldg(cs + mid) < u) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    a = lo;
  }
  if (a > N - 1) a = N - 1;  // every cs_i < su_j
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

// B4.  su: (M,) f32 and cs: (N,) f32 on the device, N < 2^31; guide: 4 K +
// 1 int32 words of scratch, 16-byte aligned (the K entries, then s), K in
// [1, 2^24].  With build != 0 the call first builds the guide (two
// launches), else it serves from the guide an earlier call built on the
// same cs and K (one launch).  The rest as for B2.
int pt_repeat_by_su(const void* su, long long M, const void* cs, long long N,
                    void* guide, long long K, int build, int P,
                    const void* desc, void* anc, void* stream) {
  Payloads p;
  if (!pack(P, (const long long*)desc, &p)) return (int)cudaErrorInvalidValue;
  if (K < 1 || K > (1LL << 24) || N < 1 || N >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  int4* E = (int4*)guide;
  float* s = (float*)(E + K);
  if (build) {
    const int64_t threads = (K + 30) / 31 * 32;   // a warp per 31 buckets
    k_guide_build<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads,
                    0, st>>>((const float*)cs, (int)N, (int)K, E, s);
  }
  const int64_t nb = (M + kThreads - 1) / kThreads;
  k_serve_guide<<<(unsigned)nb, kThreads, 0, st>>>(
      (const float*)su, (const float*)cs, (int)N, M, E, s, (int)K, p,
      (int64_t*)anc);
  return (int)cudaGetLastError();
}

}  // extern "C"
