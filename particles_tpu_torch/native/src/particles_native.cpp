// Host helpers of particles_tpu_torch, in C++ behind a plain C ABI.
//
// The port's copy of the JAX package's particles_tpu/native/src/
// particles_native.cpp: the same four functions, the same signatures and
// the same float64 arithmetic in the same order.  They serve the host side
// of the port: resampling.ssp_counts sends the sequential SSP pairing
// below 8192 particles here (one host loop in place of a Python one), and
// the other three are held by the tests against the port's torch
// functions (resampling.inverse_cdf, hilbert.hilbert_index) and a float64
// formula.  Built with g++ at first use by particles_tpu_torch/_build.py
// (-ffp-contract=off: no fused multiply-add, so each line rounds as a
// plain float64 version of its formula does) and loaded with ctypes by
// particles_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cmath>
#include <algorithm>

extern "C" {

// Two-pointer inverse CDF: A[m] = smallest j with cumsum(W)[j] >= su[m].
// su must be sorted ascending; W need not be normalised (we normalise by
// total mass on the fly).  Counterpart of resampling.inverse_cdf.
void pn_inverse_cdf(const double* su, const double* W,
                    int64_t M, int64_t N, int32_t* A) {
    double total = 0.0;
    for (int64_t i = 0; i < N; ++i) total += W[i];
    int64_t j = 0;
    double s = W[0] / total;
    for (int64_t m = 0; m < M; ++m) {
        while (su[m] > s && j < N - 1) {
            ++j;
            s += W[j] / total;
        }
        A[m] = static_cast<int32_t>(j);
    }
}

// Systematic offspring counts: z_i = floor(M*cs_i - u) + 1 (clipped),
// counts = diff(z).  Pure arithmetic; here for completeness of the host API.
void pn_systematic_counts(const double* W, int64_t N, int64_t M,
                          double u, int32_t* counts) {
    double total = 0.0;
    for (int64_t i = 0; i < N; ++i) total += W[i];
    double cs = 0.0;
    int64_t zprev = 0;
    for (int64_t i = 0; i < N; ++i) {
        cs += W[i] / total;
        int64_t z = (int64_t)std::floor((double)M * cs - u) + 1;
        z = std::max<int64_t>(0, std::min<int64_t>(M, z));
        if (i == N - 1) z = M;  // guard rounding at the top
        counts[i] = static_cast<int32_t>(std::max<int64_t>(z - zprev, 0));
        zprev = std::max(z, zprev);
    }
}

// SSP (Srinivasan Sampling Process) offspring counts: the pairwise
// randomised-rounding recursion (Gerber, Chopin & Whiteley 2019), including
// the round-off fix-up.  Sequential by nature — the case for a native host
// kernel.  u has N-1 iid uniforms.  Counterpart of
// resampling._ssp_counts_sequential.
// Returns 0 on success, 1 if the final total had to be force-corrected.
int32_t pn_ssp_counts(const double* W, int64_t N, int64_t M,
                      const double* u, int32_t* counts) {
    double total = 0.0;
    for (int64_t n = 0; n < N; ++n) total += W[n];

    double* xi = new double[N];
    for (int64_t n = 0; n < N; ++n) {
        double mw = (double)M * W[n] / total;
        double fl = std::floor(mw);
        counts[n] = static_cast<int32_t>(fl);
        xi[n] = mw - fl;
    }
    int64_t i = 0, j = 1, k = 0;
    for (k = 0; k < N - 1; ++k) {
        double delta_i = std::min(xi[j], 1.0 - xi[i]);
        double delta_j = std::min(xi[i], 1.0 - xi[j]);
        double sum_delta = delta_i + delta_j;
        double pj = (sum_delta > 0.0) ? delta_i / sum_delta : 0.0;
        if (u[k] < pj) {
            std::swap(i, j);
            delta_i = delta_j;
        }
        if (xi[j] < 1.0 - xi[i]) {
            xi[i] += delta_i;
            j = k + 2;
        } else {
            xi[j] -= delta_i;
            counts[i] += 1;
            i = k + 2;
        }
    }
    int64_t sum = 0;
    for (int64_t n = 0; n < N; ++n) sum += counts[n];
    int64_t last_ij = (j == N) ? i : j;
    if (sum == M - 1 && xi[last_ij] > 0.99) {
        counts[last_ij] += 1;
        sum += 1;
    }
    int32_t rc = 0;
    if (sum != M) {  // cannot throw across the C ABI; force-correct
        counts[last_ij] += static_cast<int32_t>(M - sum);
        rc = 1;
    }
    delete[] xi;
    return rc;
}

// Hilbert index of d-dimensional integer points (Skilling's
// transpose-to-axes), sequential over points but branch-free per bit.
// Counterpart of hilbert.hilbert_index.
// coords: (N*d) row-major, entries < 2^nbits; out: (N,) packed indices
// (d*nbits <= 62).
void pn_hilbert_index(const uint32_t* coords, int64_t N, int32_t d,
                      int32_t nbits, uint64_t* out) {
    uint32_t* X = new uint32_t[d];
    for (int64_t n = 0; n < N; ++n) {
        for (int32_t idx = 0; idx < d; ++idx) X[idx] = coords[n * d + idx];
        // inverse undo
        for (uint32_t Q = 1u << (nbits - 1); Q > 1u; Q >>= 1) {
            uint32_t P = Q - 1;
            for (int32_t idx = 0; idx < d; ++idx) {
                if (X[idx] & Q) {
                    X[0] ^= P;
                } else {
                    uint32_t t = (X[0] ^ X[idx]) & P;
                    X[0] ^= t;
                    X[idx] ^= t;
                }
            }
        }
        // Gray encode
        for (int32_t idx = 1; idx < d; ++idx) X[idx] ^= X[idx - 1];
        uint32_t t = 0;
        for (uint32_t Q = 1u << (nbits - 1); Q > 1u; Q >>= 1)
            if (X[d - 1] & Q) t ^= Q - 1;
        for (int32_t idx = 0; idx < d; ++idx) X[idx] ^= t;
        // interleave bit planes, axis 0 most significant
        uint64_t h = 0;
        for (int32_t b = nbits - 1; b >= 0; --b)
            for (int32_t idx = 0; idx < d; ++idx)
                h = (h << 1) | ((X[idx] >> b) & 1u);
        out[n] = h;
    }
    delete[] X;
}

}  // extern "C"
