"""Log-space weight numerics and resampling schemes (PyTorch port).

Counterpart of ``particles_tpu/resampling.py``: the numerics
(``exp_and_normalise``, ``essl``, ``log_sum_exp``, ``log_sum_exp_ab``,
``log_mean_exp``), the weighted moments and quantiles (``wmean_and_var``,
``wmean_and_cov``, ``wquantiles`` and their dict forms), the
:class:`Weights` container, and every resampling scheme of the JAX
package — ``multinomial``, ``residual``, ``stratified``, ``systematic``,
``ssp``, ``killing``, ``idiotic`` — in three registries selected by name:
ancestors (``rs_funcs``), offspring counts (``rs_counts_funcs``) and
z-forms (``rs_z_funcs``), plus ``multinomial_iid`` and
``MultinomialQueue``.

Randomness is an explicit ``torch.Generator`` where the JAX package takes
a key: ``resampling(scheme, gen, W, M)``.  Ancestor indices are int64
(the JAX package's are int32).

The kernels of :mod:`particles_tpu_torch.ops` carry the schemes: B1 the
systematic z-form, B3 the monotone CDF of every other inverse-CDF scheme,
B5 the merge of sorted uniforms with it, B4 the inverse-CDF serve of
unsorted uniforms (``multinomial_iid``), B2 the move by z.  No scheme
reads a device value on the host, except the sequential SSP below
``_SSP_BLOCKED_MIN``, a host loop in C++ (``native.ssp_counts``) as in
the JAX package.

Under a :mod:`particles_tpu_torch.distctx` context the reductions of
:class:`Weights`, ``log_mean_exp``, ``wmean_and_var`` and
``wmean_and_cov`` run over every rank's slice of the particles
(:mod:`particles_tpu_torch.parallel.comm`).
"""

from __future__ import annotations

import math

import torch

from particles_tpu_torch import distctx, native, tracing
from particles_tpu_torch.ops import (
    ancestors_by_su,
    ancestors_by_z,
    merge_rank_counts,
    normalised_cumsum_exact,
    repeat_cols_su,
    running_max,
    systematic_z_fused,
)
from particles_tpu_torch.parallel import comm

__all__ = [
    "Weights",
    "exp_and_normalise",
    "essl",
    "log_sum_exp",
    "log_sum_exp_ab",
    "log_mean_exp",
    "wmean_and_var",
    "wmean_and_cov",
    "wmean_and_var_str_array",
    "wquantiles",
    "wquantiles_str_array",
    "resampling",
    "resampling_scheme",
    "resampling_counts",
    "resampling_z",
    "rs_funcs",
    "rs_counts_funcs",
    "rs_z_funcs",
    "inverse_cdf",
    "uniform_spacings",
    "counts_to_ancestors",
    "multinomial",
    "multinomial_iid",
    "multinomial_iid_values",
    "multinomial_once",
    "stratified",
    "systematic",
    "residual",
    "ssp",
    "killing",
    "idiotic",
    "MultinomialQueue",
]


# ---------------------------------------------------------------------------
# log-space numerics
# ---------------------------------------------------------------------------

def exp_and_normalise(lw):
    """Exponentiate then normalise log-weights, robustly."""
    w = torch.exp(lw - lw.max())
    return w / w.sum()


def essl(lw):
    """ESS (effective sample size) of log-weights."""
    W = exp_and_normalise(lw)
    return 1.0 / (W * W).sum()


def log_sum_exp(v):
    """log(sum(exp(v))), numerically stable."""
    m = v.max()
    return m + torch.log(torch.exp(v - m).sum())


def log_sum_exp_ab(la, lb):
    """log(exp(la) + exp(lb)), elementwise."""
    la, lb = torch.as_tensor(la), torch.as_tensor(lb)
    big = torch.maximum(la, lb)
    small = torch.minimum(la, lb)
    return big + torch.log1p(torch.exp(small - big))


def _dist_max(v):
    """The maximum of ``v``; under a :mod:`particles_tpu_torch.distctx`
    context, over every rank's slice (one all-reduce)."""
    ctx = distctx.current()
    m = v.max()
    return m if ctx is None else comm.pmax(m, ctx.group)


def _dist_sum(*sums):
    """Values already summed over the local particles; under a context,
    summed over the ranks too, all in one all-reduce.  One value in, one
    out; several in, a tuple out."""
    ctx = distctx.current()
    if ctx is not None:
        sums = comm.psum(*sums, group=ctx.group)
    return sums[0] if len(sums) == 1 else tuple(sums)


def log_mean_exp(v, W=None, lw=None):
    """log of the (possibly weighted) average of exp(v).

    Pass ``lw`` (unnormalised log-weights) instead of ``W`` when available:
    a normalised f32 ``W`` has already lost every particle whose weight
    underflowed (lw spread > ~88).  The weighted forms are stabilised by
    ``max(v + log w)``, not ``max(v)``: in f32 the max-v particle can carry
    almost no weight, and then every term underflows.

    Under a :mod:`particles_tpu_torch.distctx` context, ``v`` (and ``W`` or
    ``lw``) are the rank's slices and the average is over every rank's.
    """
    ctx = distctx.current()
    if W is None and lw is None:
        m = _dist_max(v)
        n = v.shape[0] * (1 if ctx is None else ctx.D)
        return m + torch.log(_dist_sum(torch.exp(v - m).sum()) / n)
    s = v + (torch.log(W) if lw is None else lw)
    m = _dist_max(s)
    out = m + torch.log(_dist_sum(torch.exp(s - m).sum()))
    if lw is None:
        return out
    ml = _dist_max(lw)
    return out - (ml + torch.log(_dist_sum(torch.exp(lw - ml).sum())))


def wmean_and_var(W, x):
    """Weighted mean and variance along the particle axis (axis 0):
    ``{'mean': m, 'var': v}``.  Under a context, ``W`` (the slice of
    globally normalised weights) and ``x`` are the rank's slices and the
    moments are global (one all-reduce)."""
    Wc = W.reshape((-1,) + (1,) * (x.ndim - 1))
    m, m2 = _dist_sum((Wc * x).sum(0), (Wc * x * x).sum(0))
    return {"mean": m, "var": m2 - m * m}


def wmean_and_cov(W, x):
    """Weighted mean and covariance of (N, d) particles: ``(m, cov)``
    (global under a context, as :func:`wmean_and_var`)."""
    m = _dist_sum((W[:, None] * x).sum(0))
    xc = x - m
    return m, _dist_sum(torch.einsum("n,ni,nj->ij", W, xc, xc))


def wmean_and_var_str_array(W, x):
    """Weighted mean and variance of each field of dict particles:
    ``{'mean': {field: m}, 'var': {field: v}}``."""
    moments = {k: wmean_and_var(W, v) for k, v in x.items()}
    return {"mean": {k: mv["mean"] for k, mv in moments.items()},
            "var": {k: mv["var"] for k, mv in moments.items()}}


def _wquantiles_1d(W, x, alphas):
    order = torch.argsort(x)
    cs = torch.cumsum(W[order], 0)
    cs = cs / cs[-1]
    a = torch.as_tensor(alphas, dtype=cs.dtype, device=cs.device)
    idx = torch.searchsorted(cs, a).clamp_(max=x.shape[0] - 1)
    return x[order[idx]]


def wquantiles(W, x, alphas=(0.25, 0.50, 0.75)):
    """Weighted quantiles of (N,) particles, or of each column of (N, d)
    particles ((len(alphas), d)): the smallest x whose weighted CDF
    reaches alpha."""
    if x.ndim == 1:
        return _wquantiles_1d(W, x, alphas)
    return torch.stack([_wquantiles_1d(W, x[:, j], alphas)
                        for j in range(x.shape[1])], 1)


def wquantiles_str_array(W, x, alphas=(0.25, 0.50, 0.75)):
    """Weighted quantiles of each field of dict particles."""
    return {k: wquantiles(W, v, alphas) for k, v in x.items()}


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

class Weights:
    """N log-weights and what derives from them: normalised weights ``W``,
    effective sample size ``ESS`` and ``log_mean``, the log of the average
    unnormalised weight.  NaN log-weights count as -inf.  ``Weights()``
    (no argument) stands for equal weights.  Under a
    :mod:`particles_tpu_torch.distctx` context ``lw`` is the rank's slice,
    ``W`` its slice of the globally normalised weights, and ``ESS`` and
    ``log_mean`` are global (the same on every rank).
    """

    __slots__ = ("lw", "W", "ESS", "log_mean")

    def __init__(self, lw=None):
        self.lw = lw
        if lw is None:
            self.W = self.ESS = self.log_mean = None
            return
        with tracing.span("weights"):
            lw = torch.nan_to_num(lw, nan=-torch.inf, posinf=torch.inf,
                                  neginf=-torch.inf)
            self.lw = lw
            ctx = distctx.current()
            m = _dist_max(lw)
            w = torch.exp(lw - m)
            if ctx is None:
                s = w.sum()
                self.log_mean = m + torch.log(s / lw.shape[0])
                self.W = w / s
                self.ESS = 1.0 / (self.W * self.W).sum()
            else:
                # lw is the rank's slice; W is its slice of the globally
                # normalised weights, ESS and log_mean are global: one max and
                # one fused pair of sums over the ranks
                s, s2 = _dist_sum(w.sum(), (w * w).sum())
                self.log_mean = m + torch.log(s / (lw.shape[0] * ctx.D))
                self.W = w / s
                self.ESS = s * s / s2

    @property
    def N(self):
        return 0 if self.lw is None else self.lw.shape[0]

    def add(self, delta):
        """New Weights with lw incremented by ``delta``."""
        if self.lw is None:
            return Weights(lw=delta)
        return Weights(lw=self.lw + delta)


# ---------------------------------------------------------------------------
# numerics of the inverse CDF
# ---------------------------------------------------------------------------

def inverse_cdf(su, W):
    """Ancestors by the inverse CDF of ``W`` at the uniforms ``su``: the
    smallest i with ``cumsum(W)[i] >= su_j`` (int64), clipped to N - 1."""
    cs = torch.cumsum(W, 0)
    return torch.searchsorted(cs, su).clamp_(max=W.shape[0] - 1)


def _monotone_nonnegative(v):
    """The running max of float32 ``v >= 0``, by B6 on its bit patterns (a
    nonnegative float's int32 bits order as its value): one launch, which
    changes nothing on ``v`` already in order."""
    return running_max(v.view(torch.int32)).view(torch.float32)


def _sorted_cumsum(E):
    """The cumulative sums of the nonnegative ``E``, nondecreasing by
    construction: a float cumsum on the card can leave neighbours an ulp
    out of order (ROADMAP C.13), and B5 takes sorted uniforms."""
    return _monotone_nonnegative(torch.cumsum(E, 0))


def uniform_spacings(gen, N):
    """N sorted uniforms in O(N): normalised cumulative sums of N + 1
    exponentials, drawn on the generator's device (sorted by
    construction: :func:`_sorted_cumsum`, B6)."""
    E = torch.empty(N + 1, device=gen.device).exponential_(generator=gen)
    z = _sorted_cumsum(E)
    return z[:-1] / z[-1]


def multinomial_once(gen, W):
    """A single draw from the categorical distribution W (a 0-d int64
    tensor on W's device)."""
    u = torch.rand(1, generator=gen, device=W.device)
    cs = torch.cumsum(W, 0)
    return torch.searchsorted(cs, u).clamp_(max=W.shape[0] - 1)[0]


def _normalised_cumsum_mono(W):
    """Normalised cumulative weights plus a flag saying the result is
    monotone by construction.  In the port it always is: B3 takes every N
    (the JAX package falls back to a float cumsum off the TPU, and then
    its callers apply :func:`_monotone_z`)."""
    return normalised_cumsum_exact(W), True


def _merge_rank_counts(su, cs, M):
    """z_i = #{j: su_j <= cs_i} for sorted su, clipped to [0, M] (B5)."""
    return merge_rank_counts(su, cs, M)


def _monotone_z(z):
    """Enforce the nondecreasing z contract by a running max (B6)."""
    return running_max(z)


def _diff(z):
    return torch.diff(z, prepend=z.new_zeros(1))


# ---------------------------------------------------------------------------
# z-forms and offspring counts (sorted-ancestor schemes)
# ---------------------------------------------------------------------------
#
# A sorted-ancestor scheme is its z-form: z = cumsum(counts), (N,) int32,
# nondecreasing, z[-1] == M, and the move is Y[j] = X[#{k: z_k <= j}] (B2).

def systematic_z(gen, W, M=None):
    """Systematic z-form: ``z_i = #{j: (j + u)/M <= cs_i}``, computed by
    the fixed-point kernel (:func:`particles_tpu_torch.ops.
    systematic_z_fused`); one uniform ``u`` drawn from ``gen``."""
    M = W.shape[0] if M is None else M
    u = torch.rand((), generator=gen, device=W.device, dtype=torch.float32)
    return systematic_z_fused(W, u, M)


def _stratified_z_of(u, W, M):
    """Stratified z-form for the uniforms ``u`` ((M,)): z_i = k_i +
    1[u_{k_i} <= frac_i], k_i = floor(M cs_i)."""
    cs, cs_mono = _normalised_cumsum_mono(W)
    g = cs * M
    k = torch.floor(g).to(torch.int32)
    frac = g - k
    uk = u.index_select(0, k.clamp(0, M - 1))
    z = torch.where(k >= M, M, k + (uk <= frac).to(torch.int32))
    z = z.clamp_(0, M)
    z[-1:].fill_(M)   # a kernel argument: no host-to-device copy, no sync
    # monotone cs => monotone z: either k is equal (frac nondecreasing, so
    # the shared-u indicator is nondecreasing) or k_{i+1} > k_i
    return z if cs_mono else _monotone_z(z)


def stratified_z(gen, W, M=None):
    """Stratified z-form: ``z_i = #{j: (j + u_j)/M <= cs_i}`` (B3)."""
    M = W.shape[0] if M is None else M
    return _stratified_z_of(torch.rand(M, generator=gen, device=W.device),
                            W, M)


def _multinomial_z_of(su, W, M):
    """Multinomial z-form for the sorted uniforms ``su`` ((M,))."""
    cs, cs_mono = _normalised_cumsum_mono(W)
    z = _merge_rank_counts(su, cs, M)
    z[-1:].fill_(M)
    # z_i = #{j: su_j <= cs_i} is monotone in i whenever cs is
    return z if cs_mono else _monotone_z(z)


def multinomial_z(gen, W, M=None):
    """Multinomial z-form ~ Multinomial(M, W): sorted uniforms (spacings,
    B6) merged against the monotone CDF (B3, B5)."""
    M = W.shape[0] if M is None else M
    return _multinomial_z_of(uniform_spacings(gen, M), W, M)


def systematic_counts(gen, W, M=None):
    """Systematic offspring counts = diff of the z-form."""
    return _diff(systematic_z(gen, W, M))


def stratified_counts(gen, W, M=None):
    """Stratified offspring counts = diff of the z-form."""
    return _diff(stratified_z(gen, W, M))


def multinomial_counts(gen, W, M=None):
    """Multinomial offspring counts = diff of the z-form."""
    return _diff(multinomial_z(gen, W, M))


def residual_counts(gen, W, M=None):
    """Residual offspring counts: floor(M W) deterministic copies plus
    multinomial draws on the residual weights.

    The number of residual draws ``sres = M - sum(floor(M W))`` stays on
    the device: the first k of ``cumsum(E) / cumsum(E)[k]`` are k sorted
    uniforms for any k, so M + 1 exponentials give them with fixed shapes,
    and the draws past ``sres`` are masked above every cs (B6 sorts the
    sums, then B3, B5).
    """
    M = W.shape[0] if M is None else M
    MW = W * M
    intpart = torch.floor(MW).to(torch.int32)
    res = MW - intpart
    sres = M - intpart.sum()
    z_exp = _sorted_cumsum(
        torch.empty(M + 1, device=W.device).exponential_(generator=gen))
    denom = z_exp.index_select(0, sres.clamp(0, M).reshape(1))
    su = z_exp[:-1] / denom
    su = torch.where(torch.arange(M, device=W.device) < sres, su, 2.0)
    cs, cs_mono = _normalised_cumsum_mono(res / res.sum().clamp_min(1e-30))
    zr = torch.minimum(_merge_rank_counts(su, cs, M), sres).to(torch.int32)
    zr[-1] = sres.clamp(0, M)
    if not cs_mono:
        zr = _monotone_z(zr)
    return intpart + _diff(zr)


# N from which ssp_counts pairs by the tree (_ssp_counts_blocked), and its
# block width, as in the JAX package
_SSP_BLOCKED_MIN = 8192
_SSP_K = 32


def _ssp_counts_sequential(W, M, u):
    """The sequential SSP pairing over Python floats (``W`` and ``u`` lists
    of N and N - 1 numbers): the plain version of ``native.ssp_counts``,
    with the same float64 arithmetic in the same order (the total too: a
    left-to-right sum, where Python's ``sum`` of floats compensates) and
    its round-off fix-up so that the counts sum to M."""
    N = len(W)
    total = 0.0
    for w in W:
        total += w
    counts, xi = [], []
    for w in W:
        mw = M * w / total
        fl = math.floor(mw)
        counts.append(fl)
        xi.append(mw - fl)
    i, j = 0, 1
    for k in range(N - 1):
        delta_i = min(xi[j], 1.0 - xi[i])
        delta_j = min(xi[i], 1.0 - xi[j])
        sum_delta = delta_i + delta_j
        pj = delta_i / sum_delta if sum_delta > 0.0 else 0.0
        if u[k] < pj:
            i, j = j, i
            delta_i = delta_j
        if xi[j] < 1.0 - xi[i]:
            xi[i] += delta_i
            j = k + 2
        else:
            xi[j] -= delta_i
            counts[i] += 1
            i = k + 2
    last = i if j == N else j
    total_counts = sum(counts)
    if total_counts == M - 1 and xi[last] > 0.99:
        counts[last] += 1
        total_counts += 1
    counts[last] += M - total_counts
    return counts


def _ssp_counts_blocked(gen, W, M, K=_SSP_K):
    """SSP offspring counts by the tree pairing of the JAX package's
    ``_ssp_counts_blocked``: the fractional parts are paired within K-wide
    STRIDED blocks (block b is {b, B + b, 2B + b, ...}), B = N/K chains
    advanced in lockstep for K - 1 steps, and each block's surviving
    fraction is promoted to the next level: ceil(log_K N) levels.  Any
    adapted pairing keeps SSP's unbiasedness, its floor/ceil support and
    the exact sum; the joint law differs from the sequential pairing's.
    Everything stays on the device."""
    N = W.shape[0]
    dev = W.device
    MW = W * M
    floor = torch.floor(MW)
    phi = MW - floor
    nr = floor.to(torch.int64)
    idx = torch.arange(N, device=dev)
    n, first_level = N, True
    while n > 1:
        npad = -(-n // K) * K
        if npad > n:
            # zero fractional parts retire at 0 without a count
            phi = torch.cat([phi, phi.new_zeros(npad - n)])
            idx = torch.cat([idx, idx.new_zeros(npad - n)])
        B = npad // K
        x = phi.clone()         # flat (K, B): entry r * B + c, block c
        nrl = torch.zeros(npad, dtype=torch.int64, device=dev)
        u = torch.rand((K - 1, B), generator=gen, device=dev)
        cols = torch.arange(B, device=dev)
        i, j = cols, cols + B   # flat indices of each block's pair
        for k in range(K - 1):
            a, b = x[i], x[j]
            delta_i = torch.minimum(b, 1.0 - a)
            delta_j = torch.minimum(a, 1.0 - b)
            sum_delta = delta_i + delta_j
            pj = torch.where(sum_delta > 0.0, delta_i / sum_delta, 0.0)
            swap = u[k] < pj
            i, j = torch.where(swap, j, i), torch.where(swap, i, j)
            a, b = torch.where(swap, b, a), torch.where(swap, a, b)
            one_minus_a = 1.0 - a
            delta = torch.minimum(b, one_minus_a)
            grow = b < one_minus_a
            # grow: i takes delta from j, and j retires; else i retires
            # with one more offspring and j keeps the rest
            x.index_add_(0, torch.where(grow, i, j),
                         torch.where(grow, delta, -delta))
            nrl.index_add_(0, i, (~grow).to(torch.int64))
            nxt = cols + (k + 2) * B
            i, j = torch.where(grow, i, nxt), torch.where(grow, nxt, j)
        fs = torch.where(j >= K * B, i, j)            # block survivors
        if first_level:
            nr = nr + nrl[:N]                # flat order == input order
            first_level = False
        else:
            nr.index_add_(0, idx, nrl)
        phi, idx = x[fs], idx[fs]
        n = B
    # land the round-off on the final survivor so that the counts sum to M
    nr.index_add_(0, idx[:1], (M - nr.sum()).reshape(1))
    return nr.to(torch.int32)


def ssp_counts(gen, W, M=None):
    """SSP offspring counts: floor(M W_n) or floor(M W_n) + 1 offspring
    each, summing to M, negatively associated (Gerber, Chopin & Whiteley
    2019).

    At N >= ``_SSP_BLOCKED_MIN`` the tree pairing on the device
    (:func:`_ssp_counts_blocked`).  Below it the sequential pairing on the
    host, by the C++ helper ``native.ssp_counts`` (float64; equal bit for
    bit to :func:`_ssp_counts_sequential`): N - 1 float64 uniforms drawn
    from ``gen`` on W's device, W and the uniforms read on the host in one
    copy (the one scheme step that syncs), the int32 counts put back on
    W's device.
    """
    M = W.shape[0] if M is None else M
    N = W.shape[0]
    if N >= _SSP_BLOCKED_MIN:
        return _ssp_counts_blocked(gen, W, M)
    u = torch.rand(N - 1, generator=gen, device=W.device, dtype=torch.float64)
    with tracing.sync("ssp"):
        host = torch.cat([W.double(), u]).cpu().numpy()
    counts = native.ssp_counts(host[:N], M, host[N:])
    return torch.from_numpy(counts).to(W.device)


rs_counts_funcs = {
    "systematic": systematic_counts,
    "stratified": stratified_counts,
    "multinomial": multinomial_counts,
    "residual": residual_counts,
    "ssp": ssp_counts,
}
rs_z_funcs = {
    "systematic": systematic_z,
    "stratified": stratified_z,
    "multinomial": multinomial_z,
}


def resampling_counts(scheme, gen, W, M=None):
    """Offspring counts of a sorted-ancestor scheme: (N,) int32 summing to
    M."""
    if scheme not in rs_counts_funcs:
        raise ValueError(f"{scheme} has no counts-based (sorted) form")
    return rs_counts_funcs[scheme](gen, W, M)


def resampling_z(scheme, gen, W, M=None):
    """z-form of a sorted-ancestor scheme: (N,) int32 nondecreasing with
    ``z[-1] == M``; the move is ``Y[j] = X[#{k: z_k <= j}]``.  Schemes
    without an analytic z-form take the cumsum of their counts."""
    if scheme in rs_z_funcs:
        return rs_z_funcs[scheme](gen, W, M)
    counts = resampling_counts(scheme, gen, W, M)
    return torch.cumsum(counts, 0, dtype=torch.int32)


def counts_to_ancestors(counts, M):
    """Sorted ancestors ``A[m] = #{n: cumsum(counts)[n] <= m}`` (int64), by
    B2's ancestors-only form."""
    return ancestors_by_z(torch.cumsum(counts, 0, dtype=torch.int32), M)


# ---------------------------------------------------------------------------
# ancestor schemes (the registry selected by name)
# ---------------------------------------------------------------------------

rs_funcs = {}


def resampling_scheme(func):
    """Register a resampling scheme ``func(gen, W, M)`` by name; ``M``
    defaults to N."""

    def wrapped(gen, W, M=None):
        return func(gen, W, W.shape[0] if M is None else M)

    wrapped.__name__ = func.__name__
    wrapped.__qualname__ = func.__qualname__
    wrapped.__doc__ = func.__doc__
    rs_funcs[func.__name__] = wrapped
    return wrapped


def resampling(scheme, gen, W, M=None):
    """Ancestor indices of scheme ``scheme`` (by name): (M,) int64."""
    if scheme not in rs_funcs:
        raise ValueError(f"{scheme} is not a valid resampling scheme")
    return rs_funcs[scheme](gen, W, M)


@resampling_scheme
def multinomial(gen, W, M):
    """Multinomial resampling: sorted ancestors (B3, B5, B2)."""
    return ancestors_by_z(multinomial_z(gen, W, M), M)


@resampling_scheme
def stratified(gen, W, M):
    """Stratified resampling: sorted ancestors (B3, B2)."""
    return ancestors_by_z(stratified_z(gen, W, M), M)


@resampling_scheme
def systematic(gen, W, M):
    """Systematic resampling: sorted ancestors (B1, B2)."""
    return ancestors_by_z(systematic_z(gen, W, M), M)


@resampling_scheme
def residual(gen, W, M):
    """Residual resampling: floor(M W_n) copies of each particle, the
    remaining slots filled by multinomial draws on the residual weights;
    sorted ancestors."""
    return counts_to_ancestors(residual_counts(gen, W, M), M)


@resampling_scheme
def ssp(gen, W, M):
    """SSP resampling (see :func:`ssp_counts`): sorted ancestors."""
    return counts_to_ancestors(ssp_counts(gen, W, M), M)


@resampling_scheme
def killing(gen, W, M):
    """Killing resampling: particle n survives with probability
    W_n / max(W); killed slots get IID multinomial draws (B3, B4).
    Defined only for M == N."""
    N = W.shape[0]
    if M != N:
        raise ValueError("killing resampling defined only for M=N")
    killed = torch.rand(N, generator=gen, device=W.device) * W.max() >= W
    replacements = multinomial_iid(gen, W, N)
    return torch.where(killed, replacements,
                       torch.arange(N, device=W.device))


@resampling_scheme
def idiotic(gen, W, M):
    """Idiotic resampling, for tests: M copies of one multinomial draw."""
    return multinomial_once(gen, W).reshape(1).repeat(M)


def pinned_cdf(W):
    """The monotone CDF (B3) with its top pinned to 1, above every uniform
    draw."""
    cs, _ = _normalised_cumsum_mono(W)
    cs[-1:].fill_(1.0)
    return cs


def multinomial_iid(gen, W, M=None):
    """Multinomial resampling with IID (unsorted) output: (M,) int64
    ancestors ``#{i: cs_i < u_j}`` of M unsorted uniforms, served by B4 on
    the B3 CDF.  A binary search per query needs no sorted stream, so the
    JAX package's sort-serve-unsort is not carried over."""
    M = W.shape[0] if M is None else M
    u = torch.rand(M, generator=gen, device=W.device)
    return ancestors_by_su(u, pinned_cdf(W))


def multinomial_iid_values(gen, W, cols, M=None):
    """:func:`multinomial_iid` plus the served values ``[c[A] for c in
    cols]``, in one B4 launch: returns ``(A, values)``."""
    M = W.shape[0] if M is None else M
    return draw_by_cdf(gen, pinned_cdf(W), cols, M)


def draw_by_cdf(gen, cs, cols, M):
    """:func:`multinomial_iid_values` on a CDF already built by
    :func:`pinned_cdf` (B4 alone), for callers that draw from the same
    weights more than once."""
    u = torch.rand(M, generator=gen, device=cs.device)
    values, A = repeat_cols_su(u, cs, M, cols, want_anc=True)
    return A, values


class MultinomialQueue:
    """On-the-fly multinomial draws in amortised O(1) per draw (host-side
    helper of the reference library)."""

    def __init__(self, gen, W, M=None):
        self.W = W
        self.M = W.shape[0] if M is None else M
        self.gen = gen
        self.j = 0
        self.enqueue()

    def enqueue(self):
        self.A = multinomial_iid(self.gen, self.W, self.M)

    def dequeue(self, k):
        """Return the next *k* multinomial draws."""
        if self.j + k <= self.M:
            out = self.A[self.j:self.j + k]
            self.j += k
        elif k <= self.M:
            nextra = self.j + k - self.M
            head = self.A[self.j:]
            self.enqueue()
            out = torch.cat([head, self.A[:nextra]])
            self.j = nextra
        else:
            raise ValueError("MultinomialQueue: k must be <= M")
        return out
