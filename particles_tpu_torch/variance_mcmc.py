"""MCMC asymptotic-variance estimators (for the waste-free SMC collectors).

Counterpart of ``particles_tpu/variance_mcmc.py``: Geyer (1992)
initial-sequence and Tukey-Hanning spectral estimators over (P, M) chain
arrays, with FFT-based autocovariances, plus ``ess``, ``gelman_rubin``
and ``chain_diagnostics``.

These post-process small chain arrays on the host (the waste-free
variance collectors of ``smc_samplers`` read the final weights and
particles once a step), so, as in the JAX package, they are plain NumPy;
a tensor argument, on any device, is first copied to the host
(:func:`_host`).  The port keeps its own copy of this module: it imports
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "autocovariance_fft_multiple",
    "AutoCovarianceCalculator",
    "MCMC_variance",
    "MCMC_variance_weighted",
    "MCMC_variance_naive",
    "MCMC_init_seq",
    "MCMC_Tukey_Hanning",
    "gelman_rubin",
    "ess",
    "chain_diagnostics",
]


def _host(a, dtype=None):
    """``a`` as a numpy array; a tensor (on any device) is copied to the
    host."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def MCMC_variance(X, method):
    """sigma^2 in the MCMC CLT, from M chains of length P stored as a (P, M)
    array (reference variance_mcmc.py:23-36).  ``method`` in
    ['naive', 'init_seq', 'th']."""
    X = _host(X, dtype=np.float64)
    if method == "naive":
        return MCMC_variance_naive(X)
    if method == "init_seq":
        return MCMC_init_seq(X)
    if method == "th":
        return MCMC_Tukey_Hanning(X)
    raise ValueError("Unknown method.")


def _mean_with_weighted_columns(X, W):
    P, _ = X.shape
    return np.sum(X * (W / P))


def MCMC_variance_weighted(X, W, method):
    """Like MCMC_variance with per-column weights W (sum to 1)
    (reference variance_mcmc.py:47-50)."""
    X = _host(X, dtype=np.float64)
    W = _host(W, dtype=np.float64)
    _, M = X.shape
    return MCMC_variance(M * W * (X - _mean_with_weighted_columns(X, W)), method)


def MCMC_variance_naive(X):
    """P * var over the chain means (reference variance_mcmc.py:52-55)."""
    P, _ = X.shape
    return np.var(np.mean(X, axis=0)) * P


def _autocovariances_fft(X, mu=None, bias=True):
    """(P,) autocovariances averaged over the M chains, via FFT
    (reference variance_mcmc.py:66-91)."""
    X = _host(X, dtype=np.float64)
    if mu is None:
        mu = np.mean(X)
    Xc = X - mu
    P, M = Xc.shape
    nfft = 1
    while nfft < 2 * P:
        nfft *= 2
    f = np.fft.rfft(Xc, n=nfft, axis=0)
    acf = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:P].real
    acf = acf.mean(axis=1)
    if bias:
        return acf / P
    return acf / np.arange(P, 0, -1)


def MCMC_init_seq(X, bias=True):
    """Geyer (1992) initial-sequence estimator
    (reference variance_mcmc.py:137-152): sum autocovariances until the
    first inadmissible odd index."""
    X = _host(X, dtype=np.float64)
    c = _autocovariances_fft(X, bias=bias)
    P = len(c)

    def inadmissible(i):
        if i % 2 == 0:
            return False
        val1 = c[i] + c[i - 1] if i < P else np.inf
        if i < P and i >= 3:
            val2 = c[i - 2] + c[i - 3] - c[i] - c[i - 1]
        else:
            val2 = np.inf
        return val1 < -1e-10 or val2 < -1e-10

    i = 0
    while i < P and not inadmissible(i):
        i += 1
    return -c[0] + 2 * np.sum(c[:i])


def MCMC_Tukey_Hanning(X, bias=True, adapt_constant=True):
    """Tukey-Hanning spectral variance estimator (Flegal & Jones 2010)
    (reference variance_mcmc.py:171-197)."""
    X = _host(X, dtype=np.float64)
    if np.var(X) < 1e-12:
        return 0.0
    c = _autocovariances_fft(X, bias=bias)
    alpha = 0.25
    P = len(c)
    if adapt_constant:
        const = np.sqrt(3.75 * MCMC_variance_naive(X) / np.var(X))
    else:
        const = 1.0
    b = int(max(const * P**0.5 + 1, 2))
    w = np.array([1 - 2 * alpha + 2 * alpha * np.cos(np.pi * k / b)
                  for k in range(b)])
    w_cov = [w[i] * c[i] if i < P else 0.0 for i in range(1, b)]
    return w[0] * c[0] + 2 * np.sum(w_cov)


def autocovariance_fft_single(x, mu=None, bias=True):
    """(n,) FFT autocovariances of one chain (reference
    variance_mcmc.py:67-80): ``res[i]`` is the lag-i autocovariance."""
    x = _host(x, dtype=np.float64)
    # one-column case of the shared FFT helper (O(n log n); a full-mode
    # np.correlate here would be O(n^2) at long chain lengths)
    return _autocovariances_fft(x[:, None], mu=mu, bias=bias)


def default_collector(ls):
    """Concatenate a list of per-chunk arrays (reference
    variance_mcmc.py:199-201)."""
    return np.concatenate([_host(a) for a in ls])


def autocovariance_fft_multiple(X, mu=None, bias=True):
    """(P,) autocovariances averaged over M chains (reference
    variance_mcmc.py:82-91)."""
    return _autocovariances_fft(X, mu=mu, bias=bias)


def autocovariance(X, order, mu=None, bias=True):
    """Single-lag autocovariance (reference variance_mcmc.py:57-65)."""
    X = _host(X, dtype=np.float64)
    if mu is None:
        mu = np.mean(X)
    Xc = X - mu
    P, _ = Xc.shape
    val = np.mean(Xc[: P - order] * Xc[order:P])
    return val * (P - order) / P if bias else val


def gelman_rubin(X):
    """Split-:math:`\\hat R` of Gelman & Rubin (1992) over a (P, M) chain
    array (P iterations, M chains; the layout ``mcmc.GenericRWHM`` stores
    with ``nchains > 1``).

    Each chain is split in half (2M half-chains of length P//2) so the
    statistic also detects non-stationarity within a single chain; M = 1 is
    therefore allowed.  Values near 1 indicate convergence; > 1.01 is the
    usual alarm threshold (Vehtari et al. 2021).  No counterpart in the
    reference library (its pmcmc studies eyeball trace plots).
    """
    X = _host(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    P, M = X.shape
    if P < 4:
        # too short to split: report "no information" rather than raising
        # (diagnostics() with a large discard_frac on a short chain should
        # degrade gracefully, not crash the caller's reporting loop)
        return float("nan")
    half = P // 2
    # (half, 2M) array of half-chains
    H = np.concatenate([X[:half], X[P - half:]], axis=1)
    means = H.mean(axis=0)
    within = H.var(axis=0, ddof=1).mean()
    between = half * means.var(ddof=1)
    if within < 1e-300:
        return 1.0 if between < 1e-300 else np.inf
    var_plus = (half - 1) / half * within + between / half
    return float(np.sqrt(var_plus / within))


def ess(X, method="init_seq"):
    """Effective sample size of a (P, M) chain array: total draws P*M
    deflated by the integrated autocorrelation time,
    ``ess = P * M * c0 / sigma^2`` with ``sigma^2`` from
    :func:`MCMC_variance` (``method`` in ['naive', 'init_seq', 'th']).

    Note: the estimate is NOT capped at P*M — for anti-correlated
    (super-efficient) chains ``sigma^2 < c0`` legitimately yields
    ess > P*M (>100% efficiency); treat values above P*M as "at least
    as good as iid draws"."""
    X = _host(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    P, M = X.shape
    c0 = float(np.var(X))
    if c0 < 1e-300:
        return float(P * M)
    sigma2 = MCMC_variance(X, method)
    if sigma2 <= 0.0:
        return float(P * M)
    return float(P * M * c0 / sigma2)


def chain_diagnostics(theta, nchains=1, discard=0, method="init_seq"):
    """Per-parameter convergence diagnostics for a chain stored as a dict
    of arrays shaped ``(niter, *param_shape)`` (single chain) or
    ``(niter, nchains, *param_shape)`` (the ``mcmc.GenericRWHM.chain.theta``
    layout with ``nchains > 1`` — pass the sampler's ``nchains`` here, the
    shapes alone cannot distinguish chains from parameter components).

    Returns ``{name: {"rhat": float, "ess": float}}``; multivariate
    parameters report the WORST component (max rhat, min ess).  ``discard``
    drops the first iterations as burn-in.
    """
    out = {}
    for name, arr in theta.items():
        arr = _host(arr, dtype=np.float64)[discard:]
        if nchains > 1:
            if arr.shape[1] != nchains:
                raise ValueError(
                    f"{name}: axis 1 is {arr.shape[1]}, expected "
                    f"nchains={nchains}")
        else:
            arr = arr[:, None]
        # flatten any trailing component dims -> (P, M, C)
        P, M = arr.shape[0], arr.shape[1]
        comps = arr.reshape(P, M, -1)
        rhats = [gelman_rubin(comps[:, :, c]) for c in range(comps.shape[2])]
        esss = [ess(comps[:, :, c], method) for c in range(comps.shape[2])]
        out[name] = {"rhat": float(np.max(rhats)), "ess": float(np.min(esss))}
    return out


class AutoCovarianceCalculator:
    """Lazily-computed autocovariances of (P, M) chains
    (reference variance_mcmc.py:93-135)."""

    def __init__(self, X, method=None, bias=True):
        self.X = _host(X, dtype=np.float64)
        self.P, self.M = self.X.shape
        self.bias = bias
        self._cov = None

    def __getitem__(self, k):
        if k < 0 or k >= self.P:
            raise IndexError
        if self._cov is None:
            self._cov = _autocovariances_fft(self.X, bias=self.bias)
        return self._cov[k]

    def __len__(self):
        return self.P
