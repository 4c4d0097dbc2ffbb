"""Probability distributions (PyTorch port).

Counterpart of ``particles_tpu/distributions.py``, with the same names and
protocol: ``rvs(gen, size=None)``, ``logpdf(x)``, ``ppf(u)`` where the JAX
law has one, ``dim`` and ``dtype``.  ``rvs`` takes a ``torch.Generator``
where the JAX package takes a key, draws on the generator's device and
nothing from torch's global generator.  Parameters may be Python floats or
tensors; an (N,) parameter makes the distribution an array of N
distributions, as in the JAX package.  Draws are float32 unless a
parameter is a tensor of another floating dtype.

Discrete laws draw int64 (the JAX package's draw int32): torch indexes
with int64, and the resampling move serves either exactly.

Quantile functions that SciPy computes with special-function inverses are
bisections of the CDF with the JAX package's fixed iteration counts
(:func:`_bisect_ppf`); :func:`betainc`, the regularised incomplete beta
function that torch lacks, is a continued fraction in float64
of a fixed number of terms (``BETAINC_TERMS``).
``StructDist`` draws an ``OrderedDict`` of tensors, which the engine
serves leaf by leaf.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch

__all__ = [
    "ProbDist",
    "DiscreteDist",
    "LocScaleDist",
    "Normal",
    "Logistic",
    "Laplace",
    "Beta",
    "Gamma",
    "InvGamma",
    "LogNormal",
    "Uniform",
    "Student",
    "FlatNormal",
    "Dirac",
    "TruncNormal",
    "Poisson",
    "Binomial",
    "Geometric",
    "NegativeBinomial",
    "Categorical",
    "DiscreteUniform",
    "TransformedDist",
    "LinearD",
    "LogD",
    "LogitD",
    "Mixture",
    "MixMissing",
    "Dirichlet",
    "MvNormal",
    "VaryingCovNormal",
    "IndepProd",
    "IID",
    "Cond",
    "StructDist",
    "betainc",
]

HALFLOG2PI = 0.5 * math.log(2.0 * math.pi)
# the largest float32 below 1 (numpy's finfo(float32).epsneg below 1)
_ONE_MINUS_EPSNEG = 1.0 - 2.0 ** -24


# ---------------------------------------------------------------------------
# generic helpers
# ---------------------------------------------------------------------------

def _float_dtype(*params):
    dt = None
    for p in params:
        if isinstance(p, torch.Tensor) and p.is_floating_point():
            dt = p.dtype if dt is None else torch.promote_types(dt, p.dtype)
    return torch.float32 if dt is None else dt


def _param_size(*params):
    """Leading dimension implied by broadcasting the parameters (or None)."""
    shape = torch.broadcast_shapes(
        *(p.shape for p in params if isinstance(p, torch.Tensor)))
    return shape[0] if len(shape) else None


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _log1p(v):
    return torch.log1p(v) if isinstance(v, torch.Tensor) else math.log1p(v)


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def _lgamma(v):
    return torch.lgamma(v) if isinstance(v, torch.Tensor) else math.lgamma(v)


def _on(value, dtype, device):
    """``value`` as a tensor of ``dtype`` on ``device`` with no host sync:
    a Python number is filled on the device (``torch.as_tensor`` would copy
    it from pageable host memory, which synchronises), a tensor is cast."""
    if isinstance(value, (int, float)):
        return torch.full((), value, dtype=dtype, device=device)
    return torch.as_tensor(value, dtype=dtype, device=device)


def _full(value, shape, dtype, device):
    """``value`` (a float or a tensor) broadcast to ``shape`` as a new
    tensor, with no host sync."""
    return _on(value, dtype, device).expand(shape).clone()


def _uniform(gen, shape, dtype=torch.float32):
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


def _standard_gamma(gen, alpha, shape, dtype):
    """Gamma(alpha, 1) draws of ``shape``."""
    return torch._standard_gamma(_full(alpha, shape, dtype, gen.device),
                                 generator=gen)


def _bisect_ppf(cdf, u, lo, hi, iters=64):
    """Quantile by a fixed number of bisections of a vectorised CDF, as in
    the JAX package: accuracy ~ (hi - lo) 2^-iters, or the float grid."""
    u = torch.as_tensor(u)
    a = _full(lo, u.shape, u.dtype, u.device)
    b = _full(hi, u.shape, u.dtype, u.device)
    for _ in range(iters):
        m = 0.5 * (a + b)
        go_right = cdf(m) < u
        a = torch.where(go_right, m, a)
        b = torch.where(go_right, b, m)
    return 0.5 * (a + b)


# Terms of betainc's continued fraction.  Fixed, as the JAX package's
# float32 count (200), so that no term reads the device: the fraction
# converges to float64 precision within 78 terms for a, b <= 500, 138 for
# a, b <= 2e4 and 198 for a, b <= 5e4 (the worst x, near the switch point
# (a + 1) / (a + b + 2), on a grid of 80 x 80 (a, b) pairs).
BETAINC_TERMS = 200


def betainc(a, b, x):
    """Regularised incomplete beta function I_x(a, b), elementwise over the
    broadcast of ``a``, ``b`` and ``x`` (counterpart of
    ``jax.scipy.special.betainc``).

    A continued fraction by the modified Lentz method, in float64, of
    ``BETAINC_TERMS`` terms: for x below the mean-like point
    (a + 1) / (a + b + 2) it converges fast, and above it the symmetry
    I_x(a, b) = 1 - I_{1-x}(b, a) is used.  No value is read on the host.
    Returns the floating dtype of the inputs (float32 by default)."""
    out_dtype = _float_dtype(a, b, x)
    dev = next((v.device for v in (x, a, b) if isinstance(v, torch.Tensor)),
               None)
    a, b, x = torch.broadcast_tensors(
        *(_on(v, torch.float64, dev) for v in (a, b, x)))
    swap = x > (a + 1.0) / (a + b + 2.0)
    p = torch.where(swap, b, a)
    q = torch.where(swap, a, b)
    y = torch.where(swap, 1.0 - x, x)
    log_front = (torch.lgamma(p + q) - torch.lgamma(p) - torch.lgamma(q)
                 + p * torch.log(y) + q * torch.log1p(-y))
    tiny = 1e-300

    def floor(v):
        return torch.where(v.abs() < tiny, tiny, v)

    c = torch.ones_like(y)
    d = 1.0 / floor(1.0 - (p + q) * y / (p + 1.0))
    h = d.clone()
    for m in range(1, BETAINC_TERMS + 1):
        m2 = 2.0 * m
        num = m * (q - m) * y / ((p - 1.0 + m2) * (p + m2))
        d = 1.0 / floor(1.0 + num * d)
        c = floor(1.0 + num / c)
        h = h * d * c
        num = -(p + m) * (p + q + m) * y / ((p + m2) * (p + 1.0 + m2))
        d = 1.0 / floor(1.0 + num * d)
        c = floor(1.0 + num / c)
        h = h * d * c
    front = torch.exp(log_front) * h / p
    out = torch.where(swap, 1.0 - front, front)
    return out.to(out_dtype)


class ProbDist:
    """Base class for probability distributions: ``logpdf(x)``,
    ``rvs(gen, size=None)`` and optionally ``ppf(u)``, plus ``dim`` and
    ``dtype``."""

    dim = 1
    dtype = "float32"

    def shape(self, size):
        if size is None:
            return None
        return (size,) if self.dim == 1 else (size, self.dim)

    def _draw_shape(self, size, *params):
        if size is None:
            size = _param_size(*params)
        if size is None:
            return ()
        return self.shape(size)

    def logpdf(self, x):
        raise NotImplementedError

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def rvs(self, gen, size=None):
        raise NotImplementedError

    def ppf(self, u):
        raise NotImplementedError

    def sample(self, gen, size=None):
        return self.rvs(gen, size=size)


class DiscreteDist(ProbDist):
    """Base class for discrete distributions (int64 draws)."""

    dtype = "int64"


class LocScaleDist(ProbDist):
    """Base class for location-scale families."""

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = loc
        self.scale = scale

    def _uniform_draw(self, gen, size):
        shape = self._draw_shape(size, self.loc, self.scale)
        return _uniform(gen, shape, _float_dtype(self.loc, self.scale))


# ---------------------------------------------------------------------------
# continuous univariate distributions
# ---------------------------------------------------------------------------

class Normal(LocScaleDist):
    """N(loc, scale^2)."""

    def rvs(self, gen, size=None):
        shape = self._draw_shape(size, self.loc, self.scale)
        z = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=_float_dtype(self.loc, self.scale))
        return self.loc + self.scale * z

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - _log(self.scale) - HALFLOG2PI

    def ppf(self, u):
        return self.loc + self.scale * torch.special.ndtri(u)

    def posterior(self, x, sigma=1.0):
        """Model: X_1..X_n ~ N(theta, sigma^2), theta ~ self, sigma fixed."""
        pr0 = 1.0 / self.scale ** 2
        prd = x.numel() / sigma ** 2
        varp = 1.0 / (pr0 + prd)
        mu = varp * (pr0 * self.loc + prd * x.mean())
        return Normal(loc=mu, scale=_sqrt(varp))


class Logistic(LocScaleDist):
    """Logistic(loc, scale)."""

    def rvs(self, gen, size=None):
        u = self._uniform_draw(gen, size).clamp_min(torch.finfo().tiny)
        return self.ppf(u)

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        return (-z - 2.0 * torch.nn.functional.softplus(-z)
                - _log(self.scale))

    def ppf(self, u):
        return self.loc + self.scale * (torch.log(u) - torch.log1p(-u))


class Laplace(LocScaleDist):
    """Laplace(loc, scale)."""

    def rvs(self, gen, size=None):
        u = self._uniform_draw(gen, size).clamp_min(torch.finfo().tiny)
        return self.ppf(u)

    def logpdf(self, x):
        return -(x - self.loc).abs() / self.scale - _log(2.0 * self.scale)

    def ppf(self, u):
        q = torch.where(u < 0.5, torch.log(2.0 * u),
                        -torch.log(2.0 * (1.0 - u)))
        return self.loc + self.scale * q


class Beta(ProbDist):
    """Beta(a, b)."""

    def __init__(self, a=1.0, b=1.0):
        self.a = a
        self.b = b

    def rvs(self, gen, size=None):
        # a ratio of gammas, in log space: log G_a = log G_{a+1} + log U / a
        # keeps a small shape parameter from underflowing both gammas to 0
        shape = self._draw_shape(size, self.a, self.b)
        dt = _float_dtype(self.a, self.b)

        def log_gamma(alpha):
            g = _standard_gamma(gen, alpha + 1.0, shape, dt)
            return torch.log(g) + torch.log(_uniform(gen, shape, dt)) / alpha

        la, lb = log_gamma(self.a), log_gamma(self.b)
        draw = torch.exp(la - torch.logaddexp(la, lb))
        # as in the JAX package: never exactly 0 or 1, where logpdf diverges
        return draw.clamp(torch.finfo(dt).tiny, _ONE_MINUS_EPSNEG)

    def logpdf(self, x):
        a, b = self.a, self.b
        inside = (x >= 0.0) & (x <= 1.0)
        xs = x.clamp(0.0, 1.0)
        lp = ((a - 1.0) * torch.log(xs) + (b - 1.0) * torch.log1p(-xs)
              - (_lgamma(a) + _lgamma(b) - _lgamma(a + b)))
        return torch.where(inside, lp, -torch.inf)

    def ppf(self, u):
        return _bisect_ppf(lambda m: betainc(self.a, self.b, m), u, 0.0, 1.0)


class Gamma(ProbDist):
    """Gamma(a, b): shape a, rate b (scale 1/b)."""

    def __init__(self, a=1.0, b=1.0):
        self.a = a
        self.b = b

    @property
    def scale(self):
        return 1.0 / self.b

    def rvs(self, gen, size=None):
        shape = self._draw_shape(size, self.a, self.b)
        return (_standard_gamma(gen, self.a, shape,
                                _float_dtype(self.a, self.b)) / self.b)

    def logpdf(self, x):
        a, b = self.a, self.b
        return a * _log(b) + (a - 1.0) * torch.log(x) - b * x - _lgamma(a)

    def ppf(self, u):
        a = _on(self.a, u.dtype, u.device)
        hi = (a + 40.0 * torch.sqrt(a) + 40.0) / self.b
        return _bisect_ppf(lambda m: torch.special.gammainc(a, self.b * m),
                           u, 0.0, hi)

    def posterior(self, x):
        """Model: X_1..X_n ~ N(0, 1/theta), theta ~ Gamma(a, b)."""
        return Gamma(a=self.a + 0.5 * x.numel(),
                     b=self.b + 0.5 * (x * x).sum())


class InvGamma(ProbDist):
    """Inverse Gamma(a, b)."""

    def __init__(self, a=1.0, b=1.0):
        self.a = a
        self.b = b

    def rvs(self, gen, size=None):
        shape = self._draw_shape(size, self.a, self.b)
        return self.b / _standard_gamma(gen, self.a, shape,
                                        _float_dtype(self.a, self.b))

    def logpdf(self, x):
        a, b = self.a, self.b
        return (a * _log(b) - (a + 1.0) * torch.log(x) - b / x
                - _lgamma(a))

    def ppf(self, u):
        # X = b / G with G ~ Gamma(a, 1): a decreasing map, so the tail
        return self.b / Gamma(a=self.a, b=1.0).ppf(1.0 - u)

    def posterior(self, x):
        """Model: X_1..X_n ~ N(0, theta), theta ~ InvGamma(a, b)."""
        return InvGamma(a=self.a + 0.5 * x.numel(),
                        b=self.b + 0.5 * (x * x).sum())


class LogNormal(ProbDist):
    """Law of exp(N(mu, sigma^2))."""

    def __init__(self, mu=0.0, sigma=1.0):
        self.mu = mu
        self.sigma = sigma

    def rvs(self, gen, size=None):
        return torch.exp(Normal(loc=self.mu, scale=self.sigma).rvs(gen, size))

    def logpdf(self, x):
        lx = torch.log(x)
        return Normal(loc=self.mu, scale=self.sigma).logpdf(lx) - lx

    def ppf(self, u):
        return torch.exp(self.mu + self.sigma * torch.special.ndtri(u))


class Uniform(ProbDist):
    """Uniform on [a, b]."""

    def __init__(self, a=0.0, b=1.0):
        self.a = a
        self.b = b

    def rvs(self, gen, size=None):
        shape = self._draw_shape(size, self.a, self.b)
        return self.ppf(_uniform(gen, shape, _float_dtype(self.a, self.b)))

    def logpdf(self, x):
        inside = (x >= self.a) & (x <= self.b)
        return torch.where(inside, -_log(self.b - self.a), -torch.inf)

    def ppf(self, u):
        return self.a + (self.b - self.a) * u


class Student(ProbDist):
    """Student t(df, loc, scale)."""

    def __init__(self, df=3.0, loc=0.0, scale=1.0):
        self.df = df
        self.loc = loc
        self.scale = scale

    def rvs(self, gen, size=None):
        shape = self._draw_shape(size, self.df, self.loc, self.scale)
        dt = _float_dtype(self.df, self.loc, self.scale)
        z = torch.randn(shape, generator=gen, device=gen.device, dtype=dt)
        chi2 = 2.0 * _standard_gamma(gen, 0.5 * self.df, shape, dt)
        return self.loc + self.scale * z / torch.sqrt(chi2 / self.df)

    def logpdf(self, x):
        df = self.df
        z = (x - self.loc) / self.scale
        return (_lgamma(0.5 * (df + 1.0)) - _lgamma(0.5 * df)
                - 0.5 * _log(df * math.pi) - _log(self.scale)
                - 0.5 * (df + 1.0) * torch.log1p(z * z / df))

    def _std_cdf(self, t):
        # in float64: near t = 0, w = df / (df + t^2) is near 1 and the
        # tail depends on 1 - w, which float32 keeps to a few digits
        df = self.df
        t64 = t.to(torch.float64)
        tail = 0.5 * betainc(0.5 * df, 0.5, df / (df + t64 * t64))
        return torch.where(t64 > 0, 1.0 - tail, tail).to(t.dtype)

    def ppf(self, u):
        z = _bisect_ppf(self._std_cdf, u, -1e6, 1e6, iters=80)
        return self.loc + self.scale * z


class FlatNormal(ProbDist):
    """Improper flat law ("Normal with infinite variance"): logpdf 0, draws
    NaN (for missing values)."""

    def __init__(self, loc=0.0):
        self.loc = loc

    def logpdf(self, x):
        return torch.zeros_like(x + self.loc)

    def rvs(self, gen, size=None):
        shape = self._draw_shape(size, self.loc)
        return self.loc + torch.full(shape, torch.nan, device=gen.device,
                                     dtype=_float_dtype(self.loc))


class Dirac(ProbDist):
    """Dirac mass at loc."""

    def __init__(self, loc=0.0):
        self.loc = loc

    def _draw(self, N, device):
        if isinstance(self.loc, torch.Tensor) and self.loc.ndim >= 1:
            return self.loc
        return _full(self.loc, (N,), _float_dtype(self.loc), device)

    def rvs(self, gen, size=None):
        return self._draw(1 if size is None else size, gen.device)

    def logpdf(self, x):
        return torch.where(x == self.loc, 0.0, -torch.inf)

    def ppf(self, u):
        return self._draw(u.shape[0], u.device)


class TruncNormal(ProbDist):
    """N(mu, sigma^2) truncated to [a, b].

    ``ppf`` is the JAX package's ``ndtri(Fa + u (Fb - Fa))`` in float64,
    and, for an interval above the mean, its mirror on the upper tail,
    ``-ndtri(Sa - u (Sa - Sb))`` with S = 1 - F: there F is close to 1 and
    its float grid is coarse, while S keeps full precision, so the draws
    (``ppf`` of uniforms) keep the law far in a tail.  ``logpdf``'s
    normalising constant is taken on the same side."""

    def __init__(self, mu=0.0, sigma=1.0, a=0.0, b=1.0):
        self.mu = mu
        self.sigma = sigma
        self.a = a
        self.b = b

    @property
    def au(self):
        return (self.a - self.mu) / self.sigma

    @property
    def bu(self):
        return (self.b - self.mu) / self.sigma

    def _bounds64(self, device):
        def f64(v):
            return _on(v, torch.float64, device)
        return f64(self.au), f64(self.bu)

    def _log_mass(self, au, bu):
        upper = au >= 0.0
        nd = torch.special.ndtr
        return torch.where(upper, torch.log(nd(-au) - nd(-bu)),
                           torch.log(nd(bu) - nd(au)))

    def rvs(self, gen, size=None):
        shape = self._draw_shape(size, self.mu, self.sigma, self.a, self.b)
        dt = _float_dtype(self.mu, self.sigma, self.a, self.b)
        return self.ppf(_uniform(gen, shape, torch.float64)).to(dt)

    def logpdf(self, x):
        au, bu = self._bounds64(x.device)
        log_z = self._log_mass(au, bu).to(x.dtype)
        lp = Normal(loc=self.mu, scale=self.sigma).logpdf(x) - log_z
        inside = (x >= self.a) & (x <= self.b)
        return torch.where(inside, lp, -torch.inf)

    def ppf(self, u):
        au, bu = self._bounds64(u.device)
        u64 = u.to(torch.float64)
        nd = torch.special.ndtr
        Sa, Sb = nd(-au), nd(-bu)
        Fa, Fb = nd(au), nd(bu)
        z = torch.where(au >= 0.0,
                        -torch.special.ndtri(Sa - u64 * (Sa - Sb)),
                        torch.special.ndtri(Fa + u64 * (Fb - Fa)))
        z = torch.minimum(torch.maximum(z, au), bu)
        return (self.mu + self.sigma * z).to(u.dtype)

    def posterior(self, x, s=1.0):
        """Model: X_1..X_n ~ N(theta, s^2), theta ~ self, s fixed."""
        pr0 = 1.0 / self.sigma ** 2
        prd = x.numel() / s ** 2
        varp = 1.0 / (pr0 + prd)
        mu = varp * (pr0 * self.mu + prd * x.mean())
        return TruncNormal(mu=mu, sigma=_sqrt(varp), a=self.a, b=self.b)


# ---------------------------------------------------------------------------
# discrete distributions
# ---------------------------------------------------------------------------

class Poisson(DiscreteDist):
    """Poisson(rate)."""

    def __init__(self, rate=1.0):
        self.rate = rate

    def rvs(self, gen, size=None):
        shape = self._draw_shape(size, self.rate)
        rate = _full(self.rate, shape, _float_dtype(self.rate), gen.device)
        return torch.poisson(rate, generator=gen).to(torch.int64)

    def logpdf(self, x):
        return x * _log(self.rate) - self.rate - torch.lgamma(x + 1.0)

    def ppf(self, u):
        # P(X <= k) = gammaincc(k + 1, rate); integer bisection
        rate = _on(self.rate, u.dtype, u.device)
        hi = rate + 12.0 * torch.sqrt(rate) + 20.0
        k = _bisect_ppf(
            lambda m: torch.special.gammaincc(torch.floor(m) + 1.0, rate),
            u, -0.5, hi)
        return torch.ceil(k - 0.5).to(torch.int64)


class Binomial(DiscreteDist):
    """Binomial(n, p)."""

    def __init__(self, n=1, p=0.5):
        self.n = n
        self.p = p

    def rvs(self, gen, size=None):
        shape = self._draw_shape(size, self.n, self.p)
        dt = _float_dtype(self.p)
        count = _full(self.n, shape, dt, gen.device)
        prob = _full(self.p, shape, dt, gen.device)
        return torch.binomial(count, prob, generator=gen).to(torch.int64)

    def logpdf(self, x):
        n, p = self.n, self.p
        if not isinstance(n, torch.Tensor):
            n = float(n)
        return (_lgamma(n + 1.0) - torch.lgamma(x + 1.0)
                - torch.lgamma(n - x + 1.0) + x * _log(p)
                + (n - x) * _log1p(-p))

    def ppf(self, u):
        # P(X <= k) = betainc(n - k, k + 1, 1 - p)
        n = _on(self.n, u.dtype, u.device)

        def cdf(m):
            k = torch.floor(m)
            return betainc(torch.clamp_min(n - k, 1e-12), k + 1.0,
                           1.0 - self.p)

        k = _bisect_ppf(cdf, u, -0.5, n + 0.5)
        return torch.minimum(torch.ceil(k - 0.5).clamp_min(0.0), n).to(
            torch.int64)


class Geometric(DiscreteDist):
    """Geometric(p) on {1, 2, ...}."""

    def __init__(self, p=0.5):
        self.p = p

    def rvs(self, gen, size=None):
        shape = self._draw_shape(size, self.p)
        return self.ppf(_uniform(gen, shape, _float_dtype(self.p)))

    def logpdf(self, x):
        return (x - 1.0) * _log1p(-self.p) + _log(self.p)

    def ppf(self, u):
        # u away from 1: log1p(-1) = -inf would not cast to an integer
        u = torch.clamp_max(u, _ONE_MINUS_EPSNEG)
        k = torch.ceil(torch.log1p(-u) / _log1p(-self.p))
        return torch.clamp_min(k, 1.0).to(torch.int64)


class NegativeBinomial(DiscreteDist):
    """Negative Binomial(n, p): failures before the n-th success."""

    def __init__(self, n=1, p=0.5):
        self.n = n
        self.p = p

    def rvs(self, gen, size=None):
        # the Gamma-Poisson mixture: X | G ~ Poisson(G), G ~ Gamma(n, p/(1-p))
        shape = self._draw_shape(size, self.n, self.p)
        g = _standard_gamma(gen, self.n, shape, _float_dtype(self.p))
        lam = g * (1.0 - self.p) / self.p
        return torch.poisson(lam, generator=gen).to(torch.int64)

    def logpdf(self, x):
        n = self.n if isinstance(self.n, torch.Tensor) else float(self.n)
        return (torch.lgamma(x + n) - torch.lgamma(x + 1.0) - _lgamma(n)
                + n * _log(self.p) + x * _log1p(-self.p))


class Categorical(DiscreteDist):
    """Categorical law with probabilities p, (k,) or (N, k): an (N, k) p
    draws one category a row (in plain torch: the resampling kernels serve
    one CDF, not N of them)."""

    def __init__(self, p=None):
        self.p = p

    def logpdf(self, x):
        lp = torch.log(torch.as_tensor(self.p))
        if lp.ndim == 1:
            return lp[x]
        return torch.gather(lp, -1, x[:, None])[:, 0]

    def rvs(self, gen, size=None):
        p = torch.as_tensor(self.p)
        k = p.shape[-1]
        if p.ndim == 1:
            N = 1 if size is None else size
            cs = torch.cumsum(p, 0)
            u = _uniform(gen, (N,), cs.dtype)
            return torch.searchsorted(cs, u).clamp_(max=k - 1)
        N = p.shape[0] if size is None else size
        # the CDFs as (k, N), scanned along the outer dimension: a scan of
        # each short row of the (N, k) layout took 6 ms at N = 2^20, k = 3
        # on the H100 (tools/profile_torch_zoo.py)
        cs = torch.cumsum(p.T, 0)
        u = _uniform(gen, (N,), cs.dtype)
        return (u > cs).sum(0).clamp_(max=k - 1)


class DiscreteUniform(DiscreteDist):
    """Uniform on {lo, ..., hi - 1}."""

    def __init__(self, lo=0, hi=2):
        self.lo = lo
        self.hi = hi

    def logpdf(self, x):
        inside = (x >= self.lo) & (x < self.hi)
        return torch.where(inside, -math.log(float(self.hi - self.lo)),
                           -torch.inf)

    def rvs(self, gen, size=None):
        N = 1 if size is None else size
        return torch.randint(self.lo, self.hi, (N,), generator=gen,
                             device=gen.device)


# ---------------------------------------------------------------------------
# distribution transforms
# ---------------------------------------------------------------------------

class TransformedDist(ProbDist):
    """Law of Y = f(X) for a base law of X."""

    def __init__(self, base_dist):
        self.base_dist = base_dist

    def _error_msg(self, method):
        return (f"method {method} not defined in class "
                f"{self.__class__.__name__}")

    def f(self, x):
        raise NotImplementedError(self._error_msg("f"))

    def finv(self, x):
        raise NotImplementedError(self._error_msg("finv"))

    def logJac(self, x):
        """Log-Jacobian of the inverse transform."""
        raise NotImplementedError(self._error_msg("logJac"))

    def rvs(self, gen, size=None):
        return self.f(self.base_dist.rvs(gen, size=size))

    def logpdf(self, x):
        return self.base_dist.logpdf(self.finv(x)) + self.logJac(x)

    def ppf(self, u):
        return self.f(self.base_dist.ppf(u))


class LinearD(TransformedDist):
    """Law of Y = a X + b."""

    def __init__(self, base_dist, a=1.0, b=0.0):
        self.a = a
        self.b = b
        self.base_dist = base_dist

    def f(self, x):
        return self.a * x + self.b

    def finv(self, x):
        return (x - self.b) / self.a

    def logJac(self, x):
        return -_log(self.a) * torch.ones_like(x)


class LogD(TransformedDist):
    """Law of Y = log(X)."""

    def f(self, x):
        return torch.log(x)

    def finv(self, x):
        return torch.exp(x)

    def logJac(self, x):
        return x


class LogitD(TransformedDist):
    """Law of Y = logit((X - a) / (b - a))."""

    def __init__(self, base_dist, a=0.0, b=1.0):
        self.a = a
        self.b = b
        self.base_dist = base_dist

    def f(self, x):
        p = (x - self.a) / (self.b - self.a)
        return torch.log(p) - torch.log1p(-p)

    def finv(self, x):
        return self.a + (self.b - self.a) / (1.0 + torch.exp(-x))

    def logJac(self, x):
        return (_log(self.b - self.a) + x
                - 2.0 * torch.nn.functional.softplus(x))


# ---------------------------------------------------------------------------
# mixtures
# ---------------------------------------------------------------------------

class Mixture(ProbDist):
    """Mixture of k univariate laws; ``pk`` is (k,) or (N, k)."""

    def __init__(self, pk, *components):
        self.pk = torch.atleast_1d(torch.as_tensor(pk))
        self.k = self.pk.shape[-1]
        if len(components) != self.k:
            raise ValueError("Size of pk and nr of components should match")
        self.components = list(components)

    def logpdf(self, x):
        lpks = [torch.log(self.pk[..., i]) + cd.logpdf(x)
                for i, cd in enumerate(self.components)]
        return torch.logsumexp(torch.stack(lpks, -1), -1)

    def rvs(self, gen, size=None):
        k = Categorical(p=self.pk).rvs(gen, size=size)
        xs = torch.stack([cd.rvs(gen, size=size) for cd in self.components],
                         -1)
        return torch.take_along_dim(xs, k[..., None], dim=-1)[..., 0]


class MixMissing(ProbDist):
    """Mixture of a base law and 'missing' (NaN), with probability pmiss."""

    def __init__(self, pmiss=0.10, base_dist=None):
        self.pmiss = pmiss
        self.base_dist = base_dist

    def logpdf(self, x):
        lp = self.base_dist.logpdf(x)
        return torch.where(torch.isnan(x), _log(self.pmiss),
                           lp + _log1p(-self.pmiss))

    def rvs(self, gen, size=None):
        x = self.base_dist.rvs(gen, size=size)
        miss = _uniform(gen, (x.shape[0],)) < self.pmiss
        if x.ndim > 1:
            miss = miss[:, None]
        return torch.where(miss, torch.nan, x)


# ---------------------------------------------------------------------------
# multivariate distributions
# ---------------------------------------------------------------------------

def _cholesky(cov):
    """Lower Cholesky factor, without the error check that reads a device
    value on the host (a matrix that is not positive definite gives NaN,
    as in the JAX package)."""
    return torch.linalg.cholesky_ex(cov)[0]


class Dirichlet(ProbDist):
    """Dirichlet(alphas)."""

    def __init__(self, alphas=None):
        if alphas is None:
            raise ValueError("Dirichlet: missing parameter alphas")
        self.alphas = torch.as_tensor(alphas)
        if not self.alphas.is_floating_point():
            self.alphas = self.alphas.to(torch.float32)

    @property
    def dim(self):
        return self.alphas.shape[0]

    def logpdf(self, x):
        a = self.alphas
        norm = torch.lgamma(a).sum() - torch.lgamma(a.sum())
        return ((a - 1.0) * torch.log(x)).sum(-1) - norm

    def rvs(self, gen, size=1):
        alphas = self.alphas.to(gen.device).expand(size, self.dim)
        return torch._sample_dirichlet(alphas.contiguous(), generator=gen)


class MvNormal(ProbDist):
    """Multivariate normal N(loc, diag(scale) @ cov @ diag(scale)).

    ``loc``/``scale`` may be (d,) or (N, d); ``cov`` is a fixed (d, d)
    matrix whose Cholesky factor is computed once, at construction.
    """

    def __init__(self, loc=0.0, scale=1.0, cov=None):
        if cov is None:
            loc = torch.as_tensor(loc)
            if loc.ndim == 0:
                raise ValueError(
                    "MvNormal: cannot infer the dimension — pass a (d,) or "
                    "(N, d) loc, or an explicit (d, d) cov")
            cov = torch.eye(loc.shape[-1], dtype=_float_dtype(loc),
                            device=loc.device)
        self.cov = torch.as_tensor(cov)
        self.loc = torch.as_tensor(loc, dtype=self.cov.dtype,
                                   device=self.cov.device)
        self.scale = scale
        self.L = _cholesky(self.cov)

    @property
    def dim(self):
        return self.cov.shape[-1]

    def linear_transform(self, z):
        return self.loc + self.scale * (z @ self.L.T)

    def logpdf(self, x):
        halflogdetcor = torch.log(torch.diagonal(self.L)).sum()
        scale = _on(self.scale, self.L.dtype, self.L.device)
        xc = (x - self.loc) / scale
        was_1d = xc.ndim == 1
        # z = L^-1 xc, as xc times the (d, d) inverse: on CUDA a triangular
        # solve with one right-hand side per point takes minutes at 2^20
        Linv = torch.linalg.solve_triangular(
            self.L, torch.eye(self.dim, dtype=self.L.dtype,
                              device=self.L.device), upper=False)
        z = torch.atleast_2d(xc) @ Linv.T
        if scale.ndim == 0:
            logdet = self.dim * torch.log(scale)
        else:
            logdet = torch.log(scale).sum(-1)
        out = (-0.5 * (z * z).sum(-1) - (logdet + halflogdetcor)
               - self.dim * HALFLOG2PI)
        return out[0] if was_1d else out

    def rvs(self, gen, size=None):
        if size is None:
            sh = torch.broadcast_shapes(
                self.loc.shape, torch.as_tensor(self.scale).shape)
            size = 1 if len(sh) <= 1 else sh[0]
        z = torch.randn((size, self.dim), generator=gen, device=gen.device,
                        dtype=self.L.dtype)
        return self.linear_transform(z)

    def ppf(self, u):
        """Rosenblatt transform; if u has fewer columns than dim, the other
        coordinates are 0.  A 1-D ``u`` is one column."""
        if u.ndim == 1:
            u = u[:, None]
        N, du = u.shape
        z = torch.special.ndtri(u)
        if du < self.dim:
            z = torch.cat([z, z.new_zeros(N, self.dim - du)], 1)
        return self.linear_transform(z)

    def posterior(self, x, Sigma=None):
        """Model: X_1..X_n ~ N(theta, Sigma), theta ~ self (scale 1)."""
        n = x.shape[0]
        eye = torch.eye(self.dim, dtype=self.cov.dtype,
                        device=self.cov.device)
        Sigma = eye if Sigma is None else torch.as_tensor(Sigma).to(eye)
        Siginv = torch.linalg.inv(Sigma)
        covinv = torch.linalg.inv(self.cov)
        Sigpost = torch.linalg.inv(covinv + n * Siginv)
        m = self.loc.expand(self.dim)
        mupost = Sigpost @ (m @ covinv + Siginv @ x.sum(0))
        return MvNormal(loc=mupost, cov=Sigpost)


class VaryingCovNormal(ProbDist):
    """Multivariate normal with a covariance a particle: ``cov`` (N, d, d)."""

    def __init__(self, loc=0.0, cov=None):
        self.loc = loc
        self.cov = torch.as_tensor(cov)
        self.L = _cholesky(self.cov)

    @property
    def dim(self):
        return self.cov.shape[-1]

    def linear_transform(self, z):
        return self.loc + torch.einsum("...ij,...j->...i", self.L, z)

    def rvs(self, gen, size=None):
        N = self.cov.shape[0] if size is None else size
        z = torch.randn((N, self.dim), generator=gen, device=gen.device,
                        dtype=self.L.dtype)
        return self.linear_transform(z)

    def logpdf(self, x):
        halflogdet = torch.log(
            torch.diagonal(self.L, dim1=-2, dim2=-1)).sum(-1)
        z = torch.linalg.solve_triangular(
            self.L, (x - self.loc)[..., None], upper=False)[..., 0]
        return -0.5 * (z * z).sum(-1) - halflogdet - self.dim * HALFLOG2PI


class IndepProd(ProbDist):
    """Product of independent univariate laws: (N, d) values.  A product
    of bool laws (``binary_smc.Bernoulli``) draws bool, of discrete laws
    int64, else float32.  A product of one law repeated whose ``logpdf``
    is elementwise (a law with ``elementwise`` true) takes the (N, d)
    values in one call."""

    def __init__(self, *dists):
        self.dists = list(dists)
        self.dim = len(dists)
        if all(d.dtype == "bool" for d in dists):
            self.dtype = "bool"
        elif all(d.dtype == DiscreteDist.dtype for d in dists):
            self.dtype = DiscreteDist.dtype
        else:
            self.dtype = ProbDist.dtype
        self._one_law = (bool(dists) and all(d is dists[0] for d in dists)
                         and getattr(dists[0], "elementwise", False))

    def logpdf(self, x):
        if self._one_law:
            return self.dists[0].logpdf(x).sum(-1)
        return sum(d.logpdf(x[..., i]) for i, d in enumerate(self.dists))

    @staticmethod
    def _stack(cols):
        dt = cols[0].dtype
        for c in cols[1:]:
            dt = torch.promote_types(dt, c.dtype)
        return torch.stack([c.to(dt) for c in cols], -1)

    def rvs(self, gen, size=None):
        return self._stack([d.rvs(gen, size=size) for d in self.dists])

    def ppf(self, u):
        return self._stack([d.ppf(u[..., i])
                            for i, d in enumerate(self.dists)])


def IID(law, k):
    """Joint law of k IID variables."""
    return IndepProd(*[law for _ in range(k)])


# ---------------------------------------------------------------------------
# structured distributions (priors over named parameters)
# ---------------------------------------------------------------------------

class Cond(ProbDist):
    """Conditional law: wraps ``law(x) -> ProbDist``."""

    def __init__(self, law, dim=1, dtype="float32"):
        self.law = law
        self.dim = dim
        self.dtype = dtype

    def __call__(self, x):
        return self.law(x)


class StructDist(ProbDist):
    """Law over dict-of-tensors particles: ``rvs`` returns an
    ``OrderedDict`` of (N,) or (N, dim) tensors, ``logpdf`` takes one.
    Chain-rule decompositions use :class:`Cond`; a plain dict is ordered
    by sorted key."""

    def __init__(self, laws):
        if isinstance(laws, OrderedDict):
            self.laws = laws
        elif isinstance(laws, dict):
            self.laws = OrderedDict((k, laws[k]) for k in sorted(laws))
        else:
            raise TypeError("StructDist requires a dict or OrderedDict")

    @property
    def dim(self):
        return sum(law.dim for law in self.laws.values())

    def logpdf(self, theta):
        lp = 0.0
        for par, law in self.laws.items():
            cond_law = law(theta) if callable(law) else law
            lp = lp + cond_law.logpdf(theta[par])
        return lp

    def rvs(self, gen, size=1):
        out = OrderedDict()
        for par, law in self.laws.items():
            cond_law = law(out) if callable(law) else law
            out[par] = cond_law.rvs(gen, size=size)
        return out
