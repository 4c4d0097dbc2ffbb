"""Every law of the port's ``distributions`` against the JAX package's.

Each law is built by the same code in both packages (``LAWS``: a function
of the module and an array converter), and fed the same numpy arrays:

- ``logpdf`` and ``ppf`` against the JAX law: rtol 1e-5 in float32, and
  for ``logpdf`` an atol of 1e-5, the float32 rounding of a sum of terms
  of ten or so (a value near 0 is a cancellation of them).  The
  ppfs that bisect a CDF (``Beta``, ``Gamma``, ``InvGamma``, ``Student``,
  ``Poisson``, ``Binomial``) also get an atol of 2e-6: the bisection's
  width (hi - lo) 2^-iters is below the float32 grid, so the two packages
  part where their CDFs, evaluated in different precisions, cross u on
  either side of a grid point.  Those that bisect ``betainc`` (``Beta``,
  ``Student``, ``Binomial``) get 1e-5 against the JAX law, whose float32
  ``betainc`` is more than 1e-5 off float64 on part of the grid of the
  test below, and are held at 2e-6 to scipy's float64 quantiles.
- ``betainc`` against ``jax.scipy.special.betainc`` at rtol 1e-5 wherever
  the JAX float32 value is itself within 1e-5 of scipy's float64 value,
  and against scipy's float64 everywhere (atol 1e-7, rtol 1e-5), with a
  and b from 1e-3 to 500 and x at 0 and 1.
- ``rvs`` by moments over 40,000 draws: the sample mean within 5 standard
  errors of the law's mean, and for light-tailed laws the sample variance
  within 5 standard errors (from the sample's fourth moment) of the law's
  variance; shape and dtype checked (float32, int64 for discrete laws).
- The same generator seed gives the same draws whatever torch's global
  seed is: nothing draws from torch's global generator.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import scipy.stats as spst
import torch
from jax.scipy.special import betainc as jax_betainc

import particles_tpu.distributions as jd
import particles_tpu_torch.distributions as td

RTOL = 1e-5
BISECT_ATOL = 2e-6
N_DRAWS = 40_000

rng = np.random.default_rng(0)
X_REAL = (2.0 * rng.normal(size=64)).astype(np.float32)
X_POS = rng.gamma(2.0, size=64).astype(np.float32)
X_01 = np.concatenate([rng.uniform(0.001, 0.999, 62),
                       [-0.5, 1.5]]).astype(np.float32)
U = rng.uniform(0.01, 0.99, 64).astype(np.float32)
COV = np.array([[1.0, 0.3], [0.3, 0.5]], np.float32)


def _jax_arr(a):
    return jnp.asarray(a)


def _torch_arr(a):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a.astype(np.float32))


def _var_mix():
    p, mu, s = np.array([0.3, 0.7]), np.array([-1.0, 2.0]), np.array([.5, 1])
    m = (p * mu).sum()
    return m, (p * (s ** 2 + mu ** 2)).sum() - m * m


def _struct(m, c):
    return m.StructDist({
        "mu": m.Normal(loc=0.5, scale=1.0),
        "sigma": m.Cond(lambda th: m.Gamma(a=2.0, b=1.0 + th["mu"] ** 2)),
    })


def _dirichlet_x():
    return rng.dirichlet([1.5, 2.0, 3.0], size=32).astype(np.float32)


X_DIRICHLET = _dirichlet_x()
LOC_VC = rng.normal(size=(32, 2)).astype(np.float32)
A_VC = rng.normal(size=(32, 2, 2)).astype(np.float32)
COV_VC = (A_VC @ A_VC.transpose(0, 2, 1) + 0.5 * np.eye(2)).astype(
    np.float32)
X_VC = rng.normal(size=(32, 2)).astype(np.float32)
P_ROWS = rng.dirichlet(np.ones(4), size=32).astype(np.float32)
X_ROWS = rng.integers(0, 4, 32)
TN = spst.truncnorm((-1.0 - 0.3) / 1.2, (2.0 - 0.3) / 1.2, loc=0.3, scale=1.2)
ALPHAS = np.array([1.5, 2.0, 3.0])

# name: (build(module, converter), logpdf x, ppf?, (mean, var) or None,
# check the variance?)
LAWS = {
    "Normal": (lambda m, c: m.Normal(loc=0.3, scale=1.7), X_REAL, True,
               (0.3, 1.7 ** 2), True),
    "Logistic": (lambda m, c: m.Logistic(loc=0.3, scale=1.7), X_REAL, True,
                 (0.3, 1.7 ** 2 * math.pi ** 2 / 3), True),
    "Laplace": (lambda m, c: m.Laplace(loc=0.3, scale=1.7), X_REAL, True,
                (0.3, 2 * 1.7 ** 2), True),
    "Beta": (lambda m, c: m.Beta(a=2.5, b=0.7), X_01, True,
             (2.5 / 3.2, 2.5 * 0.7 / (3.2 ** 2 * 4.2)), True),
    "Gamma": (lambda m, c: m.Gamma(a=2.3, b=1.5), X_POS, True,
              (2.3 / 1.5, 2.3 / 1.5 ** 2), True),
    "InvGamma": (lambda m, c: m.InvGamma(a=5.5, b=2.0), X_POS, True,
                 (2.0 / 4.5, 4.0 / (4.5 ** 2 * 3.5)), False),
    "LogNormal": (lambda m, c: m.LogNormal(mu=0.2, sigma=0.8), X_POS, True,
                  (math.exp(0.2 + 0.32),
                   (math.exp(0.64) - 1) * math.exp(0.4 + 0.64)), False),
    "Uniform": (lambda m, c: m.Uniform(a=-1.0, b=2.5), X_REAL, True,
                (0.75, 3.5 ** 2 / 12), True),
    "Student": (lambda m, c: m.Student(df=6.5, loc=0.2, scale=1.3), X_REAL,
                True, (0.2, 1.3 ** 2 * 6.5 / 4.5), False),
    "FlatNormal": (lambda m, c: m.FlatNormal(loc=0.5), X_REAL, False, None,
                   False),
    "Dirac": (lambda m, c: m.Dirac(loc=0.5),
              np.array([0.5, 0.25, -1.0, 0.5], np.float32), True, (0.5, 0.0),
              False),
    "TruncNormal": (lambda m, c: m.TruncNormal(mu=0.3, sigma=1.2, a=-1.0,
                                               b=2.0),
                    X_REAL, True, (TN.mean(), TN.var()), True),
    "Poisson": (lambda m, c: m.Poisson(rate=3.5),
                np.arange(11, dtype=np.float32), True, (3.5, 3.5), True),
    "Binomial": (lambda m, c: m.Binomial(n=12, p=0.3),
                 np.arange(13, dtype=np.float32), True, (3.6, 2.52), True),
    "Geometric": (lambda m, c: m.Geometric(p=0.3),
                  np.arange(1, 11, dtype=np.float32), True,
                  (1 / 0.3, 0.7 / 0.09), True),
    "NegativeBinomial": (lambda m, c: m.NegativeBinomial(n=3, p=0.4),
                         np.arange(11, dtype=np.float32), False,
                         (3 * 0.6 / 0.4, 3 * 0.6 / 0.16), True),
    "Categorical": (lambda m, c: m.Categorical(p=c(np.array(
        [0.2, 0.5, 0.3], np.float32))), np.array([0, 1, 2, 1, 0]), False,
        (1.1, 0.2 * 1.1 ** 2 + 0.5 * 0.1 ** 2 + 0.3 * 0.9 ** 2), True),
    "DiscreteUniform": (lambda m, c: m.DiscreteUniform(lo=1, hi=5),
                        np.array([0, 1, 2, 4, 5]), False, (2.5, 1.25), True),
    "LinearD": (lambda m, c: m.LinearD(m.Normal(loc=0.3, scale=1.2), a=2.0,
                                       b=-1.0), X_REAL, True,
                (-0.4, 4 * 1.44), True),
    "LogD": (lambda m, c: m.LogD(m.Gamma(a=2.3, b=1.5)), X_REAL, True,
             (sps.digamma(2.3) - math.log(1.5), sps.polygamma(1, 2.3)),
             True),
    "LogitD": (lambda m, c: m.LogitD(m.Beta(a=2.0, b=3.0)), X_REAL, True,
               (sps.digamma(2.0) - sps.digamma(3.0),
                sps.polygamma(1, 2.0) + sps.polygamma(1, 3.0)), True),
    "Mixture": (lambda m, c: m.Mixture(c(np.array([0.3, 0.7], np.float32)),
                                       m.Normal(loc=-1.0, scale=0.5),
                                       m.Normal(loc=2.0, scale=1.0)),
                X_REAL, False, _var_mix(), True),
    "MixMissing": (lambda m, c: m.MixMissing(
        pmiss=0.2, base_dist=m.Normal(loc=0.0, scale=1.0)),
        np.concatenate([X_REAL[:8], [np.nan, np.nan]]).astype(np.float32),
        False, None, False),
    "Dirichlet": (lambda m, c: m.Dirichlet(alphas=c(ALPHAS.astype(
        np.float32))), X_DIRICHLET, False, None, False),
    "MvNormal": (lambda m, c: m.MvNormal(loc=c(np.array(
        [1.0, -1.0], np.float32)), cov=c(COV)), X_VC, True, None, False),
    "VaryingCovNormal": (lambda m, c: m.VaryingCovNormal(
        loc=c(LOC_VC), cov=c(COV_VC)), X_VC, False, None, False),
    "IndepProd": (lambda m, c: m.IndepProd(m.Normal(loc=0.3, scale=1.2),
                                           m.Gamma(a=2.3, b=1.5)),
                  np.abs(X_VC), True, None, False),
    "IID": (lambda m, c: m.IID(m.Normal(loc=0.3, scale=1.2), 3),
            rng.normal(size=(16, 3)).astype(np.float32), True, None, False),
    "StructDist": (_struct, None, False, None, False),
}
PPF_LAWS = [k for k, v in LAWS.items() if v[2]]
BISECTED = {"Beta", "Gamma", "InvGamma", "Student", "Poisson", "Binomial"}
BY_BETAINC = {"Beta": spst.beta(2.5, 0.7),
              "Student": spst.t(6.5, loc=0.2, scale=1.3),
              "Binomial": spst.binom(12, 0.3)}


def _laws(name):
    build = LAWS[name][0]
    return build(jd, _jax_arr), build(td, _torch_arr)


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(t, np.float64),
                               np.asarray(j, np.float64), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(LAWS))
def test_logpdf_matches_jax(name):
    jlaw, tlaw = _laws(name)
    x = LAWS[name][1]
    if name == "StructDist":
        theta = {"mu": X_REAL[:16], "sigma": X_POS[:16]}
        got = tlaw.logpdf({k: torch.from_numpy(v) for k, v in theta.items()})
        want = jlaw.logpdf({k: jnp.asarray(v) for k, v in theta.items()})
    else:
        got = tlaw.logpdf(_torch_arr(x))
        want = jlaw.logpdf(jnp.asarray(x))
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("name", PPF_LAWS)
def test_ppf_matches_jax(name):
    jlaw, tlaw = _laws(name)
    u = U if tlaw.dim == 1 else U[:32].reshape(16, 2)
    if name == "IID":
        u = U[:48].reshape(16, 3)
    got = tlaw.ppf(torch.from_numpy(u))
    want = jlaw.ppf(jnp.asarray(u))
    assert got.shape == tuple(want.shape)
    atol = BISECT_ATOL if name in BISECTED else 1e-6
    if name == "IndepProd":      # its second column bisects Gamma's CDF
        atol = BISECT_ATOL
    if name in BY_BETAINC:
        _close(got, BY_BETAINC[name].ppf(u.astype(np.float64)),
               atol=BISECT_ATOL)
        atol = 1e-5
    _close(got, want, atol=atol)


def test_categorical_rows_and_student_cdf_match_jax():
    jlaw = jd.Categorical(p=jnp.asarray(P_ROWS))
    tlaw = td.Categorical(p=torch.from_numpy(P_ROWS))
    _close(tlaw.logpdf(torch.from_numpy(X_ROWS)),
           jlaw.logpdf(jnp.asarray(X_ROWS)))
    t = X_REAL
    _close(td.Student(df=3.5)._std_cdf(torch.from_numpy(t)),
           jd.Student(df=3.5)._std_cdf(jnp.asarray(t)), atol=1e-6)


def test_betainc_matches_jax_and_float64():
    grid = np.meshgrid([1e-3, 0.5, 1.0, 2.5, 30.0, 500.0],
                       [1e-3, 0.7, 1.0, 4.0, 25.0, 300.0],
                       [0.0, 1e-6, 0.1, 0.37, 0.5, 0.9, 1 - 1e-6, 1.0],
                       indexing="ij")
    a, b, x = (v.ravel().astype(np.float32) for v in grid)
    got = td.betainc(*(torch.from_numpy(v) for v in (a, b, x))).numpy()
    assert got.dtype == np.float32
    want = np.asarray(jax_betainc(*(jnp.asarray(v) for v in (a, b, x))))
    exact = sps.betainc(*(v.astype(np.float64) for v in (a, b, x)))
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-7)
    jax_accurate = np.abs(want - exact) <= 1e-5 * np.abs(exact)
    assert jax_accurate.sum() > len(a) // 2
    np.testing.assert_allclose(got[jax_accurate], want[jax_accurate],
                               rtol=1e-5)
    assert np.all(got[x == 0.0] == 0.0) and np.all(got[x == 1.0] == 1.0)


def test_betainc_fixed_terms_reach_float64_up_to_5e4():
    """``BETAINC_TERMS`` suffices where the fraction converges slowest: x
    near the switch point (a + 1) / (a + b + 2), a and b up to 5e4, in
    float64 against SciPy (atol 1e-9, rtol 1e-7: lgamma's rounding of the
    front factor at a ~ 5e4, not the fraction, sets the error)."""
    ab = np.geomspace(1e-3, 5e4, 25)
    a, b = np.meshgrid(ab, ab, indexing="ij")
    s = (a + 1.0) / (a + b + 2.0)
    off = np.linspace(-0.02, 0.02, 9) * np.sqrt(s * (1.0 - s))[..., None]
    x = np.clip(s[..., None] + off, 0.0, 1.0).ravel()
    a = np.broadcast_to(a[..., None], off.shape).ravel()
    b = np.broadcast_to(b[..., None], off.shape).ravel()
    got = td.betainc(*(torch.from_numpy(v) for v in (a, b, x))).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, sps.betainc(a, b, x), rtol=1e-7,
                               atol=1e-9)


def _draws(name, gen, n=N_DRAWS):
    if name == "VaryingCovNormal":     # a covariance a draw
        reps = n // len(LOC_VC)
        tlaw = td.VaryingCovNormal(
            loc=torch.from_numpy(np.tile(LOC_VC, (reps, 1))),
            cov=torch.from_numpy(np.tile(COV_VC, (reps, 1, 1))))
    else:
        _, tlaw = _laws(name)
    return tlaw, tlaw.rvs(gen, size=n)


@pytest.mark.parametrize("name", list(LAWS))
def test_rvs_shapes_dtypes_and_moments(name):
    gen = torch.Generator().manual_seed(7)
    tlaw, x = _draws(name, gen)
    _, _, _, moments, check_var = LAWS[name]
    want_shape = (N_DRAWS,) if tlaw.dim == 1 else (N_DRAWS, tlaw.dim)
    if name == "StructDist":
        assert list(x) == ["mu", "sigma"]
        assert x["mu"].shape == x["sigma"].shape == (N_DRAWS,)
        assert bool(tlaw.logpdf(tlaw.rvs(gen, size=5)).isfinite().all())
        x, moments, want_shape = x["mu"], (0.5, 1.0), (N_DRAWS,)
    assert x.shape == want_shape, (x.shape, want_shape)
    discrete = isinstance(tlaw, td.DiscreteDist)
    assert x.dtype == (torch.int64 if discrete else torch.float32)
    xs = x.double().numpy()
    if name == "FlatNormal":
        assert np.isnan(xs).all()
        return
    if name == "MixMissing":
        frac = np.isnan(xs).mean()
        assert abs(frac - 0.2) < 5 * math.sqrt(0.2 * 0.8 / N_DRAWS)
        xs, moments = xs[~np.isnan(xs)], (0.0, 1.0)
    if name == "Dirichlet":
        a0 = ALPHAS.sum()
        mean = ALPHAS / a0
        var = mean * (1 - mean) / (a0 + 1)
        assert np.allclose(xs.sum(1), 1.0, atol=1e-5)
        assert np.all(np.abs(xs.mean(0) - mean) < 5 * np.sqrt(var / N_DRAWS))
        return
    if name in ("MvNormal", "VaryingCovNormal"):
        loc = (np.array([1.0, -1.0]) if name == "MvNormal"
               else np.tile(LOC_VC, (N_DRAWS // 32, 1)))
        var = (np.diag(COV) if name == "MvNormal"
               else np.diagonal(COV_VC, axis1=1, axis2=2).mean(0))
        assert np.all(np.abs((xs - loc).mean(0)) < 5 * np.sqrt(var / N_DRAWS))
        return
    if name in ("IndepProd", "IID"):
        cols = ([(0.3, 1.44), (2.3 / 1.5, 2.3 / 1.5 ** 2)]
                if name == "IndepProd" else [(0.3, 1.44)] * 3)
        for j, (m, v) in enumerate(cols):
            assert abs(xs[:, j].mean() - m) < 5 * math.sqrt(v / N_DRAWS)
        return
    if name == "Dirac":
        assert np.all(xs == 0.5)
        return
    mean, var = moments
    n = len(xs)
    assert abs(xs.mean() - mean) < 5 * math.sqrt(var / n), (xs.mean(), mean)
    if check_var:
        c = xs - xs.mean()
        se_var = math.sqrt(max(np.mean(c ** 4) - np.mean(c ** 2) ** 2,
                               0.0) / n)
        assert abs(c.var() - var) < 5 * se_var, (c.var(), var)


@pytest.mark.parametrize("name", list(LAWS))
def test_draws_follow_the_generator_only(name):
    out = []
    for global_seed in (0, 1):
        torch.manual_seed(global_seed)
        _, x = _draws(name, torch.Generator().manual_seed(3), n=64)
        out.append(x if isinstance(x, dict) else {"x": x})
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k].numpy(), out[1][k].numpy())


def test_truncnormal_far_in_a_tail():
    """On [4, 6] the float32 CDF is within 3.2e-5 of 1 and its grid is
    coarse: the draws keep the law's support and mean (the law's mean and
    sd from scipy), and the ppf is monotone and inside [a, b]."""
    law = td.TruncNormal(mu=0.0, sigma=1.0, a=4.0, b=6.0)
    x = law.rvs(torch.Generator().manual_seed(1), size=N_DRAWS).double()
    exact = spst.truncnorm(4.0, 6.0)
    assert float(x.min()) >= 4.0 and float(x.max()) <= 6.0
    assert abs(float(x.mean()) - exact.mean()) < 5 * exact.std() / math.sqrt(
        N_DRAWS)
    assert abs(float(x.std()) - exact.std()) < 0.05 * exact.std()
    q = law.ppf(torch.linspace(0.0, 1.0, 1001))
    assert bool((q[1:] >= q[:-1]).all()) and float(q[0]) >= 4.0
    assert float(q[-1]) <= 6.0
    lp = law.logpdf(torch.tensor([4.5, 3.0, 6.5]))
    np.testing.assert_allclose(float(lp[0]), exact.logpdf(4.5), rtol=1e-5)
    assert bool(torch.isinf(lp[1:]).all())


def test_categorical_rows_draw_one_category_a_row():
    gen = torch.Generator().manual_seed(2)
    p = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
    x = td.Categorical(p=p.repeat(1000, 1)).rvs(gen)
    assert x.dtype == torch.int64 and x.shape == (3000,)
    assert torch.equal(x, torch.tensor([0, 2, 1]).repeat(1000))
    p = torch.from_numpy(P_ROWS[:1]).repeat(N_DRAWS, 1)
    freq = torch.bincount(td.Categorical(p=p).rvs(gen), minlength=4)
    freq = freq.double().numpy() / N_DRAWS
    se = np.sqrt(P_ROWS[0] * (1 - P_ROWS[0]) / N_DRAWS)
    assert np.all(np.abs(freq - P_ROWS[0]) < 5 * se)


def test_array_parameters_and_posteriors():
    """(N,) parameters make N laws; the conjugate posteriors as in the JAX
    package."""
    gen = torch.Generator().manual_seed(4)
    loc = torch.linspace(-3.0, 3.0, 50)
    assert td.Gamma(a=loc.abs() + 1.0).rvs(gen).shape == (50,)
    assert td.Poisson(rate=loc.abs()).rvs(gen).shape == (50,)
    assert td.Dirac(loc=loc).rvs(gen) is loc
    x = rng.normal(size=20).astype(np.float32)
    for build in (lambda m: m.Normal(loc=0.3, scale=1.5).posterior(
                      m_arr(m, x), sigma=0.7),
                  lambda m: m.TruncNormal(mu=0.3, sigma=1.5, a=-1.0,
                                          b=2.0).posterior(m_arr(m, x),
                                                           s=0.7)):
        j, t = build(jd), build(td)
        for attr in ("loc", "scale") if isinstance(t, td.Normal) else (
                "mu", "sigma"):
            _close(getattr(t, attr), getattr(j, attr))
    for cls in ("Gamma", "InvGamma"):
        j = getattr(jd, cls)(a=2.0, b=3.0).posterior(jnp.asarray(x))
        t = getattr(td, cls)(a=2.0, b=3.0).posterior(torch.from_numpy(x))
        _close(t.a, j.a)
        _close(t.b, j.b)


def m_arr(m, x):
    return jnp.asarray(x) if m is jd else torch.from_numpy(x)
