"""The port's model pieces against the JAX package: ``Normal``,
``MvNormal``, the Kalman filter and smoother of ``LinearGauss`` and a
two-dimensional ``MVLinearGauss``, with parameters carried across by
``particles_tpu_torch.convert``.

Tolerances: rtol 1e-5 for single distribution evaluations in float32;
rtol 1e-4 (atol 1e-5 for entries near zero) for the Kalman recursions,
whose float32 rounding compounds over T steps.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particles_tpu.distributions as jd
import particles_tpu.kalman as jk
import particles_tpu_torch.distributions as td
import particles_tpu_torch.kalman as tk
from particles_tpu_torch import convert


def _close(t, j, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def test_normal_matches_jax():
    rng = np.random.default_rng(0)
    loc = rng.normal(size=200).astype(np.float32)
    x = np.float32(0.3)
    _close(td.Normal(loc=torch.from_numpy(loc), scale=0.7).logpdf(
        torch.tensor(x)), jd.Normal(loc=jnp.asarray(loc), scale=0.7).logpdf(x))
    xs = rng.normal(size=200).astype(np.float32)
    _close(td.Normal(scale=2.0).logpdf(torch.from_numpy(xs)),
           jd.Normal(scale=2.0).logpdf(jnp.asarray(xs)))
    u = rng.uniform(0.001, 0.999, size=200).astype(np.float32)
    _close(td.Normal(loc=1.5, scale=0.5).ppf(torch.from_numpy(u)),
           jd.Normal(loc=1.5, scale=0.5).ppf(jnp.asarray(u)), atol=1e-6)


def test_normal_rvs_shapes_and_moments():
    g = torch.Generator().manual_seed(0)
    x = td.Normal(loc=1.0, scale=2.0).rvs(g, size=20000)
    assert x.shape == (20000,) and x.dtype == torch.float32
    assert abs(float(x.mean()) - 1.0) < 0.05
    assert abs(float(x.std()) - 2.0) < 0.05
    loc = torch.zeros(5, dtype=torch.float64)
    assert td.Normal(loc=loc).rvs(g).shape == (5,)
    assert td.Normal(loc=loc).rvs(g).dtype == torch.float64
    assert td.Normal().rvs(g).shape == ()


@pytest.mark.parametrize("batched_loc", [False, True])
def test_mvnormal_logpdf_matches_jax(batched_loc):
    rng = np.random.default_rng(1)
    cov = np.array([[1.0, 0.3], [0.3, 0.5]], np.float32)
    loc = (rng.normal(size=(100, 2)) if batched_loc
           else rng.normal(size=2)).astype(np.float32)
    x = rng.normal(size=(100, 2)).astype(np.float32)
    t = td.MvNormal(loc=torch.from_numpy(loc), scale=1.3,
                    cov=torch.from_numpy(cov)).logpdf(torch.from_numpy(x))
    j = jd.MvNormal(loc=jnp.asarray(loc), scale=1.3,
                    cov=jnp.asarray(cov)).logpdf(jnp.asarray(x))
    _close(t, j)
    g = torch.Generator().manual_seed(0)
    draws = td.MvNormal(loc=torch.zeros(2), cov=torch.from_numpy(cov)).rvs(
        g, size=50000)
    assert draws.shape == (50000, 2)
    np.testing.assert_allclose(np.cov(draws.numpy().T), cov, atol=0.03)
    with pytest.raises(ValueError):
        td.MvNormal(loc=0.0)


def _ar_data(T, dy, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((T, dy))
    for t in range(1, T):
        x[t] = 0.8 * x[t - 1] + rng.normal(size=dy)
    y = x + 0.5 * rng.normal(size=(T, dy))
    return (y[:, 0] if dy == 1 else y).astype(np.float32)


def _kalman_pair(jssm, tssm, y):
    jkf = jk.Kalman(ssm=jssm, data=jnp.asarray(y))
    jkf.smoother()
    tkf = tk.Kalman(ssm=tssm, data=torch.from_numpy(y))
    tkf.smoother()
    return jkf, tkf


def _assert_kalman_close(jkf, tkf):
    for name in ("pred", "filt", "smth"):
        j, t = getattr(jkf, name), getattr(tkf, name)
        assert t.mean.shape == j.mean.shape and t.cov.shape == j.cov.shape
        _close(t.mean, j.mean, rtol=1e-4, atol=1e-5)
        _close(t.cov, j.cov, rtol=1e-4, atol=1e-5)
    _close(tkf.logpyt, jkf.logpyt, rtol=1e-4, atol=1e-5)
    _close(tkf.logLt, jkf.logLt, rtol=1e-4)


def test_kalman_linear_gauss_matches_jax():
    jssm = jk.LinearGauss(rho=0.8, sigmaX=1.2, sigmaY=0.5)
    params = {k: np.asarray(getattr(jssm, k)) for k in jssm.default_params}
    tssm = convert.ssm_from_params("LinearGauss", params, device="cpu")
    assert isinstance(tssm, tk.LinearGauss)
    assert tssm.sigma0 == float(params["sigma0"])
    _assert_kalman_close(*_kalman_pair(jssm, tssm, _ar_data(30, 1, 0)))


def test_kalman_mv_linear_gauss_matches_jax():
    mats = dict(
        F=np.array([[0.5, 0.1], [0.0, 0.8]], np.float32),
        G=np.array([[1.0, 0.0], [0.5, 1.0]], np.float32),
        covX=np.array([[1.0, 0.3], [0.3, 0.5]], np.float32),
        covY=0.25 * np.eye(2, dtype=np.float32),
        mu0=np.array([0.1, -0.2], np.float32),
        cov0=np.eye(2, dtype=np.float32),
    )
    jssm = jk.MVLinearGauss(**{k: jnp.asarray(v) for k, v in mats.items()})
    params = {k: np.asarray(getattr(jssm, k)) for k in mats}
    tssm = convert.ssm_from_params("MVLinearGauss", params, device="cpu")
    _assert_kalman_close(*_kalman_pair(jssm, tssm, _ar_data(30, 2, 1)))


def test_filter_step_asarray_matches_jax():
    rng = np.random.default_rng(2)
    G = np.array([[1.0, 0.5]], np.float32)
    covY = np.array([[0.3]], np.float32)
    cov = np.array([[1.0, 0.2], [0.2, 0.7]], np.float32)
    means = rng.normal(size=(50, 2)).astype(np.float32)
    yt = np.array([0.4], np.float32)
    jf, jl = jk.filter_step_asarray(
        jnp.asarray(G), jnp.asarray(covY),
        jk.MeanAndCov(mean=jnp.asarray(means), cov=jnp.asarray(cov)),
        jnp.asarray(yt))
    tf, tl = tk.filter_step_asarray(
        torch.from_numpy(G), torch.from_numpy(covY),
        tk.MeanAndCov(mean=torch.from_numpy(means), cov=torch.from_numpy(cov)),
        torch.from_numpy(yt))
    _close(tf.mean, jf.mean, rtol=1e-5, atol=1e-6)
    _close(tf.cov, jf.cov, rtol=1e-5)
    _close(tl, jl, rtol=1e-5)


def test_guarniero_model_and_unported_models():
    t = tk.MVLinearGauss_Guarniero_etal(alpha=0.4, dx=3)
    j = jk.MVLinearGauss_Guarniero_etal(alpha=0.4, dx=3)
    _close(t.F, j.F)
    with pytest.raises(NotImplementedError, match="ROADMAP A.5"):
        convert.ssm_from_params("NoSuchModel", {}, device="cpu")


def test_simulate_and_params():
    ssm = tk.LinearGauss(rho=0.5)
    assert ssm.sigmaY == 0.2 and abs(ssm.sigma0 - 1 / np.sqrt(0.75)) < 1e-12
    x, y = ssm.simulate(torch.Generator().manual_seed(0), 40)
    assert x.shape == y.shape == (40,)
    mv = tk.MVLinearGauss_Guarniero_etal(dx=2)
    x, y = mv.simulate(torch.Generator().manual_seed(0), 10)
    assert x.shape == y.shape == (10, 2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tk.LinearGauss(sigmaYY=0.3)
    assert any("did you mean 'sigmaY'" in str(m.message) for m in w)
