"""SMC² for stochastic volatility with leverage (the port's ``SMC2`` over
``StochVolLeverage``, its ``InnerPF`` rows) against the plain float64
reference ``tests/plain_sv_leverage.py`` on GBP/USD 1997-98 returns.

- One batched inner step and a replay, from the same draws as the
  reference's row-by-row step (the systematic uniform and the transition's
  normals): states, log-weights and increments within 1e-5.  The program
  is float32 and the reference float64: each value is a few dozen float32
  operations deep over six steps, with |rho| < 1 damping the state's
  error, so it stays near 1e-6 of itself; a wrong law, a dropped leverage
  term or a wrong ancestor moves it by 1e-2 or more.
- The inner log-likelihood at Nx = 4096 against the exact one of the grid
  filter.
- SMC² with only rho free against a quadrature over rho of the grid
  filter: the evidence and the posterior mean.
- The prior's log-density agrees with the program's at a uniform's ends
  as float32 states them.
"""

import math

import numpy as np
import pytest
import torch
from scipy.special import logsumexp

import plain_sv_leverage as ref
from particles_tpu_torch import datasets, inner_pf
from particles_tpu_torch import distributions as dists
from particles_tpu_torch import smc_samplers as ssp
from particles_tpu_torch import state_space_models as ssms
from particles_tpu_torch.core import SMC

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These runs are many small tensor ops: on one thread each, where a
    thread per core makes every op wait on the others, 50 times slower
    beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

THETA = {"mu": [-1.4, -0.6, -1.0], "rho": [-0.2, 0.9, 0.5],
         "sigma": [0.6, 0.25, 0.4], "phi": [0.4, -0.7, 0.9]}


def _returns(T):
    return datasets.GBP_vs_USD_9798().data[:T].astype(np.float32)


def _theta(values=THETA, dtype=torch.float32):
    return {k: torch.tensor(v, dtype=dtype) for k, v in values.items()}


def _given(eps, law):
    """The transition ``law`` driven by the normals ``eps`` (B, Nx)."""
    return law.loc + law.scale * torch.from_numpy(eps.reshape(-1))


def test_inner_steps_and_replay_match_the_reference():
    """B = 3 rows, Nx = 16, 6 steps from the same draws, then a replay to
    t = 5 of the same draws; both branches (a row that resamples and one
    that does not) occur."""
    B, Nx, T = 3, 16, 6
    y = _returns(T)
    rng = np.random.default_rng(7)
    eps = rng.normal(size=(T, B, Nx)).astype(np.float32)
    us = rng.uniform(size=(T, B)).astype(np.float32)
    pf = inner_pf.InnerPF(ssms.Bootstrap, ssms.StochVolLeverage,
                          torch.from_numpy(y), _theta(), Nx)
    draws = [(torch.from_numpy(us[t]),
              lambda fk, t, xp, e=eps[t]: _given(e, fk.ssm.PX(t, xp)))
             for t in range(1, T)]

    def move0(fk):
        return _given(eps[0], fk.ssm.PX0())

    xs, lws, ll = pf.init_with(move0)
    th64 = _theta(dtype=torch.float64)
    rx, rlw, rll = ref.rows_init(y[0], th64, eps[0])
    flags = []
    for t in range(T):
        if t > 0:
            flags.append(ref.row_ess(rlw) < 0.5 * Nx)
            xs, lws, inc = pf.step_with(t, xs, lws, *draws[t - 1])
            rx, rlw, rinc = ref.rows_step(y[t], th64, rx, rlw, us[t], eps[t])
            np.testing.assert_allclose(inc.numpy(), rinc.numpy(), rtol=TOL,
                                       atol=TOL)
            ll, rll = ll + inc, rll + rinc
        np.testing.assert_allclose(xs.numpy(), rx.numpy(), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(lws.numpy(), rlw.numpy(), rtol=TOL,
                                   atol=TOL)
    flags = torch.stack(flags)
    assert flags.any() and not flags.all()
    xr, lwr, llr = pf.replay(None, 5, draws=(move0, draws[:4]))
    rx, rlw, rll = ref.rows_init(y[0], th64, eps[0])
    for t in range(1, 5):
        rx, rlw, rinc = ref.rows_step(y[t], th64, rx, rlw, us[t], eps[t])
        rll = rll + rinc
    for got, want in ((xr, rx), (lwr, rlw), (llr, rll)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL)


def test_inner_loglik_matches_the_grid_filter():
    """4 θ's, T = 30, 16 filters of Nx = 4096 each: the filters' mean
    log-likelihood within 4 of its Monte Carlo sd (from the 16) of the
    exact one less s^2 / 2, the estimator's log-normal bias, and the
    halved grid within 1e-6 of the grid.  The number is a t statistic of
    15 degrees of freedom: over generator seeds 0-7, 31 of its 32 readings
    lay within 2.72, and one read 5.11 where the 16 filters' sd came out
    at 0.59 of the other seeds'."""
    T, R = 30, 16
    y = _returns(T)
    th = {"mu": [-1.4, -0.5, -1.0, 0.0], "rho": [-0.1, 0.9, 0.5, 0.98],
          "sigma": [0.6, 0.2, 0.3, 0.15], "phi": [0.05, -0.5, 0.3, 0.9]}
    rows = {k: torch.tensor(v).repeat_interleave(R) for k, v in th.items()}
    pf = inner_pf.InnerPF(ssms.Bootstrap, ssms.StochVolLeverage,
                          torch.from_numpy(y), rows, 4096)
    ll = pf.loglik(torch.Generator().manual_seed(0), T).double().reshape(
        4, R)
    exact = ref.grid_loglik(y, _theta(th, torch.float64))[:, -1]
    half = ref.grid_loglik(y, _theta(th, torch.float64), scale=0.5)[:, -1]
    assert float((exact - half).abs().max()) < 1e-6
    s = ll.std(1)
    gap = (ll.mean(1) - (exact - 0.5 * s * s)) / (s / math.sqrt(R))
    assert float(gap.abs().max()) < 4.0, gap


class SVLrho(ssms.StochVolLeverage):
    """Only rho free: mu, sigma and phi at the source's defaults."""

    default_params = {"mu": -1.02, "rho": 0.9702, "sigma": 0.178,
                      "phi": 0.0}


@pytest.fixture(scope="module")
def rho_quadrature():
    """T = 40: the evidence and the posterior mean of rho under U(-0.99,
    0.99), by 64-point Gauss-Legendre over rho of the grid filter."""
    T = 40
    y = _returns(T)
    x, w = np.polynomial.legendre.leggauss(64)
    rho, w = 0.99 * x, 0.99 * w
    n = rho.shape[0]
    th = {"mu": torch.full((n,), -1.02, dtype=torch.float64),
          "rho": torch.from_numpy(rho),
          "sigma": torch.full((n,), 0.178, dtype=torch.float64),
          "phi": torch.zeros(n, dtype=torch.float64)}
    L = ref.grid_loglik(y, th)[:, -1].numpy()
    post = w * np.exp(L - L.max())
    return y, logsumexp(L, b=w) - math.log(1.98), float(
        np.sum(post * rho) / post.sum())


def test_smc2_evidence_and_posterior_match_the_quadrature(rho_quadrature):
    """Ntheta = 1024, Nx = 64, len_chain 4, the exchange threshold 0.1;
    4 seeds.  Eight seeds on the CPU spread by 0.008 in the evidence and
    0.03 in the posterior mean; the limits are 6 and 5 sd of a 4-seed
    mean (0.4 and 0.25 in the LinearGauss test)."""
    y, exact_ev, exact_mean = rho_quadrature
    prior = dists.StructDist({"rho": dists.Uniform(a=-0.99, b=0.99)})
    evs, means = [], []
    for seed in range(4):
        fk = ssp.SMC2(ssm_cls=SVLrho, prior=prior, data=y, init_Nx=64,
                      len_chain=4, ar_to_increase_Nx=0.1, device="cpu")
        pf = SMC(fk=fk, N=1024, seed=seed)
        pf.run()
        evs.append(float(pf.logLt))
        means.append(float((pf.wgts.W * pf.X.theta["rho"]).sum()))
    assert abs(np.mean(evs) - exact_ev) < 0.025, (evs, exact_ev)
    assert abs(np.mean(means) - exact_mean) < 0.08, (means, exact_mean)


def test_prior_agrees_with_the_program_at_the_float32_ends():
    """A float32 uniform draw at u = 0 is float32(-0.99), which lies below
    -0.99 in float64: the reference takes the ends in θ's own precision,
    as the program does, and leaves a value past them outside."""
    prior = dists.StructDist({
        "mu": dists.Normal(loc=-1.0, scale=2.0),
        "rho": dists.Uniform(a=-0.99, b=0.99),
        "sigma": dists.Gamma(a=2.0, b=4.0),
        "phi": dists.Uniform(a=-0.99, b=0.99)})
    th = _theta({"mu": [-1.0, -1.0, -1.0], "rho": [-0.99, 0.5, -0.99],
                 "sigma": [0.3, 0.3, 0.3], "phi": [0.2, 0.99, -0.991]})
    want = prior.logpdf(th).double()
    got = ref.log_prior(th)
    assert torch.isinf(got[2]) and torch.isinf(want[2])
    assert torch.isfinite(got[:2]).all()
    assert torch.allclose(got[:2], want[:2], rtol=0, atol=1e-6)
