"""The port's model zoo, guided and auxiliary filters and HMM oracle
against the JAX package.

Parameters go from each JAX model to the port by
``convert.ssm_from_params``; both packages get the same numpy particles
and data.  Tolerances:

- log-densities of ``PX0``/``PX``/``PY``, ``logeta`` and the auxiliary
  weights: rtol 1e-5 in float32, atol 1e-5 (the float32 rounding of sums
  of terms of ten or so), but rtol 1e-4 for ``BearingsOnly``'s ``PY``,
  which divides the float32 rounding of an arctangent by sigmaY = 1e-3;
  ``GuidedPF.logG`` and the reset weights, atol 1e-4: they are
  differences of terms up to ~100 in float32 (with the optimal proposal
  the terms cancel to a constant);
- ``BaumWelch`` forward, backward and ``logLt``: rtol 1e-5 (atol 1e-7 on
  probabilities, 1e-5 on log-likelihood factors near 0);
- whole filters by statistics over 8 fixed seeds, as in
  ``tests/test_torch_filter.py``: T = 25, N = 4096, the mean logLt within
  0.25 of the exact one (one run's sd is about 0.13 for the bootstrap
  filter, less for the guided and auxiliary ones);
- every zoo model through ``SMC`` with every scheme at a small size: logLt
  finite.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particles_tpu.core as jcore
import particles_tpu.hmm as jhmm
import particles_tpu.kalman as jk
import particles_tpu.resampling as jrs
import particles_tpu.state_space_models as jssms
import particles_tpu_torch.resampling as trs
from particles_tpu_torch import convert, core, hmm, kalman
from particles_tpu_torch import state_space_models as ssms

ATOL = 1e-5

MV_PARAMS = dict(
    mu=np.array([-0.5, 0.2], np.float32),
    covX=np.array([[0.3, 0.05], [0.05, 0.2]], np.float32),
    corY=np.array([[1.0, 0.4], [0.4, 1.0]], np.float32),
    F=np.array([[0.9, 0.05], [0.0, 0.8]], np.float32))
HMM_PARAMS = dict(
    trans_mat=np.array([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1],
                        [0.05, 0.15, 0.8]], np.float32),
    mus=np.array([-1.0, 0.5, 2.0], np.float32),
    sigmas=np.array([0.5, 0.7, 0.4], np.float32))

# name: the JAX model
ZOO = {
    "StochVol": lambda: jssms.StochVol(mu=-0.8, rho=0.95, sigma=0.3),
    "StochVolLeverage": lambda: jssms.StochVolLeverage(
        mu=-0.8, rho=0.95, sigma=0.3, phi=-0.4),
    "Gordon_etal": lambda: jssms.Gordon_etal(),
    "BearingsOnly": lambda: jssms.BearingsOnly(),
    "DiscreteCox": lambda: jssms.DiscreteCox(mu=0.5, sigma=0.6, phi=0.9),
    "MVStochVol": lambda: jssms.MVStochVol(
        **{k: jnp.asarray(v) for k, v in MV_PARAMS.items()}),
    "ThetaLogistic": lambda: jssms.ThetaLogistic(),
    "GaussianHMM": lambda: jhmm.GaussianHMM(
        **{k: jnp.asarray(v) for k, v in HMM_PARAMS.items()}),
    "LinearGauss": lambda: jk.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2),
    "MVLinearGauss": lambda: jk.MVLinearGauss(
        F=jnp.asarray(MV_PARAMS["F"]), G=jnp.eye(2),
        covX=jnp.asarray(MV_PARAMS["covX"]), covY=0.3 * jnp.eye(2)),
}
GUIDED = ["StochVol", "StochVolLeverage", "ThetaLogistic", "LinearGauss",
          "MVLinearGauss"]
APF = ["StochVol", "LinearGauss", "MVLinearGauss"]
SCHEMES = ["multinomial", "residual", "stratified", "systematic", "ssp",
           "killing", "idiotic"]


def _params(jm):
    if isinstance(jm, jk.MVLinearGauss):
        keys = ("F", "G", "covX", "covY", "mu0", "cov0")
    else:
        keys = jm.default_params
    return {k: np.asarray(getattr(jm, k)) for k in keys}


def _pair(name):
    jm = ZOO[name]()
    return jm, convert.ssm_from_params(name, _params(jm), device="cpu")


def _states(name, N, seed, shift=0.0):
    """N particles of the model's state space (numpy), from ``seed``."""
    rng = np.random.default_rng(seed)
    if name == "GaussianHMM":
        return rng.integers(0, 3, N)
    if name == "BearingsOnly":
        x = rng.normal(size=(N, 4)) * [1e-3, 1e-3, 0.1, 0.1]
        return (x + [3e-3, -3e-3, 1.0, 1.0]).astype(np.float32)
    if name in ("MVStochVol", "MVLinearGauss"):
        return (rng.normal(size=(N, 2)) * 0.5 - 0.3).astype(np.float32)
    return (rng.normal(size=N) * 0.7 + shift).astype(np.float32)


def _data(name, T=8):
    """Observations from the port's model (a CPU generator), as numpy."""
    _, tm = _pair(name)
    _, y = tm.simulate(torch.Generator().manual_seed(1), T)
    return y.numpy().astype(np.float32)


def _t(a):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a)


def _close(t, j, rtol=1e-5, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t, np.float64),
                               np.asarray(j, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", list(ZOO))
def test_model_log_densities_match_jax(name):
    jm, tm = _pair(name)
    N = 256
    xp, x = _states(name, N, 0), _states(name, N, 1)
    y = _data(name)
    _close(tm.PX0().logpdf(_t(x)), jm.PX0().logpdf(jnp.asarray(x)))
    for t in (1, 3):
        _close(tm.PX(t, _t(xp)).logpdf(_t(x)),
               jm.PX(t, jnp.asarray(xp)).logpdf(jnp.asarray(x)))
    # BearingsOnly's PY divides the float32 rounding of atan (a few ulps
    # apart between the two libraries) by sigmaY = 1e-3
    rtol = 1e-4 if name == "BearingsOnly" else 1e-5
    for t, prev in ((0, None), (3, xp)):
        _close(tm.PY(t, None if prev is None else _t(prev), _t(x)).logpdf(
                   _t(y[t])),
               jm.PY(t, None if prev is None else jnp.asarray(prev),
                     jnp.asarray(x)).logpdf(jnp.asarray(y[t])), rtol=rtol)


@pytest.mark.parametrize("name", GUIDED)
def test_guided_logG_and_logeta_match_jax(name):
    jm, tm = _pair(name)
    y = _data(name)
    jfk = jssms.AuxiliaryPF(ssm=jm, data=jnp.asarray(y))
    tfk = ssms.AuxiliaryPF(ssm=tm, data=y, device="cpu")
    N = 256
    xp, x = _states(name, N, 2, -0.8), _states(name, N, 3, -0.8)
    _close(tfk.logG(0, None, _t(x)), jfk.logG(0, None, jnp.asarray(x)),
           atol=1e-4)
    _close(tfk.logG(3, _t(xp), _t(x)),
           jfk.logG(3, jnp.asarray(xp), jnp.asarray(x)), atol=1e-4)
    _close(tm.proposal0(tfk.data).logpdf(_t(x)),
           jm.proposal0(jfk.data).logpdf(jnp.asarray(x)))
    if name in APF:
        for t in (0, 4):
            _close(tfk.logeta(t, _t(x)), jfk.logeta(t, jnp.asarray(x)))


def test_apf_mro_and_flags():
    """Mixins first: ``logeta`` comes from the mixin and no default on
    ``FeynmanKac`` hides it; a guided filter is no APF."""
    assert ssms.AuxiliaryPF.__mro__[1] is ssms.APFMixin
    assert ssms.AuxiliaryBootstrap.__mro__[1] is ssms.APFMixin
    assert not hasattr(core.FeynmanKac, "logeta")
    lg = kalman.LinearGauss()
    y = np.zeros(4, np.float32)
    assert ssms.AuxiliaryPF(ssm=lg, data=y, device="cpu").isAPF
    assert ssms.AuxiliaryBootstrap(ssm=lg, data=y, device="cpu").isAPF
    assert not ssms.GuidedPF(ssm=lg, data=y, device="cpu").isAPF


@pytest.mark.parametrize("path", ["z-form", "gather"])
@pytest.mark.parametrize("name", ["LinearGauss", "StochVol"])
def test_apf_step_reset_weights_match_jax(monkeypatch, name, path):
    """One auxiliary step from the same X, lw and ancestors A in both
    packages: the port's step resamples on the auxiliary weights and
    resets lw to log_mean_exp(logeta, lw) - logeta(t - 1, X[A]), JAX's
    formula; the z-form path serves X by B2, the gather path by A."""
    N, t = 512, 3
    jm, tm = _pair(name)
    y = _data(name)
    X = _states(name, N, 4, -0.8)
    rng = np.random.default_rng(5)
    lw = (2.0 * rng.normal(size=N)).astype(np.float32)
    A = np.sort(rng.integers(0, N, N))
    jfk = jssms.AuxiliaryBootstrap(ssm=jm, data=jnp.asarray(y))
    tfk = ssms.AuxiliaryBootstrap(ssm=tm, data=y, device="cpu")
    jw = jrs.Weights(jnp.asarray(lw))
    logeta = jfk.logeta(t - 1, jnp.asarray(X))
    j_aux = jw.add(logeta)
    j_reset = (jrs.log_mean_exp(logeta, lw=jw.lw)
               - jfk.logeta(t - 1, jnp.asarray(X[A])))
    seen = {}
    if path == "z-form":
        z = torch.from_numpy(np.cumsum(np.bincount(A, minlength=N))
                             .astype(np.int32))

        def fake_z(scheme, gen, W, M=None):
            seen["W"] = W
            return z

        monkeypatch.setattr(trs, "resampling_z", fake_z)
        scheme = "systematic"
    else:
        def fake(gen, W, M):
            seen["W"] = W
            return torch.from_numpy(A)

        monkeypatch.setitem(trs.rs_funcs, "fixed", fake)
        scheme = "fixed"
    lw_t = torch.from_numpy(lw)
    carry = core._Carry(X=torch.from_numpy(X), lw=lw_t,
                        logLt=torch.tensor(0.0),
                        log_mean_w=trs.Weights(lw_t).log_mean)
    _, view, _ = core._step(tfk, torch.Generator().manual_seed(0), carry, t,
                            N, scheme, 1.1, None, True)
    assert view.rs_flag is True
    assert torch.equal(view.A, torch.from_numpy(A))
    assert torch.equal(view.Xp, torch.from_numpy(X[A]))
    _close(seen["W"], j_aux.W, atol=1e-7)
    _close(view.aux.lw, j_aux.lw)
    reset = view.wgts.lw - tfk.logG(t, view.Xp, view.X)
    _close(reset, j_reset, atol=1e-4)


def _lg_data(T, seed):
    rng_y = np.random.default_rng(seed)
    xs = np.empty(T)
    xs[0] = rng_y.normal() / np.sqrt(1 - 0.81)
    for t in range(1, T):
        xs[t] = 0.9 * xs[t - 1] + rng_y.normal()
    return (xs + 0.2 * rng_y.normal(size=T)).astype(np.float32)


@pytest.mark.parametrize("fk_cls", ["GuidedPF", "AuxiliaryPF",
                                    "AuxiliaryBootstrap"])
def test_guided_and_auxiliary_filters_match_kalman(fk_cls):
    """T=25, N=4096, 8 fixed seeds: the mean logLt within 0.25 of the
    float64 Kalman logLt, the bound of the bootstrap filter's test."""
    T, N = 25, 4096
    y = _lg_data(T, 1)
    ssm = convert.ssm_from_params(
        "LinearGauss", _params(ZOO["LinearGauss"]()), device="cpu")
    y64 = torch.from_numpy(y.astype(np.float64))
    kf = float(kalman.Kalman(ssm=ssm, data=y64).logLt)
    fk = getattr(ssms, fk_cls)(ssm=ssm, data=y, device="cpu")
    runs = []
    for s in range(8):
        pf = core.SMC(fk=fk, N=N, seed=s)
        pf.run()
        runs.append(float(pf.logLt))
    assert np.all(np.isfinite(runs))
    assert abs(np.mean(runs) - kf) < 0.25, (np.mean(runs), kf)


def test_baum_welch_matches_jax():
    jm, tm = _pair("GaussianHMM")
    y = _data("GaussianHMM", T=60)
    jb = jhmm.BaumWelch(hmm=jm, data=jnp.asarray(y))
    tb = hmm.BaumWelch(hmm=tm, data=torch.from_numpy(y))
    jb.run()
    tb.run()
    for attr in ("pred", "filt", "smth"):
        _close(getattr(tb, attr), getattr(jb, attr), atol=1e-7)
    _close(tb.logft, jb.logft)
    _close(tb.logpyt, jb.logpyt)
    _close(tb.logLt, jb.logLt)
    paths = tb.sample(torch.Generator().manual_seed(0), N=20_000)
    assert paths.shape == (60, 20_000) and paths.dtype == torch.int64
    freq = torch.stack([torch.bincount(p, minlength=3)
                        for p in paths]).numpy() / 2e4
    smth = tb.smth.numpy()
    se = np.sqrt(smth * (1 - smth) / 2e4) + 1e-9
    assert np.all(np.abs(freq - smth) < 5 * se)


def test_bootstrap_on_gaussian_hmm_matches_baum_welch():
    """T=25, N=4096, 8 seeds: the mean logLt within 0.25 of BaumWelch's
    float64 logLt; the states are int64 particles."""
    _, tm = _pair("GaussianHMM")
    y = _data("GaussianHMM", T=25)
    exact = hmm.BaumWelch(hmm=hmm.GaussianHMM(**{
        k: torch.from_numpy(v.astype(np.float64))
        for k, v in HMM_PARAMS.items()}), data=torch.from_numpy(y))
    fk = ssms.Bootstrap(ssm=tm, data=y, device="cpu")
    runs = []
    for s in range(8):
        pf = core.SMC(fk=fk, N=4096, seed=s)
        pf.run()
        assert pf.X.dtype == torch.int64
        runs.append(float(pf.logLt))
    assert abs(np.mean(runs) - float(exact.logLt)) < 0.25


@pytest.mark.parametrize("fk_cls", ["Bootstrap", "AuxiliaryPF"])
def test_stochvol_filters_match_jax_on_a_large_observation(fk_cls):
    """ROADMAP C.7's data: T = 100 observations of ``StochVol()`` simulated
    by the port from generator seed 0 (|y| = 2.41 at t = 1), N = 4096,
    always resampling, 8 seeds in each package.  The port's mean logLt
    within 0.15 of the JAX package's: 5 standard errors of the difference
    of two means of 8 at the larger sd over seeds measured on the CPU
    (0.068, the bootstrap filter's)."""
    _, y = ssms.StochVol().simulate(torch.Generator().manual_seed(0), 100)
    assert float(y.abs().max()) > 2.4
    tfk = getattr(ssms, fk_cls)(ssm=ssms.StochVol(), data=y, device="cpu")
    jfk = getattr(jssms, fk_cls)(ssm=jssms.StochVol(),
                                 data=jnp.asarray(y.numpy()))
    got, want = [], []
    for s in range(8):
        pf = core.SMC(fk=tfk, N=4096, seed=s, ESSrmin=1.1)
        pf.run()
        got.append(float(pf.logLt))
        jpf = jcore.SMC(fk=jfk, N=4096, seed=s, ESSrmin=1.1)
        jpf.run()
        want.append(float(jpf.logLt))
    assert np.all(np.isfinite(got))
    assert abs(np.mean(got) - np.mean(want)) < 0.15, (got, want)


@pytest.mark.parametrize("name", [n for n in ZOO if n != "LinearGauss"])
def test_zoo_runs_through_every_scheme(name):
    _, tm = _pair(name)
    y = _data(name, T=10)
    fks = {"boot": ssms.Bootstrap(ssm=tm, data=y, device="cpu")}
    if name in GUIDED:
        fks["guided"] = ssms.GuidedPF(ssm=tm, data=y, device="cpu")
    if name in APF:
        fks["apf"] = ssms.AuxiliaryBootstrap(ssm=tm, data=y, device="cpu")
    runs = core.multiSMC(fk=fks, N=256, resampling=SCHEMES, nruns=1,
                         ESSrmin=1.1)
    assert len(runs) == len(fks) * len(SCHEMES)
    for r in runs:
        assert np.isfinite(float(r["output"].logLt)), (r["fk"],
                                                      r["resampling"])
