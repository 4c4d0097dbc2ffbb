"""The port's collectors (``Moments``, the on-line smoothers) and variance
estimators against the JAX package and the Kalman smoother.

One update step of each deterministic collector gets the same state
arrays (numpy, from a seed) in both packages and is held to the JAX
function: float32, rtol 1e-5 (the sums run in another order).  The random
ones (PaRIS, and whole runs of the others) are held to the Kalman
smoother with the JAX tests' tolerances (``tests/test_collectors.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particles_tpu.collectors as jcol
import particles_tpu.core as jcore
import particles_tpu.kalman as jk
import particles_tpu.resampling as jrs
import particles_tpu.state_space_models as jssms
import particles_tpu.variance_estimators as jve
from particles_tpu_torch import collectors as col
from particles_tpu_torch import core, kalman, smoothing, SMC
from particles_tpu_torch import resampling as rs
from particles_tpu_torch import state_space_models as ssms
from particles_tpu_torch import variance_estimators as ve

PARAMS = dict(rho=0.9, sigmaX=1.0, sigmaY=0.3)
RTOL = 1e-5
N_STEP = 800   # one size for every one-step comparison: JAX compiles once


class LGsmooth(kalman.LinearGauss):
    """LinearGauss with the additive function psi_t(x_{t-1}, x_t) = x_t."""

    def add_func(self, t, xp, x):
        return x


class JLGsmooth(jk.LinearGauss):
    def add_func(self, t, xp, x):
        return x


def _simulate(T, seed):
    rng = np.random.default_rng(seed)
    xs = np.empty(T)
    xs[0] = rng.normal() / np.sqrt(1 - PARAMS["rho"] ** 2)
    for t in range(1, T):
        xs[t] = PARAMS["rho"] * xs[t - 1] + PARAMS["sigmaX"] * rng.normal()
    return (xs + PARAMS["sigmaY"] * rng.normal(size=T)).astype(np.float32)


# -- one step on the same arrays ---------------------------------------------

def _arrays(N, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(X=rng.normal(size=N).astype(f),
                Xp=rng.normal(size=N).astype(f),
                A=np.sort(rng.integers(0, N, N)),
                lw=(2.0 * rng.normal(size=N)).astype(f),
                Phi=rng.normal(size=N).astype(f),
                prev_X=rng.normal(size=N).astype(f),
                prev_lw=(2.0 * rng.normal(size=N)).astype(f))


def _views(a, t=3):
    """The same step as a JAX view and a port view."""
    y = np.zeros(5, np.float32)
    jfk = jssms.Bootstrap(ssm=JLGsmooth(**PARAMS), data=jnp.asarray(y))
    tfk = ssms.Bootstrap(ssm=LGsmooth(**PARAMS), data=y, device="cpu")
    N = len(a["X"])
    jw = jrs.Weights(jnp.asarray(a["lw"]))
    tw = rs.Weights(torch.from_numpy(a["lw"]))
    jv = jcore.StepView(fk=jfk, t=t, X=jnp.asarray(a["X"]),
                        Xp=jnp.asarray(a["Xp"]),
                        A=jnp.asarray(a["A"], jnp.int32), wgts=jw, aux=jw,
                        rs_flag=True, logLt=0.0, loglt=0.0, N=N, ESSrmin=0.5)
    tv = core.StepView(fk=tfk, t=t, X=torch.from_numpy(a["X"]),
                       Xp=torch.from_numpy(a["Xp"]),
                       A=torch.from_numpy(a["A"]), wgts=tw, aux=tw,
                       rs_flag=True, logLt=0.0, loglt=0.0, N=N, ESSrmin=0.5)
    return jv, tv


def _close(out, out_j):
    np.testing.assert_allclose(np.asarray(out, dtype=np.float64),
                               np.asarray(out_j, dtype=np.float64),
                               rtol=RTOL, atol=1e-5)


def test_online_smooth_naive_step_matches_jax():
    a = _arrays(N_STEP, 0)
    jv, tv = _views(a)
    (Phi_j,), out_j = jcol.Online_smooth_naive().step(
        jv, (jnp.asarray(a["Phi"]),))
    (Phi,), out = col.Online_smooth_naive().step(
        tv, (torch.from_numpy(a["Phi"]),))
    _close(Phi.numpy(), Phi_j)
    _close(out.numpy(), out_j)


@pytest.mark.parametrize("rows", [None, 16])
def test_online_smooth_ON2_step_matches_jax(monkeypatch, rows):
    """In one block and in blocks of 16 rows."""
    N = N_STEP
    if rows is not None:
        monkeypatch.setattr(smoothing, "PAIRS_PER_BLOCK", rows * N)
    a = _arrays(N, 1)
    jv, tv = _views(a)
    (Phi_j, *_), out_j = jcol.Online_smooth_ON2().step(
        jv, (jnp.asarray(a["Phi"]), jnp.asarray(a["prev_X"]),
             jnp.asarray(a["prev_lw"])))
    (Phi, X, lw), out = col.Online_smooth_ON2().step(
        tv, (torch.from_numpy(a["Phi"]), torch.from_numpy(a["prev_X"]),
             torch.from_numpy(a["prev_lw"])))
    _close(Phi.numpy(), Phi_j)
    _close(out.numpy(), out_j)
    assert X is tv.X and lw is tv.wgts.lw


@pytest.mark.parametrize("phi", [None, "product"])
def test_fixed_lag_window_step_matches_jax(phi):
    """The window's output after one slide: genealogy traced back through
    the window, the oldest frame (or phi of the whole window) averaged."""
    N, lag = N_STEP, 4
    rng = np.random.default_rng(2)
    Xbuf = rng.normal(size=(lag + 1, N)).astype(np.float32)
    Abuf = np.stack([np.sort(rng.integers(0, N, N)) for _ in range(lag + 1)])
    a = _arrays(N, 3)
    jv, tv = _views(a)
    f = None if phi is None else (lambda w: w[0] * w[-1] + w[2])
    (Xj, Aj), out_j = jcol.Fixed_lag_smooth(lag=lag, phi=f).step(
        jv, (jnp.asarray(Xbuf), jnp.asarray(Abuf, jnp.int32)))
    state = (tuple(torch.from_numpy(x) for x in Xbuf),
             tuple(torch.from_numpy(x) for x in Abuf))
    (Xt, At), out = col.Fixed_lag_smooth(lag=lag, phi=f).step(tv, state)
    _close(out.numpy(), out_j)
    np.testing.assert_array_equal(torch.stack(At).numpy(), np.asarray(Aj))
    np.testing.assert_array_equal(torch.stack(Xt).numpy(), np.asarray(Xj))


def test_fixed_lag_init_matches_jax():
    a = _arrays(N_STEP, 4)
    jv, tv = _views(a, t=0)
    _, out_j = jcol.Fixed_lag_smooth(lag=3).init(jv)
    (Xbuf, Abuf), out = col.Fixed_lag_smooth(lag=3).init(tv)
    _close(out.numpy(), out_j)
    assert len(Xbuf) == len(Abuf) == 4


@pytest.mark.parametrize("kind", ["distinct", "random", "coalesced"])
@pytest.mark.parametrize("dim", [1, 2])
def test_var_estimate_matches_jax(kind, dim):
    N = N_STEP
    rng = np.random.default_rng(5)
    W = rng.dirichlet(np.ones(N)).astype(np.float32)
    x = rng.normal(size=(N,) if dim == 1 else (N, dim)).astype(np.float32)
    B = {"distinct": np.arange(N), "random": rng.integers(0, 40, N),
         "coalesced": np.full(N, 17)}[kind]
    est = ve.var_estimate(torch.from_numpy(W), torch.from_numpy(x),
                          torch.from_numpy(B))
    est_j = jve.var_estimate(jnp.asarray(W), jnp.asarray(x),
                             jnp.asarray(B, jnp.int32))
    assert est.shape == np.shape(est_j)
    _close(est.numpy(), est_j)
    if kind == "coalesced":
        assert torch.all(est == 0)


def test_var_estimate_reduces_to_sum_of_squares():
    """Eve variables all distinct: sum W^2 (x - m)^2."""
    W = torch.full((4,), 0.25)
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    est = ve.var_estimate(W, x, torch.arange(4))
    np.testing.assert_allclose(float(est),
                               float((W * (x - 2.5)) ** 2 @ torch.ones(4)),
                               rtol=1e-6)


@pytest.mark.parametrize("cls", ["Var", "Var_logLt"])
def test_eve_collectors_step_matches_jax(cls):
    a = _arrays(N_STEP, 6)
    jv, tv = _views(a)
    B = np.random.default_rng(7).integers(0, N_STEP, N_STEP)
    Bj, out_j = getattr(jve, cls)().step(jv, jnp.asarray(B, jnp.int32))
    Bt, out = getattr(ve, cls)().step(tv, torch.from_numpy(B))
    np.testing.assert_array_equal(Bt.numpy(), np.asarray(Bj))
    _close(out.numpy(), out_j)


@pytest.mark.parametrize("lag", [1, 4])
def test_lag_based_var_step_matches_jax(lag):
    N = N_STEP
    rng = np.random.default_rng(8)
    Abuf = np.stack([np.sort(rng.integers(0, N, N)) for _ in range(lag)])
    a = _arrays(N, 9)
    jv, tv = _views(a)
    Aj, out_j = jve.Lag_based_var(lag=lag).step(
        jv, jnp.asarray(Abuf, jnp.int32))
    At, out = ve.Lag_based_var(lag=lag).step(
        tv, tuple(torch.from_numpy(x) for x in Abuf))
    assert out.shape == (lag + 1,)
    np.testing.assert_array_equal(torch.stack(At).numpy(), np.asarray(Aj))
    _close(out.numpy(), out_j)


def test_moments_is_wmean_and_var():
    a = _arrays(N_STEP, 10)
    jv, tv = _views(a)
    out = col.Moments().collect(tv)
    ref = rs.wmean_and_var(tv.W, tv.X)
    ref_j = jrs.wmean_and_var(jv.W, jv.X)
    for k in ("mean", "var"):
        assert torch.equal(out[k], ref[k])
        _close(out[k].numpy(), ref_j[k])
    custom = col.Moments(mom_func=lambda W, X: (W * X * X).sum()).collect(tv)
    _close(custom.numpy(), (tv.W * tv.X * tv.X).sum().numpy())


class DictFK(core.FeynmanKac):
    """Dict particles {"a", "b"} (ROADMAP C.8's input): a random walk with
    a weight on a, and a positive b."""

    T = 5

    def M0(self, gen, N):
        return {"a": torch.randn(N, generator=gen),
                "b": torch.rand(N, generator=gen) + 1.0}

    def M(self, gen, t, xp):
        return {"a": xp["a"] + torch.randn(xp["a"].shape, generator=gen),
                "b": 0.9 * xp["b"] + torch.rand(xp["b"].shape,
                                                generator=gen)}

    def logG(self, t, xp, x):
        return -0.5 * x["a"] ** 2


def test_moments_on_dict_particles_match_jax():
    """``Moments()`` on dict particles gives each field's weighted mean and
    variance, as the JAX package's ``default_moments`` does on the same
    weights and particles at every t."""
    pf = SMC(fk=DictFK(), N=100, seed=0, device="cpu", store_history=True,
             collect=[col.Moments()])
    pf.run()
    assert len(pf.summaries.moments) == DictFK.T
    for t, mom in enumerate(pf.summaries.moments):
        W = rs.exp_and_normalise(pf.hist.lw[t])
        X = {k: v[t] for k, v in pf.hist.X.items()}
        ref = jcore.FeynmanKac.default_moments(
            None, jnp.asarray(W.numpy()),
            {k: jnp.asarray(v.numpy()) for k, v in X.items()})
        for stat in ("mean", "var"):
            assert set(mom[stat]) == {"a", "b"}
            for k in ("a", "b"):
                _close(mom[stat][k].numpy(), ref[stat][k])


# -- whole runs against the Kalman smoother ----------------------------------

@pytest.fixture(scope="module")
def online_setup():
    ssm = LGsmooth(**PARAMS)
    y = _simulate(15, 11)
    kf = kalman.Kalman(ssm=ssm, data=torch.from_numpy(y).double())
    kf.smoother()
    return ssm, y, kf


def run_with(ssm, y, cols, N, seed=0):
    fk = ssms.Bootstrap(ssm=ssm, data=y, device="cpu")
    pf = SMC(fk=fk, N=N, seed=seed, collect=cols)
    pf.run()
    return pf


@pytest.mark.parametrize("cls,name,N,tol", [
    (col.Online_smooth_naive, "online_smooth_naives", 4000, 0.6),
    (col.Online_smooth_ON2, "online_smooth_ON2s", 700, 0.6),
    (lambda: col.Paris(Nparis=2, max_trials=15), "paris", 700, 0.8),
])
def test_online_smoothers_match_kalman(online_setup, cls, name, N, tol):
    ssm, y, kf = online_setup
    pf = run_with(ssm, y, [cls()], N)
    est = getattr(pf.summaries, name)
    assert est.shape == (15,)
    assert abs(float(est[-1]) - float(kf.smth.mean.sum())) < tol


def test_paris_records_rounds_and_finishes_stragglers(online_setup):
    ssm, y, kf = online_setup
    paris = col.Paris(Nparis=3, max_trials=2)
    pf = run_with(ssm, y, [paris], 700)
    assert paris.rounds == [2] * 14
    assert abs(float(pf.summaries.paris[-1])
               - float(kf.smth.mean.sum())) < 0.8


def test_paris_leaves_the_filter_unchanged(online_setup):
    """PaRIS draws from a generator of its own: the filter's particles,
    weights and logLt are the same bits with and without it."""
    ssm, y, _ = online_setup
    plain = run_with(ssm, y, [], 700, seed=3)
    with_paris = run_with(ssm, y, [col.Paris()], 700, seed=3)
    assert torch.equal(plain.X, with_paris.X)
    assert torch.equal(plain.wgts.lw, with_paris.wgts.lw)
    assert torch.equal(plain.logLt, with_paris.logLt)


def test_online_smoothers_agree(online_setup):
    ssm, y, _ = online_setup
    a = run_with(ssm, y, [col.Online_smooth_naive()], 1500, seed=5)
    b = run_with(ssm, y, [col.Online_smooth_ON2()], 1500, seed=6)
    np.testing.assert_allclose(a.summaries.online_smooth_naives.numpy(),
                               b.summaries.online_smooth_ON2s.numpy(),
                               atol=0.8)


def test_fixed_lag_tracks_smoothed_state(online_setup):
    ssm, y, kf = online_setup
    pf = run_with(ssm, y, [col.Fixed_lag_smooth(lag=6)], 4000)
    ests = pf.summaries.fixed_lag_smooths.numpy()
    exact = kf.smth.mean[:, 0].numpy()
    assert ests.shape == (15,)
    for t in range(8, 15):
        assert abs(ests[t] - exact[t - 6]) < 0.7, t


def test_variance_collectors_shapes(online_setup):
    ssm, y, _ = online_setup
    pf = run_with(ssm, y, [ve.Var(), ve.Var_logLt(), ve.Lag_based_var(lag=4),
                           col.Moments()], 500)
    s = pf.summaries
    assert s.var.shape == s.var_logLt.shape == (15,)
    assert s.lag_based_var.shape == (15, 5)
    for v in (s.var, s.var_logLt, s.lag_based_var):
        assert torch.isfinite(v).all() and (v >= 0).all()
    assert len(s.moments) == 15 and s.moments[-1]["mean"].shape == ()


def test_var_logLt_tracks_empirical_variance(online_setup):
    """The single-run estimate against the variance over 40 runs."""
    ssm, y, _ = online_setup
    ests, logLts = [], []
    for s in range(40):
        pf = run_with(ssm, y, [ve.Var_logLt()], 300, seed=s)
        ests.append(float(pf.summaries.var_logLt[-1]))
        logLts.append(float(pf.logLt))
    ratio = np.mean(ests) / np.var(logLts)
    assert 0.3 < ratio < 3.0, ratio
