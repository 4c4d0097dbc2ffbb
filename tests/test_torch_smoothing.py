"""The port's particle history and off-line smoothers
(``particles_tpu_torch.smoothing``) against the JAX package and the
Kalman smoother.

The genealogy and two-filter O(N²) are deterministic: they get the same
numpy arrays in both packages (a JAX run's history carried across by
``convert.history_from_numpy``) and are held exact (integer genealogy) or
to float32 (rtol 1e-5).  The random smoothers are held to the exact
Kalman smoother at the JAX tests' sizes and tolerances
(``tests/test_smoothing.py``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particles_tpu as jparticles
import particles_tpu.kalman as jk
import particles_tpu.smoothing as jsm
import particles_tpu.state_space_models as jssms
from particles_tpu_torch import convert, kalman, multiSMC, SMC, smoothing
from particles_tpu_torch.collectors import Paris
from particles_tpu_torch import resampling as rs
from particles_tpu_torch import state_space_models as ssms

PARAMS = dict(rho=0.9, sigmaX=1.0, sigmaY=0.3)


def _simulate(T, seed):
    rng = np.random.default_rng(seed)
    xs = np.empty(T)
    xs[0] = rng.normal() / np.sqrt(1 - PARAMS["rho"] ** 2)
    for t in range(1, T):
        xs[t] = PARAMS["rho"] * xs[t - 1] + PARAMS["sigmaX"] * rng.normal()
    return (xs + PARAMS["sigmaY"] * rng.normal(size=T)).astype(np.float32)


def _fk(y):
    ssm = kalman.LinearGauss(**PARAMS)
    return ssms.Bootstrap(ssm=ssm, data=y, device="cpu")


@pytest.fixture(scope="module")
def smooth_setup():
    y = _simulate(20, 7)
    fk = _fk(y)
    kf = kalman.Kalman(ssm=fk.ssm, data=torch.from_numpy(y).double())
    kf.smoother()
    pf = SMC(fk=fk, N=3000, seed=1, store_history=True)
    pf.run()
    return fk, y, kf, pf


def _check_paths_vs_kalman(paths, kf, atol):
    """As the JAX tests: smoothed means within atol, sds within 0.12."""
    exact = kf.smth.mean[:, 0].numpy()
    np.testing.assert_allclose(paths.mean(1).numpy(), exact, atol=atol)
    exact_std = np.sqrt(kf.smth.cov[:, 0, 0].numpy())
    np.testing.assert_allclose(paths.std(1, correction=0).numpy(),
                               exact_std, atol=0.12)


# -- the genealogy, exact against the JAX package ----------------------------

def _ancestors(T, N, seed):
    """T ancestor vectors: sorted ones (a resampling step) and identities
    (a step that did not resample)."""
    rng = np.random.default_rng(seed)
    A = np.empty((T, N), dtype=np.int64)
    for t in range(T):
        A[t] = (np.sort(rng.integers(0, N, N)) if t % 3 else np.arange(N))
    return A


@pytest.mark.parametrize("T,N", [(1, 5), (12, 64), (30, 1000)])
def test_compute_trajectories_matches_jax(T, N):
    A = _ancestors(T, N, seed=T)
    B = smoothing._compute_trajectories(torch.from_numpy(A))
    Bj = np.asarray(jsm._compute_trajectories(jnp.asarray(A, jnp.int32)))
    assert B.dtype == torch.int64 and B.shape == (T, N)
    np.testing.assert_array_equal(B.numpy(), Bj)


def test_rolling_window_trajectories_match_jax():
    A = _ancestors(9, 300, seed=3)
    h = smoothing.RollingParticleHistory(4)
    hj = jsm.RollingParticleHistory(4)
    for t in range(9):
        view = types.SimpleNamespace(X=torch.zeros(300),
                                     A=torch.from_numpy(A[t]), wgts=None)
        h.save(view)
        hj.save(types.SimpleNamespace(X=jnp.zeros(300),
                                      A=jnp.asarray(A[t], jnp.int32),
                                      wgts=None))
    assert h.T == hj.T == 4 and h.N == 300
    np.testing.assert_array_equal(h.compute_trajectories().numpy(),
                                  np.asarray(hj.compute_trajectories()))


def test_extract_one_trajectory_follows_the_genealogy(smooth_setup):
    *_, pf = smooth_setup
    h = pf.hist
    traj = h.extract_one_trajectory(torch.Generator().manual_seed(5))
    n = int(rs.multinomial_once(torch.Generator().manual_seed(5), h.wgts.W))
    Bj = np.asarray(jsm._compute_trajectories(
        jnp.asarray(h.A.numpy(), jnp.int32)))
    assert traj.shape == (h.T,)
    np.testing.assert_array_equal(
        traj.numpy(), h.X.numpy()[np.arange(h.T), Bj[:, n]])


def test_history_is_the_stacked_frames():
    """Each frame of ``pf.hist`` is the particle system of that step, A is
    the identity on steps that did not resample."""
    fk = _fk(_simulate(8, 2))
    pf = SMC(fk=fk, N=200, seed=3, store_history=True)
    frames = []
    for _ in pf:
        frames.append((pf.X, pf.A, pf.wgts.lw, pf.rs_flag))
    h = pf.hist
    assert isinstance(h, smoothing.ParticleHistory)
    assert h.X.shape == (8, 200) and h.A.shape == (8, 200)
    assert h.A.dtype == torch.int64 and h.T == 8 and h.N == 200
    for t, (X, A, lw, flag) in enumerate(frames):
        assert torch.equal(h.X[t], X) and torch.equal(h.lw[t], lw)
        assert torch.equal(h.A[t], A)
        if not flag:
            assert torch.equal(A, torch.arange(200))
    assert torch.equal(h.wgts.lw, pf.wgts.lw)
    assert torch.equal(h.wgts_at(3).lw, h.lw[3])


# -- two-filter O(N^2), float32 against the JAX package ----------------------

@pytest.fixture(scope="module")
def two_histories():
    """A JAX forward run and information run (store_history=True), and the
    same histories in the port."""
    y = _simulate(10, 4)
    jssm = jk.LinearGauss(**PARAMS)
    runs = []
    for data, seed in ((y, 1), (y[::-1].copy(), 2)):
        pf = jparticles.SMC(fk=jssms.Bootstrap(ssm=jssm, data=data), N=500,
                            key=jax.random.key(seed), store_history=True)
        pf.run()
        runs.append(pf)
    jpf, jinfo = runs
    tfk = _fk(y)
    hists = [convert.history_from_numpy(
        tfk, np.asarray(p.hist.X), np.asarray(p.hist.A),
        np.asarray(p.hist.lw), device="cpu") for p in runs]
    return jssm, jpf, jinfo, tfk, hists


@pytest.mark.parametrize("rows", [None, 16])
def test_two_filter_ON2_matches_jax(two_histories, monkeypatch, rows):
    """The same two histories in both packages, every t, in one block and
    in blocks of 16 rows."""
    jssm, jpf, jinfo, tfk, (h, hinfo) = two_histories
    if rows is not None:
        monkeypatch.setattr(smoothing, "PAIRS_PER_BLOCK", rows * 500)
    info = types.SimpleNamespace(hist=hinfo)
    for t in range(h.T - 1):
        est = h.two_filter_smoothing(t, info, lambda x, xf: x * xf,
                                     lambda x: tfk.ssm.PX0().logpdf(x))
        est_j = jpf.hist.two_filter_smoothing(
            t, jinfo, lambda x, xf: x * xf,
            lambda x: jssm.PX0().logpdf(x))
        np.testing.assert_allclose(float(est), float(est_j), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("phi", ["x", "x*xf"])
def test_two_filter_ON_agrees_with_ON2(two_histories, phi):
    """The O(N) form (independent pairs, where the JAX package pairs sorted
    draws) estimates what the O(N²) form computes on the same two
    histories: at every t, the mean of 100 O(N) estimates within 4 of its
    standard errors (the estimates' sd over sqrt(100)) of the O(N²)
    value, and each estimate within 5 sd of it."""
    _, _, _, tfk, (h, hinfo) = two_histories
    info = types.SimpleNamespace(hist=hinfo)
    f = {"x": lambda x, xf: x, "x*xf": lambda x, xf: x * xf}[phi]

    def loggamma(x):
        return tfk.ssm.PX0().logpdf(x)

    reps = 100
    for t in range(h.T - 1):
        exact = float(h.two_filter_smoothing(t, info, f, loggamma))
        gen = torch.Generator().manual_seed(t)
        est = np.array([float(h.two_filter_smoothing(
            t, info, f, loggamma, linear_cost=True, gen=gen))
            for _ in range(reps)])
        sd = est.std()
        assert abs(est.mean() - exact) <= 4 * sd / np.sqrt(reps), t
        assert np.abs(est - exact).max() <= 5 * sd, t


def test_history_from_numpy_keeps_types(two_histories):
    *_, (h, _) = two_histories
    assert h.X.dtype == torch.float32 and h.lw.dtype == torch.float32
    assert h.A.dtype == torch.int64 and h.T == 10 and h.N == 500


# -- the random smoothers against the Kalman smoother ------------------------

def test_ffbs_ON2_matches_kalman(smooth_setup):
    *_, kf, pf = smooth_setup
    paths = pf.hist.backward_sampling_ON2(torch.Generator().manual_seed(2),
                                          1500)
    assert paths.shape == (20, 1500)
    _check_paths_vs_kalman(paths, kf, atol=0.1)


def test_ffbs_mcmc_matches_kalman(smooth_setup):
    *_, kf, pf = smooth_setup
    paths = pf.hist.backward_sampling_mcmc(torch.Generator().manual_seed(3),
                                           1500, nsteps=2)
    _check_paths_vs_kalman(paths, kf, atol=0.1)


def test_ffbs_reject_matches_kalman(smooth_setup):
    *_, kf, pf = smooth_setup
    paths = pf.hist.backward_sampling_reject(
        torch.Generator().manual_seed(4), 1500, max_trials=20)
    _check_paths_vs_kalman(paths, kf, atol=0.1)
    acc = pf.hist.acc_rate.numpy()
    assert acc.shape == (19,) and np.all(acc > 0) and np.all(acc <= 1.0)
    assert len(pf.hist.rounds) == len(pf.hist.stragglers) == 19
    assert all(1 <= r <= 20 for r in pf.hist.rounds)
    assert all(s == 0 for r, s in zip(pf.hist.rounds, pf.hist.stragglers)
               if r < 20)


@pytest.mark.parametrize("method", ["reject", "mcmc", "paris"])
def test_samplers_build_one_cdf_a_step(smooth_setup, monkeypatch, method):
    """Each backward step (each filter step for PaRIS) builds the CDF of
    the weights it draws from (B3 on the card) once, and each round or
    MCMC step draws from it (B4 alone); FFBS's initial draw is one more
    CDF."""
    _, y, _, pf = smooth_setup
    calls = {"pinned_cdf": 0, "draw_by_cdf": 0}
    for name in calls:
        f = getattr(rs, name)

        def counted(*args, f=f, name=name):
            calls[name] += 1
            return f(*args)

        monkeypatch.setattr(rs, name, counted)
    gen = torch.Generator().manual_seed(5)
    if method == "reject":
        pf.hist.backward_sampling_reject(gen, 1500, max_trials=20)
        want = {"pinned_cdf": 20, "draw_by_cdf": sum(pf.hist.rounds)}
    elif method == "mcmc":
        pf.hist.backward_sampling_mcmc(gen, 1500, nsteps=3)
        want = {"pinned_cdf": 20, "draw_by_cdf": 3 * 19}
    else:
        class LGsmooth(kalman.LinearGauss):
            def add_func(self, t, xp, x):
                return x

        fk = ssms.Bootstrap(ssm=LGsmooth(**PARAMS), data=y, device="cpu")
        paris = Paris(Nparis=2, max_trials=15)
        SMC(fk=fk, N=700, seed=0, collect=[paris]).run()
        want = {"pinned_cdf": 19, "draw_by_cdf": sum(paris.rounds)}
    assert calls == want


def test_ffbs_reject_fallback_in_blocks(smooth_setup, monkeypatch):
    """One round, then every straggler through the exact kernel in blocks
    of 8 rows."""
    *_, kf, pf = smooth_setup
    monkeypatch.setattr(smoothing, "PAIRS_PER_BLOCK", 8 * 3000)
    paths = pf.hist.backward_sampling_reject(
        torch.Generator().manual_seed(6), 1500, max_trials=1)
    assert sum(pf.hist.stragglers) > 0
    _check_paths_vs_kalman(paths, kf, atol=0.1)


def test_two_filter_matches_kalman(smooth_setup):
    fk, y, kf, pf = smooth_setup
    info = SMC(fk=_fk(y[::-1].copy()), N=3000, seed=9, store_history=True)
    info.run()

    def loggamma(x):
        return fk.ssm.PX0().logpdf(x)

    for t in (5, 10):
        est = pf.hist.two_filter_smoothing(t, info, lambda x, xf: x,
                                           loggamma)
        assert abs(float(est) - float(kf.smth.mean[t, 0])) < 0.15
    est, ess = pf.hist.two_filter_smoothing(
        8, info, lambda x, xf: x, loggamma, linear_cost=True,
        return_ess=True, gen=torch.Generator().manual_seed(11))
    assert abs(float(est) - float(kf.smth.mean[8, 0])) < 0.3
    assert float(ess) > 1.0


@pytest.mark.parametrize("method", ["FFBS_ON2", "FFBS_MCMC", "FFBS_hybrid",
                                    "FFBS_purereject", "two-filter_ON2",
                                    "two-filter_ON", "two-filter_ON_prop"])
def test_smoothing_worker(smooth_setup, method):
    fk, y, kf, _ = smooth_setup
    out = smoothing.smoothing_worker(
        method=method, N=500, fk=fk, add_func=lambda t, x, xf: x,
        log_gamma=lambda x: fk.ssm.PX0().logpdf(x), seed=12)
    exact = kf.smth.mean[:-1, 0].numpy()
    assert out["est"].shape == exact.shape
    np.testing.assert_allclose(out["est"].numpy(), exact, atol=0.45)
    assert out["cpu"] > 0


def test_qmc_ffbs_waits_for_sqmc(smooth_setup):
    """QMC FFBS needs the Hilbert-ordered history of an SQMC run: on a
    bootstrap filter's history it raises, as the JAX package does, and
    ``smoothing_worker("FFBS_QMC")`` runs its forward pass as SQMC."""
    fk, *_, pf = smooth_setup
    with pytest.raises(ValueError, match="Hilbert"):
        pf.hist.backward_sampling_qmc(torch.Generator(), 10)
    out = smoothing.smoothing_worker(method="FFBS_QMC", N=64, fk=fk,
                                     add_func=lambda t, x, xf: x)
    assert out["est"].shape == (fk.T - 1,)
    assert bool(torch.isfinite(out["est"]).all())


# -- rolling and partial history, multiSMC -----------------------------------

def test_rolling_history_is_the_last_frames():
    """The window holds the last k frames of the full history of the same
    run, bit for bit, and its last frame is pf.X."""
    fk = _fk(_simulate(30, 0))
    full = SMC(fk=fk, N=800, seed=1, store_history=True)
    full.run()
    pf = SMC(fk=fk, N=800, seed=1, store_history=5)
    pf.run()
    h = pf.hist
    assert isinstance(h, smoothing.RollingParticleHistory)
    assert h.T == 5 and h.N == 800
    assert torch.equal(h.X[-1], pf.X)
    for i in range(5):
        assert torch.equal(h.X[i], full.hist.X[25 + i])
        assert torch.equal(h.A[i], full.hist.A[25 + i])
        assert torch.equal(h.wgts[i].lw, full.hist.lw[25 + i])
    assert torch.equal(h.compute_trajectories(),
                       smoothing._compute_trajectories(full.hist.A[25:]))


def test_rolling_window_longer_than_horizon():
    pf = SMC(fk=_fk(_simulate(12, 0)), N=300, seed=2, store_history=100)
    pf.run()
    assert pf.hist.T == 12
    assert torch.equal(pf.hist.X[-1], pf.X)


def test_partial_history_save_times():
    fk = _fk(_simulate(30, 0))
    pf = SMC(fk=fk, N=800, seed=3, store_history=lambda t: t % 10 == 0)
    frames = {}
    for _ in pf:
        frames[pf.t - 1] = (pf.X, pf.wgts.lw)
    assert isinstance(pf.hist, smoothing.PartialParticleHistory)
    assert sorted(pf.hist.X) == sorted(pf.hist.wgts) == [0, 10, 20]
    for t in (0, 10, 20):
        assert torch.equal(pf.hist.X[t], frames[t][0])
        assert torch.equal(pf.hist.wgts[t].lw, frames[t][1])
    none = SMC(fk=_fk(_simulate(12, 0)), N=300, seed=4,
               store_history=lambda t: False)
    none.run()
    assert none.hist.X == {}


@pytest.mark.parametrize("option", [-3, "all", 1.5])
def test_invalid_history_option_raises(option):
    with pytest.raises(ValueError):
        SMC(fk=_fk(_simulate(5, 0)), N=100, store_history=option)


def test_store_history_under_multismc():
    fk = _fk(_simulate(10, 0))
    runs = multiSMC(fk=fk, N=200, nruns=2, store_history=True,
                    resampling=["systematic", "killing"])
    assert len(runs) == 4
    for entry in runs:
        res = entry["output"]
        assert isinstance(res.hist, smoothing.ParticleHistory)
        assert res.hist.X.shape == (10, 200) and res.hist.T == 10
        assert torch.equal(res.hist.lw[-1], res.lw)
    plain = multiSMC(fk=fk, N=200, nruns=1)
    assert plain[0]["output"].hist is None
