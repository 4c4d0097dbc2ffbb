"""SQMC in the port (``SMC(qmc=True)``, ``SQMC``, ``multiSMC(qmc=True)``)
and QMC FFBS against the JAX package and the Kalman oracle.

One SQMC step is deterministic given the carried particles and weights
and its sorted Sobol points: the step of both packages gets the same
Hilbert-ordered X and lw and the JAX package's own points.  On dyadic
weights (k 2^-9) both cumulative sums are exact, so the ancestors are
held exactly; the new particles and weights to float32 (rtol 1e-5: the
two ppfs and log-densities round differently).  Whole runs are held as
``tests/test_sqmc.py`` holds the JAX package's: the logLt of 8 seeds
against Kalman, a variance below SMC's, QMC FFBS against the Kalman
smoother.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particles_tpu.core as jcore
import particles_tpu.kalman as jk
import particles_tpu.rqmc as jrqmc
import particles_tpu.state_space_models as jssms
from particles_tpu_torch import (SMC, SQMC, collectors, core, hilbert,
                                 kalman, multiSMC, smoothing)
from particles_tpu_torch import state_space_models as ssms

PARAMS = dict(rho=0.9, sigmaX=1.0, sigmaY=0.2)


def _dyadic_lw(rng, N):
    """Log-weights whose normalised weights are exact multiples of 2^-9:
    N/4 zeros, N/4 ones, N/8 twos and 3N/8 fours (the sum 2N = 512 at
    N = 256), as log-values that exp maps back exactly."""
    c = np.repeat([0.0, 1.0, 2.0, 4.0], [N // 4, N // 4, N // 8, 3 * N // 8])
    rng.shuffle(c)
    with np.errstate(divide="ignore"):
        return np.log(c).astype(np.float32)


def _step_inputs(fk_name, dx, seed):
    """Both packages' models and a carry: the particles in Hilbert order,
    dyadic weights (all but the auxiliary filter's, whose weights pass
    through logeta)."""
    rng = np.random.default_rng(seed)
    N, T = 256, 4
    if dx == 1:
        jssm, ssm = jk.LinearGauss(**PARAMS), kalman.LinearGauss(**PARAMS)
        X = np.sort(rng.normal(size=N).astype(np.float32))
        y = rng.normal(size=T).astype(np.float32)
    else:
        jssm = jk.MVLinearGauss_Guarniero_etal(alpha=0.4, dx=dx)
        ssm = kalman.MVLinearGauss_Guarniero_etal(alpha=0.4, dx=dx,
                                                  device="cpu")
        X = rng.normal(size=(N, dx)).astype(np.float32)
        X = X[hilbert.hilbert_sort(torch.from_numpy(X)).numpy()]
        y = rng.normal(size=(T, dx)).astype(np.float32)
    jfk = getattr(jssms, fk_name)(ssm=jssm, data=jnp.asarray(y))
    fk = getattr(ssms, fk_name)(ssm=ssm, data=y, device="cpu")
    return jfk, fk, X, _dyadic_lw(rng, N)


@pytest.mark.parametrize("fk_name,dx", [("Bootstrap", 1), ("AuxiliaryPF", 1),
                                        ("Bootstrap", 2)])
def test_sqmc_step_matches_jax(fk_name, dx):
    """One step at t = 1, the JAX package's carry key and sorted points on
    both sides.  For the auxiliary filter (weights through logeta, not
    dyadic) and the Hilbert order of dx = 2 (cells of float32 standardised
    values), the test checks that the inputs sit away from the float32
    rounding where the packages could part: every point more than 1e-5
    from every cumulative weight, every standardised point more than 16
    ulps (of 1, times the cells) from a cell boundary."""
    jfk, fk, X, lw = _step_inputs(fk_name, dx, seed=dx)
    N = X.shape[0]
    key = jax.random.key(3)
    jcarry = jcore._Carry(key=key, X=jnp.asarray(X), lw=jnp.asarray(lw),
                          logLt=jnp.float32(0.0),
                          log_mean_w=jnp.float32(0.0))
    _, jv, _ = jcore._step_qmc(jfk, jcarry, 1, N, 0.5, None, need_gen=True)
    _, k_u, _ = jax.random.split(key, 3)
    du = max(fk.du, 1)
    points = np.asarray(jrqmc.sobol_sorted0(k_u, N, du + 1))
    carry = core._Carry(X=torch.from_numpy(X), lw=torch.from_numpy(lw),
                        logLt=torch.tensor(0.0), log_mean_w=torch.tensor(0.0))
    _, view, _ = core._step_qmc(fk, None, carry, 1, N, 0.5, None, True,
                                points=torch.from_numpy(points.copy()))
    if fk_name == "AuxiliaryPF":
        cs = np.cumsum(np.asarray(jv.aux.W, np.float64))
        gap = np.abs(points[:, :1].astype(np.float64) - cs[None, :]).min()
        assert gap > 1e-5
    if dx > 1:
        x64 = np.asarray(jv.X, np.float64)
        nbits = hilbert.sort_nbits(N, dx)
        g = (1 << nbits) / (1 + np.exp(-(x64 - x64.mean(0)) / x64.std(0)))
        assert np.abs(g - np.round(g)).min() > 2.0 ** (nbits - 20)
    assert view.rs_flag is True and view.A.dtype == torch.int64
    np.testing.assert_array_equal(view.A.numpy(), np.asarray(jv.A))
    for ours, theirs in ((view.X, jv.X), (view.Xp, jv.Xp),
                         (view.wgts.lw, jv.wgts.lw), (view.loglt, jv.loglt)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def lg():
    rng = np.random.default_rng(42)
    T = 30
    xs = np.empty(T)
    xs[0] = rng.normal() / np.sqrt(1 - PARAMS["rho"] ** 2)
    for t in range(1, T):
        xs[t] = PARAMS["rho"] * xs[t - 1] + rng.normal()
    y = (xs + PARAMS["sigmaY"] * rng.normal(size=T)).astype(np.float32)
    ssm = kalman.LinearGauss(**PARAMS)
    kf = kalman.Kalman(ssm=ssm, data=torch.from_numpy(y).double())
    kf.smoother()
    return ssm, y, kf


def _boot(ssm, y, cls="Bootstrap"):
    return getattr(ssms, cls)(ssm=ssm, data=y, device="cpu")


def test_sqmc_unbiased(lg):
    ssm, y, kf = lg
    fk = _boot(ssm, y)
    lls = []
    for s in range(8):
        pf = SMC(fk=fk, N=500, qmc=True, seed=s)
        pf.run()
        assert pf.summaries.rs_flags[1:].all() and pf.X.shape == (500,)
        lls.append(float(pf.logLt))
    assert abs(np.mean(lls) - float(kf.logLt)) < 0.25, lls


def test_sqmc_beats_smc_variance(lg):
    """Its logLt varies less than SMC's at N = 300 (not a power of two:
    the sort path of the points)."""
    ssm, y, _ = lg
    fk = _boot(ssm, y)
    smc, sqmc = [], []
    for s in range(12):
        pf = SMC(fk=fk, N=300, seed=100 + s)
        pf.run()
        smc.append(float(pf.logLt))
        pfq = SQMC(fk=fk, N=300, seed=200 + s)
        pfq.run()
        sqmc.append(float(pfq.logLt))
    assert np.var(sqmc) < np.var(smc), (np.var(sqmc), np.var(smc))


@pytest.mark.parametrize("cls,tol", [("GuidedPF", 0.3), ("AuxiliaryPF", 0.3)])
def test_guided_and_auxiliary_sqmc(lg, cls, tol):
    ssm, y, kf = lg
    pf = SQMC(fk=_boot(ssm, y, cls), N=500, seed=3)
    pf.run()
    assert abs(float(pf.logLt) - float(kf.logLt)) < tol


def test_multivariate_sqmc():
    """dx = 3, the Hilbert-key path: unbiased against Kalman, and a variance
    below SMC's."""
    mv = kalman.MVLinearGauss_Guarniero_etal(alpha=0.4, dx=3, device="cpu")
    _, y = mv.simulate(torch.Generator().manual_seed(7), 20)
    exact = float(kalman.Kalman(ssm=mv, data=y.double()).logLt)
    fk = ssms.Bootstrap(ssm=mv, data=y)
    lls_s, lls_q = [], []
    for s in range(10):
        p = SMC(fk=fk, N=1000, seed=100 + s)
        p.run()
        lls_s.append(float(p.logLt))
        q = SQMC(fk=fk, N=1000, seed=100 + s)
        q.run()
        lls_q.append(float(q.logLt))
    assert abs(np.mean(lls_q) - exact) < 0.3
    assert np.var(lls_q) < np.var(lls_s)


def test_multismc_qmc(lg):
    ssm, y, kf = lg
    out = multiSMC(fk=_boot(ssm, y), N=256, qmc=True, nruns=4)
    assert [e["run"] for e in out] == [0, 1, 2, 3]
    lls = [float(e["output"].logLt) for e in out]
    assert len(set(lls)) == 4
    assert all(abs(v - float(kf.logLt)) < 0.5 for v in lls), lls


class XpRecorder(collectors.Collector):
    """The step's Xp, which needs the genealogy."""

    summary_name = "xps"
    uses_genealogy = True

    def collect(self, view):
        return view.Xp


def test_sqmc_history_holds_the_genealogy(lg):
    """Each frame is in Hilbert order (sorted, in 1-d), and its ancestors
    index the previous ordered frame: X_{t-1}[A_t] is the step's Xp."""
    ssm, y, _ = lg
    pf = SQMC(fk=_boot(ssm, y), N=128, seed=1, store_history=True,
              collect=[XpRecorder()])
    pf.run()
    h = pf.hist
    assert h.hilbert_ordered and h.A.shape == (30, 128)
    assert bool((h.X[:, 1:] >= h.X[:, :-1]).all())
    for t in range(1, 30):
        assert torch.equal(h.X[t - 1][h.A[t]], pf.summaries.xps[t])
    for opt in (3, lambda t: t % 10 == 0):
        assert SQMC(fk=_boot(ssm, y), N=16, store_history=opt)._hist_obj \
            .hilbert_ordered
    assert not SMC(fk=_boot(ssm, y), N=16, store_history=3)._hist_obj \
        .hilbert_ordered


def test_qmc_ffbs(lg):
    ssm, y, kf = lg
    pf = SMC(fk=_boot(ssm, y), N=1000, qmc=True, store_history=True, seed=4)
    pf.run()
    paths = pf.hist.backward_sampling_qmc(torch.Generator().manual_seed(5),
                                          500)
    assert paths.shape == (30, 500)
    np.testing.assert_allclose(paths.mean(1).numpy(),
                               kf.smth.mean[:, 0].numpy(), atol=0.15)


def test_qmc_ffbs_by_blocks_is_the_same(lg, monkeypatch):
    """The rows go by blocks of at most PAIRS_PER_BLOCK pairs: small blocks
    give the same paths."""
    ssm, y, _ = lg
    pf = SQMC(fk=_boot(ssm, y), N=256, store_history=True, seed=6)
    pf.run()
    whole = pf.hist.backward_sampling_qmc(torch.Generator().manual_seed(7),
                                          100)
    monkeypatch.setattr(smoothing, "PAIRS_PER_BLOCK", 256 * 8)
    blocks = pf.hist.backward_sampling_qmc(torch.Generator().manual_seed(7),
                                           100)
    assert torch.equal(whole, blocks)


def test_qmc_ffbs_raises_on_a_history_not_in_hilbert_order(lg):
    ssm, y, _ = lg
    pf = SMC(fk=_boot(ssm, y), N=64, store_history=True)
    pf.run()
    with pytest.raises(ValueError, match="Hilbert"):
        pf.hist.backward_sampling_qmc(torch.Generator().manual_seed(0), 8)


def test_smoothing_worker_ffbs_qmc(lg):
    ssm, y, kf = lg

    class LGsmooth(kalman.LinearGauss):
        def add_func(self, t, xp, x):
            return x

    fk = _boot(LGsmooth(**PARAMS), y)
    out = smoothing.smoothing_worker(method="FFBS_QMC", N=500, fk=fk,
                                     add_func=fk.add_func, seed=2)
    assert out["est"].shape == (29,) and out["cpu"] > 0
    np.testing.assert_allclose(out["est"].numpy(),
                               kf.smth.mean[1:, 0].numpy(), atol=0.15)
