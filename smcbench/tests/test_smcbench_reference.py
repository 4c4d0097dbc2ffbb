"""The plain references against closed forms, and the sampler's
recomputations against cases built by hand."""

import importlib
import math

import numpy as np
import pytest
import scipy.stats as st
import torch

from smcbench.lib import spec

kalman_ref = importlib.import_module("smcbench.reference.lingauss")
logit_ref = spec.load_module(spec.BENCH_DIR / "reference" / "sonar-logit.py",
                             "smcbench_reference_sonar_logit")


def _joint(T, rho, sx, sy):
    """The covariance of (x_0..x_{T-1}) and of y of the stationary model."""
    s0 = sx ** 2 / (1 - rho ** 2)
    i = np.arange(T)
    cx = s0 * rho ** np.abs(i[:, None] - i[None, :])
    return cx, cx + sy ** 2 * np.eye(T)


def test_kalman_against_the_joint_gaussian():
    """logLt is the joint normal log-density of y; the filtered mean at t
    is E[x_t | y_0..y_t] by conditioning."""
    rho, sx, sy, T = 0.9, 1.0, 0.2, 7
    y = np.random.default_rng(3).normal(size=T)
    m, v, L, _, _ = kalman_ref.kalman(y, rho, sx, sy)
    for t in range(T):
        cx, cy = _joint(t + 1, rho, sx, sy)
        assert L[t] == pytest.approx(st.multivariate_normal(
            np.zeros(t + 1), cy).logpdf(y[:t + 1]), abs=1e-9)
        gain = np.linalg.solve(cy, cx[:, t])
        assert m[t] == pytest.approx(gain @ y[:t + 1], abs=1e-9)
        assert v[t] == pytest.approx(cx[t, t] - gain @ cx[:, t], abs=1e-9)


def test_importance_variances_against_quadrature():
    """V_t and the log-weight variance of one step against a direct
    integral over the predictive law."""
    rho, sx, sy = 0.9, 1.0, 0.2
    y = np.array([0.3, 2.5])
    m, _, _, vm, vl = kalman_ref.kalman(y, rho, sx, sy)
    s0 = sx / math.sqrt(1 - rho ** 2)
    x = np.linspace(-12 * s0, 12 * s0, 400001)
    p = st.norm.pdf(x, 0.0, s0)
    w = np.exp(-0.5 * (y[0] - x) ** 2 / sy ** 2)
    ew = np.trapezoid(w * p, x)
    assert vm[0] == pytest.approx(
        np.trapezoid(w ** 2 * (x - m[0]) ** 2 * p, x) / ew ** 2, rel=1e-6)
    assert vl[0] == pytest.approx(np.trapezoid(w ** 2 * p, x) / ew ** 2 - 1,
                                  rel=1e-6)


def test_exact_filter_reads_zero_and_control_reads_high():
    cfg = spec.find_cell("lingauss.boot.n26").config
    y = np.random.default_rng(5).normal(size=300).astype(np.float32)
    m, _, L, _, _ = kalman_ref.kalman(y.astype(np.float64), cfg["rho"],
                                      cfg["sigmaX"], cfg["sigmaY"])
    out = {"N": 1 << 24, "runs": [{"means": m, "logLt": L[-1]}]}
    got = kalman_ref.judge(cfg, {}, {"y": y}, out, None)
    assert got == {"mean_err_med": 0.0, "mean_max_err": 0.0,
                   "loglik_err": 0.0}
    run = kalman_ref.KalmanRun(y, cfg, torch.device("cpu"))
    for _ in range(len(y)):
        run.step()
    means, logLt = run.finish()
    out = {"N": 1 << 24, "runs": [{"means": means.double().numpy(),
                                   "logLt": float(logLt)}]}
    got = kalman_ref.judge(cfg, {}, {"y": y}, out, None)
    assert got["mean_err_med"] > 10 and got["loglik_err"] > 10


def test_loglik64_and_prior_against_numpy():
    g = np.random.default_rng(0)
    data = g.normal(size=(20, 5)).astype(np.float32)
    theta = torch.as_tensor(g.normal(scale=3, size=(9, 5)), dtype=torch.float32)
    got = logit_ref.loglik64(torch, theta, data).numpy()
    th = theta.double().numpy()
    want = np.array([-np.logaddexp(0.0, -(data.astype(np.float64) @ r)).sum()
                     for r in th])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    lp = logit_ref.lprior64(torch, theta, 5.0).numpy()
    np.testing.assert_allclose(lp, st.norm.logpdf(th, 0, 5).sum(1),
                               rtol=1e-12)


def test_next_exponent_hits_the_ess():
    llik = torch.as_tensor(np.random.default_rng(1).normal(-300, 40,
                                                            size=5000))
    e = logit_ref.next_exponent(torch, 0.01, llik, 0.5)
    ess = logit_ref.ess64(torch, (e - 0.01) * llik)
    assert ess == pytest.approx(2500, rel=1e-9)
    flat = torch.full((100,), -3.0, dtype=torch.float64)
    assert logit_ref.next_exponent(torch, 0.3, flat, 0.5) == 1.0


def _systematic(W, M, u):
    cs = np.cumsum(W)
    z = np.floor(M * cs + u).astype(np.int64)
    z[-1] = M
    return np.diff(np.concatenate([[0], z]))


def test_count_err_sound_and_broken():
    g = np.random.default_rng(2)
    N, M, d = 4000, 400, 3
    theta = torch.as_tensor(g.normal(size=(N, d)), dtype=torch.float32)
    theta[1::7] = theta[0::7][:theta[1::7].shape[0]]   # repeated states
    lw = torch.as_tensor(g.normal(size=N) * 2)
    W = torch.softmax(lw.double(), 0).numpy()
    counts = _systematic(W, M, 0.37)
    A = np.repeat(np.arange(N), counts)
    starts = theta[torch.as_tensor(A)]
    err = logit_ref.count_err(torch, theta, lw, starts)
    assert err < 1.0
    broken = starts.clone()
    broken[: M // 2] = starts[0]
    assert logit_ref.count_err(torch, theta, lw, broken) > 3
    alien = starts.clone()
    alien[5, 0] += 1.0
    assert logit_ref.count_err(torch, theta, lw, alien) == math.inf


def test_acc_gap_and_prior_z():
    g = np.random.default_rng(4)
    P, M, d = 5, 20000, 2
    chains = np.empty((P, M, d), dtype=np.float32)
    chains[0] = g.normal(size=(M, d))
    acc = 0.3
    for p in range(1, P):
        move = g.uniform(size=M) < acc
        chains[p] = np.where(move[:, None], g.normal(size=(M, d)),
                             chains[p - 1])
    theta = torch.as_tensor(chains.reshape(P * M, d))
    assert logit_ref.acc_gap(torch, theta, P, acc) < 4
    assert logit_ref.acc_gap(torch, theta, P, 0.5) > 20
    draws = torch.as_tensor(g.normal(scale=5, size=(100000, 4)),
                            dtype=torch.float32)
    assert logit_ref.prior_z(torch, draws, 5.0) < 5
    assert logit_ref.prior_z(torch, draws, 4.0) > 50


def _mh_chains(g, data, theta_b, epn, P, M, power):
    """(P M, d) random-walk Metropolis chains of the tempered logistic
    posterior, with the random walk ``move_acc_z`` works out from the
    unweighted ``theta_b``, accepting at ``power`` times the log ratio
    (1: sound)."""
    d = theta_b.shape[1]
    tb = theta_b.double()
    xc = tb - tb.mean(0)
    L = (2.38 / math.sqrt(d)) * torch.linalg.cholesky(
        xc.T @ xc / tb.shape[0] + 1e-9 * torch.eye(d, dtype=torch.float64))
    x = tb[:M].clone()
    out = [x]
    for _ in range(P - 1):
        prop = x + torch.as_tensor(g.normal(size=(M, d))) @ L.T
        r = (logit_ref.lpost64(torch, prop, data, 5.0, epn)
             - logit_ref.lpost64(torch, x, data, 5.0, epn))
        u = torch.as_tensor(g.uniform(size=M))
        x = torch.where((u < torch.exp((power * r).clamp(max=0.0)))[:, None],
                        prop, x)
        out.append(x)
    return torch.cat(out).float()


def test_move_acc_z_sound_and_wrong_target():
    """Chains of a sound move read about a standard normal, even started
    away from the target; chains that accept at twice the log ratio read
    far above."""
    g = np.random.default_rng(6)
    n, d, P, M, epn = 40, 3, 5, 4000, 0.7
    data = g.normal(size=(n, d)).astype(np.float32)
    theta_b = torch.as_tensor(g.normal(scale=0.3, size=(P * M, d)),
                              dtype=torch.float32)
    lw_b = torch.zeros(P * M, dtype=torch.float64)
    sound = _mh_chains(g, data, theta_b, epn, P, M, 1.0)
    wrong = _mh_chains(g, data, theta_b, epn, P, M, 2.0)
    args = (theta_b, lw_b, epn, data, 5.0, P, 11)
    assert logit_ref.move_acc_z(torch, sound, *args) < 4
    assert logit_ref.move_acc_z(torch, wrong, *args) > 10


def test_sampler_numbers_need_their_steps():
    """Numbers that no kept step gives are missing, and so fail: a window
    with only step 0 kept has no resampling or move to judge."""
    from smcbench.lib import result

    cfg = spec.find_cell("sonar-logit.awf.m20").config
    lims = spec.find_cell("sonar-logit.awf.m20").traffic["limits"]
    got = logit_ref.judge(cfg, {"ESSrmin": 0.5}, {"data": np.zeros((3, 61),
                                                                   np.float32)},
                          {"M": 4, "P": 2, "checks": []}, None)
    assert got == {}
    ok, rows = result.judge(got, lims)
    assert not ok and all(v is None for _, v, _ in rows)
