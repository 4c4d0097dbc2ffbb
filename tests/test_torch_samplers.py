"""The port's SMC samplers (``particles_tpu_torch.smc_samplers``) against
the JAX package and exact conjugate oracles.

JAX keys and torch generators give different streams, so the samplers are
compared in two ways.  Deterministic pieces get the same numpy inputs and
the same draws in both packages: the containers and the waste-free
resample by counts (exact), the calibrations (rtol 1e-5), one Metropolis
step and one waste-free move with the JAX package's normals and uniforms,
the exponent's bisection, the path-sampling sum, and one whole sampler
step of IBIS, Tempering and AdaptiveTempering from one state carried
across by ``convert.theta_particles_from_numpy`` (rtol 1e-5).  Whole runs
are held, as ``tests/test_smc_samplers.py`` holds the JAX package's, to
the exact evidence and posterior of a conjugate Gaussian model over 8
seeds, at that file's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import particles_tpu.distributions as jd
import particles_tpu.resampling as jrs
import particles_tpu.smc_samplers as jssp
from particles_tpu_torch import collectors, convert, core
from particles_tpu_torch import distributions as dists
from particles_tpu_torch import resampling as rs
from particles_tpu_torch import smc_samplers as ssp
from particles_tpu_torch.core import SMC, multiSMC

T_CONJ = 30
RTOL = 1e-5


class GaussianMean(ssp.StaticModel):
    """y_t ~ N(mu, 1), mu ~ N(0, 1): fully conjugate."""

    def logpyt(self, theta, t):
        return dists.Normal(loc=theta["mu"], scale=1.0).logpdf(self.data[t])


class JGaussianMean(jssp.StaticModel):
    def logpyt(self, theta, t):
        return jd.Normal(loc=theta["mu"], scale=1.0).logpdf(self.data[t])


class Logistic(ssp.StaticModel):
    """Logistic regression on sign-flipped rows, theta = b0..b{p-1}."""

    def logpyt(self, theta, t):
        p = self.data.shape[1]
        beta = torch.stack([theta[f"b{j}"] for j in range(p)], -1)
        return -torch.nn.functional.softplus(-(beta @ self.data[t]))


class JLogistic(jssp.StaticModel):
    def logpyt(self, theta, t):
        p = self.data.shape[1]
        beta = jnp.stack([theta[f"b{j}"] for j in range(p)], axis=-1)
        return -jax.nn.softplus(-(beta @ self.data[t]))


def _conj_y(T=T_CONJ):
    return np.random.default_rng(0).normal(loc=1.5, size=T).astype(
        np.float32)


def _conj_models(T=T_CONJ):
    y = _conj_y(T)
    jmodel = JGaussianMean(
        data=y, prior=jd.StructDist({"mu": jd.Normal(loc=0.0, scale=1.0)}))
    model = GaussianMean(
        data=y, prior=dists.StructDist({"mu": dists.Normal(0.0, 1.0)}),
        device="cpu")
    return jmodel, model


@pytest.fixture(scope="module")
def conj():
    y = _conj_y()
    T = y.shape[0]
    exact_ev = st.multivariate_normal(
        np.zeros(T), np.eye(T) + np.ones((T, T))).logpdf(y)
    post_var = 1.0 / (1.0 + T)
    return _conj_models()[1], exact_ev, post_var * y.sum(), post_var


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else \
        np.asarray(v)


def _assert_theta_close(jx, tx, rtol=RTOL, atol=1e-6):
    for k in jx.theta:
        np.testing.assert_allclose(_np(tx.theta[k]), np.asarray(jx.theta[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def _posterior_stats(pf):
    mu = _np(pf.X.theta["mu"]).astype(np.float64)
    W = _np(pf.wgts.W).astype(np.float64)
    m = np.sum(W * mu)
    return m, np.sum(W * mu ** 2) - m ** 2


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

def _theta_np(rng, N):
    return {"a": rng.normal(size=N).astype(np.float32),
            "b": rng.normal(size=(N, 3)).astype(np.float32),
            "c": rng.normal(size=N).astype(np.float32)}


def test_view_2d_array_round_trip_matches_jax():
    th_np = _theta_np(np.random.default_rng(1), 11)
    th = {k: torch.from_numpy(v) for k, v in th_np.items()}
    arr = ssp.view_2d_array(th)
    jarr = jssp.view_2d_array({k: jnp.asarray(v) for k, v in th_np.items()})
    assert arr.shape == (11, 5)
    np.testing.assert_array_equal(arr.numpy(), np.asarray(jarr))
    back = ssp.theta_from_2d(arr, th)
    assert list(back) == list(th)
    for k in th:
        assert back[k].shape == th[k].shape
        assert torch.equal(back[k], th[k])


def test_all_distinct_and_fancy_list():
    objs = [{"v": i} for i in range(4)]
    out = ssp.all_distinct(objs, np.array([2, 2, 0, 2]))
    assert out[0] is objs[2]
    assert out[1] is not out[0] and out[3] is not out[0]
    out[1]["v"] = 99
    assert out[0]["v"] == 2
    fl = ssp.FancyList([[1], [2], [3]])
    for idx in (np.array([1, 1, 0]), torch.tensor([1, 1, 0])):
        sub = fl[idx]
        assert len(sub) == 3
        assert sub[0] is fl[1] and sub[1] is not sub[0] and sub[1] == [2]
    cat = ssp.gen_concatenate(fl, sub)
    assert isinstance(cat, ssp.FancyList) and len(cat) == 6
    assert [x for x in fl + sub] == [[1], [2], [3], [2], [2], [1]]
    dst = fl.copy()
    dst.copyto(ssp.FancyList([[7], [8], [9]]), where=[True, False, True])
    assert dst.data == [[7], [2], [9]] and fl.data == [[1], [2], [3]]
    assert torch.equal(ssp.gen_concatenate(torch.ones(2), torch.zeros(1)),
                       torch.tensor([1.0, 1.0, 0.0]))
    assert ssp.rec_to_dict({"a": 1}) == {"a": 1}


@pytest.mark.parametrize("P", [1, 4])
def test_subset_by_counts_matches_jax(P):
    """The waste-free resample picks M = N0/P of N0 particles (P = 4) or
    all N0 (P = 1): every leaf and dtype equal to the JAX package's on the
    same counts."""
    rng = np.random.default_rng(P)
    N0 = 64
    M = N0 // P
    th_np = _theta_np(rng, N0)
    ints = rng.integers(-2 ** 30, 2 ** 30, N0)
    lpost = rng.normal(size=N0).astype(np.float32)
    W = rng.dirichlet(np.full(N0, 0.3)).astype(np.float32)
    counts = np.asarray(jrs.resampling_counts(
        "systematic", jax.random.key(P), jnp.asarray(W), M=M))
    assert counts.sum() == M
    jx = jssp.ThetaParticles(theta={k: jnp.asarray(v)
                                    for k, v in th_np.items()},
                             lpost=jnp.asarray(lpost),
                             idx=jnp.asarray(ints.astype(np.int32)))
    tx = convert.theta_particles_from_numpy(
        th_np, {"lpost": lpost, "idx": ints.astype(np.int64)},
        {"exponent": np.float32(0.25)}, device="cpu")
    assert tx.idx.dtype == torch.int64 and tx.shared["exponent"].ndim == 0
    jout = jx.subset_by_counts(jnp.asarray(counts), M)
    tout = tx.subset_by_counts(torch.tensor(counts), M)
    assert tout.N == M
    for k in th_np:
        assert torch.equal(tout.theta[k], torch.tensor(
            np.asarray(jout.theta[k])))
    assert torch.equal(tout.lpost, torch.tensor(np.asarray(jout.lpost)))
    np.testing.assert_array_equal(tout.idx.numpy(), np.asarray(jout.idx))
    assert tout.shared["exponent"] is tx.shared["exponent"]
    # by ancestors, the same result
    A = torch.repeat_interleave(torch.arange(N0), torch.tensor(counts))
    by_a = tx.subset(A)
    for k in th_np:
        assert torch.equal(by_a.theta[k], tout.theta[k])


def test_theta_particles_container_ops():
    rng = np.random.default_rng(5)
    tx = convert.theta_particles_from_numpy(
        _theta_np(rng, 6), {"lpost": rng.normal(size=6)}, device="cpu")
    ty = tx.map_fields(lambda a: a + 1)
    mask = torch.tensor([True, False, True, False, True, False])
    tw = ty.where(mask, tx)
    assert torch.equal(tw.theta["b"][0], ty.theta["b"][0])
    assert torch.equal(tw.theta["b"][1], tx.theta["b"][1])
    assert torch.equal(tw.lpost[1::2], tx.lpost[1::2])
    cat = ssp.ThetaParticles.concatenate(tx, ty.with_shared(s=1))
    assert cat.N == 12 and cat.shared == {"s": 1}
    assert torch.equal(cat.theta["b"][6:], ty.theta["b"])
    rep = tx.replace(lpost=torch.zeros(6))
    assert torch.equal(rep.lpost, torch.zeros(6)) and rep.theta is tx.theta
    cp = tx.copy()
    assert cp is not tx and cp.theta is tx.theta


# ---------------------------------------------------------------------------
# the moves, on the same draws
# ---------------------------------------------------------------------------

def _weighted_cloud(seed, N=40, d=3):
    rng = np.random.default_rng(seed)
    th_np = {"x": rng.normal(size=N).astype(np.float32),
             "y": (rng.normal(size=(N, d - 1)) * [1.0, 3.0] + [0.5, -1]
                   ).astype(np.float32)}
    W = rng.dirichlet(np.ones(N)).astype(np.float32)
    return th_np, W


@pytest.mark.parametrize("move", ["ArrayRandomWalk",
                                  "ArrayIndependentMetropolis"])
def test_calibrate_matches_jax(move):
    th_np, W = _weighted_cloud(2)
    jx = jssp.ThetaParticles(theta={k: jnp.asarray(v)
                                    for k, v in th_np.items()})
    tx = convert.theta_particles_from_numpy(th_np, device="cpu")
    jcal = getattr(jssp, move)().calibrate(jnp.asarray(W), jx)
    tcal = getattr(ssp, move)().calibrate(torch.from_numpy(W), tx)
    assert sorted(jcal) == sorted(tcal)
    for k in jcal:
        np.testing.assert_allclose(_np(tcal[k]), np.asarray(jcal[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)


def _jax_step_draws(key, M, d):
    """The normals and uniforms of one JAX ArrayMetropolis step."""
    k1, k2, _ = jax.random.split(key, 3)
    return (np.array(jax.random.normal(k1, (M, d))),
            np.array(jax.random.uniform(k2, (M,))))


def _ibis_pair(t):
    jmodel, model = _conj_models(8)
    jfk, fk = jssp.IBIS(model=jmodel), ssp.IBIS(model=model)
    return jfk.move_target(t, None), fk.move_target(t, None), jmodel, model


@pytest.mark.parametrize("move", ["ArrayRandomWalk",
                                  "ArrayIndependentMetropolis"])
def test_metropolis_step_matches_jax(move):
    """One step with the JAX package's normals and uniforms: theta and
    lpost at rtol 1e-5, and the accept decisions exact wherever the log
    acceptance ratio is more than 1e-5 from log u."""
    M = 64
    rng = np.random.default_rng(3)
    mu = rng.normal(loc=1.0, scale=0.5, size=M).astype(np.float32)
    jtarget, ttarget, jmodel, model = _ibis_pair(5)
    lpost = np.asarray(jmodel.logpost({"mu": jnp.asarray(mu)}, t=4))
    W = np.full(M, 1.0 / M, np.float32)
    jx = jssp.ThetaParticles(theta={"mu": jnp.asarray(mu)},
                             lpost=jnp.asarray(lpost))
    jmove, tmove = getattr(jssp, move)(), getattr(ssp, move)()
    jx = jx.with_shared(**jmove.calibrate(jnp.asarray(W), jx))
    tx = convert.theta_particles_from_numpy(
        {"mu": mu}, {"lpost": lpost},
        {k: np.asarray(v) for k, v in jx.shared.items()}, device="cpu")
    key = jax.random.key(7)
    jout, jacc = jmove.step(key, jx, jtarget)
    z, u = _jax_step_draws(key, M, 1)
    tout, tacc = tmove.step_with(tx, ttarget, torch.from_numpy(z),
                                 torch.from_numpy(u))
    # the accept decisions, from the proposals in float64
    L = np.asarray(jx.shared["chol_cov"], np.float64)
    mu64 = mu.astype(np.float64)
    if move == "ArrayRandomWalk":
        prop, dlp = mu64 + z[:, 0] * L[0, 0], 0.0
    else:
        m = float(np.asarray(jx.shared["mean"])[0])
        prop = m + z[:, 0] * L[0, 0]
        dlp = 0.5 * (z[:, 0] ** 2 - ((mu64 - m) / L[0, 0]) ** 2)
    # IBIS's target at t = 5 is the posterior of y_0..y_4
    lp_prop = (st.norm.logpdf(prop) + st.norm.logpdf(
        _conj_y(8)[:5, None], loc=prop).sum(0))
    log_ratio = np.minimum(lp_prop - lpost + dlp, 0.0)
    clear = np.abs(log_ratio - np.log(u)) > 1e-5
    jmoved = np.asarray(jout.theta["mu"]) != mu
    tmoved = tout.theta["mu"].numpy() != mu
    assert clear.sum() > M // 2 and 0 < jmoved.sum() < M
    np.testing.assert_array_equal(tmoved[clear], jmoved[clear])
    np.testing.assert_array_equal(tmoved[clear], (np.log(u) < log_ratio)[clear])
    _assert_theta_close(jout, tout)
    np.testing.assert_allclose(tout.lpost.numpy(), np.asarray(jout.lpost),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(tacc), float(jacc), rtol=RTOL)


@pytest.mark.parametrize("wastefree", [True, False])
def test_move_sequence_matches_jax(wastefree):
    """MCMCSequenceWF at P = 3 keeps [x0, x1, x2] in chain-position-major
    order, as the JAX package's; AdaptiveMCMCSequence keeps the last."""
    M, P = 32, 3
    rng = np.random.default_rng(4)
    mu = rng.normal(loc=1.0, scale=0.5, size=M).astype(np.float32)
    jtarget, ttarget, jmodel, _ = _ibis_pair(5)
    lpost = np.asarray(jmodel.logpost({"mu": jnp.asarray(mu)}, t=4))
    jx = jssp.ThetaParticles(theta={"mu": jnp.asarray(mu)},
                             lpost=jnp.asarray(lpost))
    cls = "MCMCSequenceWF" if wastefree else "AdaptiveMCMCSequence"
    jmove, tmove = getattr(jssp, cls)(len_chain=P), getattr(ssp, cls)(
        len_chain=P)
    jx = jx.with_shared(**jmove.calibrate(jnp.full(M, 1.0 / M), jx))
    tx = convert.theta_particles_from_numpy(
        {"mu": mu}, {"lpost": lpost},
        {k: np.asarray(v) for k, v in jx.shared.items()}, device="cpu")
    key = jax.random.key(11)
    jout = jmove(key, jx, jtarget)
    draws = [tuple(map(torch.from_numpy, _jax_step_draws(k, M, 1)))
             for k in jax.random.split(key, P - 1)]
    tout = tmove(None, tx, ttarget, draws=draws)
    assert tout.N == (M * P if wastefree else M)
    _assert_theta_close(jout, tout)
    np.testing.assert_allclose(tout.lpost.numpy(), np.asarray(jout.lpost),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(tout.shared["acc_rate"]),
                               float(jout.shared["acc_rate"]), rtol=RTOL)
    if wastefree:
        assert torch.equal(tout.theta["mu"][:M], torch.from_numpy(mu))
        assert tout.theta["mu"].is_contiguous()


def test_adaptive_move_stops_and_reports_realised_rate():
    _, model = _conj_models(8)
    fk = ssp.IBIS(model=model)
    gen = torch.Generator().manual_seed(0)
    mu = torch.randn(200, generator=gen) * 0.3 + 1.0
    x = ssp.ThetaParticles(theta={"mu": mu},
                           lpost=model.logpost({"mu": mu}, t=6))
    move = ssp.AdaptiveMCMCSequence(len_chain=50, adaptive=True,
                                    delta_dist=0.1)
    x = x.with_shared(**move.calibrate(torch.full((200,), 1 / 200), x))
    steps = []
    orig = move.mcmc.step_with

    def counting(*a, **kw):
        steps.append(1)
        return orig(*a, **kw)

    move.mcmc.step_with = counting
    out = move(gen, x, fk.move_target(7, x))
    assert 1 < len(steps) < 49       # stopped early
    acc = float(out.shared["acc_rate"])
    assert 0.0 < acc < 1.0 and out.N == 200


# ---------------------------------------------------------------------------
# the tempering solve and the path sampling
# ---------------------------------------------------------------------------

def _ess(lw):
    w = np.exp(lw - lw[np.isfinite(lw)].max())
    w = np.where(np.isfinite(lw), w, 0.0)
    return w.sum() ** 2 / (w ** 2).sum()


@pytest.mark.parametrize("epn", [0.0, 0.3])
def test_next_annealing_epn_matches_jax(epn):
    rng = np.random.default_rng(6)
    N0 = 500
    lw = (rng.normal(size=N0) * 20 - 50).astype(np.float32)
    lw[:7] = np.nan
    lw[7:12] = -np.inf
    alpha = 0.5
    e = float(ssp.next_annealing_epn(torch.tensor(epn), alpha,
                                     torch.from_numpy(lw)))
    je = float(jssp.next_annealing_epn(jnp.float32(epn), alpha,
                                       jnp.asarray(lw)))
    assert epn < e < 1.0
    lw64 = np.where(np.isnan(lw), -np.inf, lw).astype(np.float64)
    np.testing.assert_allclose(_ess((e - epn) * lw64), alpha * N0,
                               rtol=1e-4)
    np.testing.assert_allclose(e, je, rtol=1e-5)


def test_next_annealing_epn_reaches_one():
    """f(hi) >= 0: the full increment keeps the ESS above alpha N0."""
    lw = torch.full((100,), -3.0)
    lw[:3] = torch.nan
    assert float(ssp.next_annealing_epn(torch.tensor(0.6), 0.5, lw)) == 1.0
    small = torch.from_numpy(
        np.random.default_rng(0).normal(size=100).astype(np.float32) * 0.01)
    assert float(ssp.next_annealing_epn(torch.tensor(0.0), 0.5, small)) == 1.0


@pytest.mark.parametrize("delta", [0.05, 1.0])
def test_path_sampling_update_matches_jax(delta):
    rng = np.random.default_rng(8)
    N0 = 300
    llik = (rng.normal(size=N0) * 30 - 100).astype(np.float32)
    llik[[0, 5, 77]] = -np.inf
    jx = jssp.ThetaParticles(theta={"mu": jnp.zeros(N0)},
                             llik=jnp.asarray(llik),
                             shared={"path_sampling": jnp.float32(-2.5)})
    tx = convert.theta_particles_from_numpy(
        {"mu": np.zeros(N0, np.float32)}, {"llik": llik},
        {"path_sampling": np.float32(-2.5)}, device="cpu")
    jv = float(jssp.Tempering()._path_sampling_update(jx, jnp.float32(delta)))
    tv = float(ssp.Tempering()._path_sampling_update(tx, torch.tensor(delta)))
    assert np.isfinite(tv)
    np.testing.assert_allclose(tv, jv, rtol=RTOL)


# ---------------------------------------------------------------------------
# one whole sampler step, from one state, on the same draws
# ---------------------------------------------------------------------------

_STEP_CASES = {
    "IBIS resampling": ("IBIS", dict(len_chain=3), 1.1),
    "IBIS no resampling": ("IBIS", dict(len_chain=3), 0.01),
    "Tempering": ("Tempering", dict(len_chain=3,
                                    exponents=[0.05, 0.5, 1.0]), 1.1),
    "AdaptiveTempering": ("AdaptiveTempering", dict(len_chain=3), 0.5),
}


@pytest.mark.parametrize("case", list(_STEP_CASES))
def test_sampler_step_matches_jax(case):
    cls, kw, ESSrmin = _STEP_CASES[case]
    N, T = 16, 10
    jmodel, model = _conj_models(T)
    jfk = getattr(jssp, cls)(model=jmodel, **kw)
    fk = getattr(ssp, cls)(model=model, **kw)
    jcarry = jssp._sampler_step0(jfk, jax.random.key(3), N)
    X = jcarry.X
    fields = {k: np.asarray(v) for k, v in X._particle_fields().items()
              if k != "theta"}
    tX = convert.theta_particles_from_numpy(
        {k: np.asarray(v) for k, v in X.theta.items()}, fields,
        {k: np.asarray(v) for k, v in X.shared.items()}, device="cpu")
    carry = core._Carry(
        X=tX, lw=torch.tensor(np.asarray(jcarry.lw)),
        logLt=torch.tensor(float(jcarry.logLt)),
        log_mean_w=torch.tensor(float(jcarry.log_mean_w)))
    t = 1
    jnew, jview = jssp._sampler_step(jfk, jcarry, jnp.int32(t), N,
                                     "systematic", ESSrmin)
    # the JAX step's draws: the systematic uniform, then the move's
    _, k_rs, k_mv = jax.random.split(jcarry.key, 3)
    draws = {"rs_u": torch.tensor(float(jax.random.uniform(k_rs, ()))),
             "move": [tuple(map(torch.from_numpy, _jax_step_draws(k, N, 1)))
                      for k in jax.random.split(k_mv, 2)]}
    new, view = ssp._sampler_step(fk, None, carry, t, N, "systematic",
                                  ESSrmin, draws=draws)
    assert view.rs_flag == bool(jview.rs_flag)
    assert view.rs_flag == (ESSrmin > 0.1)   # the branch the case names
    assert new.X.N == jnew.X.N == N * 3
    _assert_theta_close(jnew.X, new.X)
    for k in fields:
        np.testing.assert_allclose(_np(getattr(new.X, k)),
                                   np.asarray(getattr(jnew.X, k)),
                                   rtol=RTOL, atol=1e-4, err_msg=k)
    for k in jnew.X.shared:
        np.testing.assert_allclose(_np(new.X.shared[k]),
                                   np.asarray(jnew.X.shared[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(new.lw.numpy(), np.asarray(jnew.lw),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(new.logLt), float(jnew.logLt),
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# whole runs against the conjugate oracle (tests/test_smc_samplers.py)
# ---------------------------------------------------------------------------

def test_ibis_evidence_and_posterior(conj):
    model, exact_ev, post_mean, _ = conj
    logLts, means = [], []
    for s in range(8):
        pf = SMC(fk=ssp.IBIS(model=model, len_chain=5), N=200, seed=s)
        pf.run()
        assert pf.X.N == 1000 and pf.t == T_CONJ
        logLts.append(float(pf.logLt))
        means.append(_posterior_stats(pf)[0])
    assert abs(np.mean(logLts) - exact_ev) < 0.15, (np.mean(logLts), exact_ev)
    assert abs(np.mean(means) - post_mean) < 0.05


def test_ibis_standard_not_wastefree(conj):
    """Each of 8 seeds at the JAX test's one-run tolerances."""
    model, exact_ev, post_mean, _ = conj
    for s in range(8):
        pf = SMC(fk=ssp.IBIS(model=model, wastefree=False, len_chain=6),
                 N=1000, seed=s)
        pf.run()
        assert abs(float(pf.logLt) - exact_ev) < 0.6, s
        assert abs(_posterior_stats(pf)[0] - post_mean) < 0.1, s
        assert pf.X.N == 1000


def test_adaptive_tempering_evidence_and_posterior(conj):
    model, exact_ev, post_mean, post_var = conj
    logLts, pss, means, vars_ = [], [], [], []
    for s in range(8):
        pf = SMC(fk=ssp.AdaptiveTempering(model=model, len_chain=5), N=200,
                 seed=s)
        pf.run()
        assert float(pf.X.shared["exponent"]) == 1.0
        logLts.append(float(pf.logLt))
        pss.append(float(pf.X.shared["path_sampling"]))
        m, v = _posterior_stats(pf)
        means.append(m)
        vars_.append(v)
    assert abs(np.mean(logLts) - exact_ev) < 0.15
    assert abs(np.mean(pss) - exact_ev) < 0.3
    assert abs(np.mean(means) - post_mean) < 0.05
    assert abs(np.mean(vars_) - post_var) < 0.02


def test_tempering_fixed_exponents(conj):
    model, exact_ev, *_ = conj
    fk = ssp.Tempering(model=model, exponents=np.linspace(0.1, 1.0, 10),
                       len_chain=5)
    logLts = []
    for s in range(8):
        pf = SMC(fk=fk, N=300, seed=s)
        pf.run()
        assert pf.t == 10
        logLts.append(float(pf.logLt))
    assert abs(logLts[1] - exact_ev) < 0.5
    assert abs(np.mean(logLts) - exact_ev) < 0.15


@pytest.mark.parametrize("scheme", ["stratified", "multinomial", "residual",
                                    "ssp"])
def test_schemes_and_independent_metropolis(conj, scheme):
    model, exact_ev, *_ = conj
    move = ssp.MCMCSequenceWF(mcmc=ssp.ArrayIndependentMetropolis(),
                              len_chain=5)
    pf = SMC(fk=ssp.AdaptiveTempering(model=model, len_chain=5, move=move),
             N=300, seed=2, resampling=scheme)
    pf.run()
    assert abs(float(pf.logLt) - exact_ev) < 0.5


def test_adaptive_mcmc_sequence(conj):
    model, exact_ev, *_ = conj
    move = ssp.AdaptiveMCMCSequence(len_chain=12, adaptive=True)
    pf = SMC(fk=ssp.AdaptiveTempering(model=model, wastefree=False,
                                      len_chain=12, move=move),
             N=500, seed=3)
    pf.run()
    assert float(pf.X.shared["exponent"]) == 1.0
    assert pf.X.N == 500 and abs(float(pf.logLt) - exact_ev) < 0.6


def test_tempering_bridge():
    """From N(0, 3^2) to N(2, 0.5^2): the mean, and log Z = 0."""

    class Bridge(ssp.TemperingBridge):
        def logtarget(self, theta):
            return dists.Normal(loc=2.0, scale=0.5).logpdf(theta["x"])

    model = Bridge(base_dist=dists.StructDist(
        {"x": dists.Normal(loc=0.0, scale=3.0)}))
    pf = SMC(fk=ssp.AdaptiveTempering(model=model, len_chain=6), N=300,
             seed=4, device="cpu")
    pf.run()
    W = _np(pf.wgts.W)
    assert abs(np.sum(W * _np(pf.X.theta["x"])) - 2.0) < 0.1
    assert abs(float(pf.logLt)) < 0.2


@pytest.mark.parametrize("scheme", ["killing", "idiotic"])
def test_ancestor_only_schemes_raise(conj, scheme):
    with pytest.raises(ValueError, match="counts-based"):
        SMC(fk=ssp.IBIS(model=conj[0]), N=50, resampling=scheme)
    W = torch.full((8,), 1 / 8)
    with pytest.raises(ValueError):
        rs.resampling_z(scheme, torch.Generator(), W, 8)


# ---------------------------------------------------------------------------
# the model's log-likelihood
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [None, 0, 6])
def test_loglik_matches_jax(t, monkeypatch):
    """The vmapped, masked log-likelihood of a logistic regression (data
    rows indexed by a batched t), NaN -> -inf, in chunks of particles."""
    rng = np.random.default_rng(9)
    T, p, N = 12, 4, 50
    data = rng.normal(size=(T, p)).astype(np.float32)
    th_np = {f"b{j}": rng.normal(size=N).astype(np.float32)
             for j in range(p)}
    th_np["b0"][3] = np.nan
    jm = JLogistic(data=data, prior=None)
    tm = Logistic(data=data, prior=None, device="cpu")
    want = np.asarray(jm.loglik({k: jnp.asarray(v) for k, v in th_np.items()},
                                t=t))
    th = {k: torch.from_numpy(v) for k, v in th_np.items()}
    got = tm.loglik(th, t=t)
    assert got.shape == (N,) and got[3] == -np.inf
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)
    # in chunks of 7 particles: the same sums, up to the matmul's blocking
    monkeypatch.setattr(ssp, "LOGLIK_CHUNK", 7 * T)
    np.testing.assert_allclose(tm.loglik(th, t=t).numpy(), got.numpy(),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the single-run variance estimators
# ---------------------------------------------------------------------------

def test_variance_estimators_match_jax():
    """var_wf, Var_phi and Var_logLt on one waste-free state (N0 = M·P),
    equal to the JAX package's (the same numpy on the same arrays)."""
    rng = np.random.default_rng(10)
    M, P = 20, 6
    mu = rng.normal(size=M * P).astype(np.float32)
    lw = (rng.normal(size=M * P) * 2).astype(np.float32)
    jw, tw = jrs.Weights(jnp.asarray(lw)), rs.Weights(torch.from_numpy(lw))
    jx = jssp.ThetaParticles(theta={"mu": jnp.asarray(mu)})
    tx = convert.theta_particles_from_numpy({"mu": mu}, device="cpu")

    class V:
        def __init__(self, X, wgts, rs_flag):
            self.X, self.wgts, self.N, self.rs_flag = X, wgts, M, rs_flag

    jv, tv = V(jx, jw, True), V(tx, tw, True)
    v = ssp.var_wf(tv, lambda x: x.theta["mu"])
    assert v > 0
    np.testing.assert_allclose(
        v, jssp.var_wf(jv, lambda x: np.asarray(x.theta["mu"])), rtol=1e-6)
    np.testing.assert_allclose(
        ssp.Var_phi(phi=lambda x: x.theta["mu"]).collect(tv),
        jssp.Var_phi(phi=lambda x: np.asarray(x.theta["mu"])).collect(jv),
        rtol=1e-6)
    jc, tc = jssp.Var_logLt(), ssp.Var_logLt()
    js, jo = jc.init(jv)
    ts, to = tc.init(tv)
    np.testing.assert_allclose(to, jo, rtol=1e-6)
    for _ in range(2):
        js, jo = jc.step(jv, js)
        ts, to = tc.step(tv, ts)
        np.testing.assert_allclose(to, jo, rtol=1e-6)
    assert ssp.Var_phi.host_side and issubclass(ssp.Var_phi,
                                                collectors.Collector)
    assert collectors.Summaries([ssp.Var_logLt()]).has_host_side


def test_variance_collectors_in_a_run(conj):
    model, *_ = conj
    pf = SMC(fk=ssp.AdaptiveTempering(model=model, len_chain=10), N=100,
             seed=2, collect=[ssp.Var_phi(phi=lambda x: x.theta["mu"]),
                              ssp.Var_logLt(), collectors.Moments()])
    assert pf.summaries.has_host_side
    pf.run()
    assert len(pf.summaries.var_phi) == pf.t == len(pf.summaries.var_logLt)
    assert all(np.isfinite(float(v)) and float(v) >= 0
               for v in pf.summaries.var_phi)
    v = ssp.var_wf(pf, lambda x: x.theta["mu"])
    assert v > 0 and v / pf.wgts.W.shape[0] < 1.0
    assert not SMC(fk=ssp.IBIS(model=model), N=10).summaries.has_host_side


def test_moments_collector(conj):
    model, _, post_mean, _ = conj
    pf = SMC(fk=ssp.IBIS(model=model, len_chain=5), N=200, seed=0,
             collect=[collectors.Moments()])
    pf.run()
    moms = pf.summaries.moments
    assert len(moms) == T_CONJ
    assert abs(float(moms[-1]["mean"]["mu"]) - post_mean) < 0.1
    assert pf.summaries.rs_flags.dtype == torch.bool
    assert pf.summaries.ESSs.shape == (T_CONJ,)


# ---------------------------------------------------------------------------
# history, importance sampling, multiSMC, the iterator protocol
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option", [True, 3, "even"])
def test_sampler_history(conj, option):
    model, *_ = conj
    opt = (lambda t: t % 2 == 0) if option == "even" else option
    pf = SMC(fk=ssp.IBIS(model=model, len_chain=3), N=50, seed=1,
             store_history=opt)
    pf.run()
    h = pf.hist
    assert isinstance(h, ssp.SamplerHistory)
    want = {True: list(range(T_CONJ)), 3: [27, 28, 29],
            "even": list(range(0, T_CONJ, 2))}[option]
    assert list(h.times) == want and h.T == len(want)
    assert h.X[-1].N == 150 and isinstance(h.wgts[-1], rs.Weights)
    if option is True:
        assert h.X[-1] is pf.X and h.wgts[-1] is pf.wgts
    with pytest.raises(ValueError):
        ssp.SamplerHistory(0)


def test_importance_sampler(conj):
    model, exact_ev, post_mean, _ = conj
    ests = []
    for s in range(4):
        ism = ssp.ImportanceSampler(model=model)
        ism.run(N=20000, seed=s)
        ests.append(float(ism.log_norm_cst))
        assert ism.X.N == 20000 and ism.wgts.W.shape == (20000,)
    assert abs(np.mean(ests) - exact_ev) < 0.5
    W = _np(ism.wgts.W)
    assert abs(np.sum(W * _np(ism.X.theta["mu"])) - post_mean) < 0.1
    # a given generator: the same draws
    a, b = ssp.ImportanceSampler(model=model), ssp.ImportanceSampler(
        model=model)
    a.run(N=100, generator=torch.Generator().manual_seed(3))
    b.run(N=100, seed=3)
    assert torch.equal(a.X.theta["mu"], b.X.theta["mu"])


def test_multismc_with_a_sampler(conj):
    model, exact_ev, *_ = conj
    fks = {"ibis": ssp.IBIS(model=model, len_chain=4),
           "tempering": ssp.AdaptiveTempering(model=model, len_chain=4)}
    out = multiSMC(fk=fks, N=200, nruns=2, seed=3,
                   resampling=["systematic", "stratified"])
    assert len(out) == 8
    for entry in out:
        res = entry["output"]
        assert abs(float(res.logLt) - exact_ev) < 0.6, entry
        assert res.lw.shape == (800,) and res.ESSs.ndim == 1
    assert {e["fk"] for e in out} == {"ibis", "tempering"}


def test_iterator_protocol_and_verbose(conj, capsys):
    model, *_ = conj
    pf = SMC(fk=ssp.IBIS(model=model, len_chain=3), N=40, seed=0,
             verbose=True)
    next(pf)
    next(pf)
    assert pf.t == 2 and pf.X.N == 120
    pf.run()
    assert pf.t == T_CONJ
    out = capsys.readouterr().out.splitlines()
    assert len(out) == T_CONJ and out[-1].startswith("t=29, Metropolis")
    assert pf.device.type == "cpu" and pf.gen.device.type == "cpu"
