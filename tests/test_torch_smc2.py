"""The port's SMC² (``particles_tpu_torch.smc_samplers.SMC2``) and its
batched inner filter (``particles_tpu_torch.inner_pf.InnerPF``) against
the JAX package and exact oracles.

JAX keys and torch generators give different streams, so the inner filter
is held to the JAX functions on the JAX package's own draws: one batched
step of B = 3 θ-rows against ``SMC2._inner_step`` run row by row, and a
replay to t = 4 against ``SMC2._replay_one``, both within 1e-5, with the
systematic uniform (or the stratified uniforms, or the multinomial
exponentials) and the transition's normals replayed from the keys the
JAX functions split.  The exchange step's accounting is held to the
fixed-delta expectation of ``tests/test_smc_samplers.py`` (1e-4), and
whole runs to the Kalman grid evidence and posterior mean at that file's
shape and tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp

import particles_tpu.distributions as jd
import particles_tpu.smc_samplers as jssp
import particles_tpu.state_space_models as jssms
from particles_tpu_torch import distributions as dists
from particles_tpu_torch import inner_pf, kalman
from particles_tpu_torch import smc_samplers as ssp
from particles_tpu_torch import state_space_models as ssms
from particles_tpu_torch.core import SMC

TOL = 1e-5
SV_THETA = {"mu": np.array([-1.0, -0.5, -1.3], np.float32),
            "rho": np.array([0.9, 0.7, 0.95], np.float32),
            "sigma": np.array([0.3, 0.5, 0.2], np.float32)}
NX = 64


def _sv_data(T=8):
    rng = np.random.default_rng(3)
    return (0.8 * rng.normal(size=T)).astype(np.float32)


def _np(v):
    return v.detach().cpu().numpy()


def _jax_sv_smc2(fk_name, scheme, y):
    prior = jd.StructDist({"mu": jd.Normal(scale=2.0),
                           "rho": jd.Uniform(a=-0.99, b=0.99),
                           "sigma": jd.Gamma(a=2.0, b=4.0)})
    return jssp.SMC2(ssm_cls=jssms.StochVol, prior=prior, data=y,
                     init_Nx=NX, fk_cls=getattr(jssms, fk_name),
                     smc_options={"resampling": scheme})


def _port_pf(fk_name, scheme, y, Nx=NX, theta=SV_THETA):
    th = {k: torch.from_numpy(v) for k, v in theta.items()}
    return inner_pf.InnerPF(getattr(ssms, fk_name), ssms.StochVol,
                            torch.from_numpy(y), th, Nx, resampling=scheme)


def _law(fk, fk_name, t, xp):
    """The transition law the filter draws from at t (xp None: time 0)."""
    if xp is None:
        return (fk.ssm.PX0() if fk_name == "Bootstrap"
                else fk.ssm.proposal0(fk.data))
    return (fk.ssm.PX(t, xp) if fk_name == "Bootstrap"
            else fk.ssm.proposal(t, xp, fk.data))


def _jax_step_draws(key, scheme, fk_name):
    """The draws ``SMC2._inner_step(key, ...)`` makes: its resampling
    scheme's uniform(s) or exponentials from k_rs, the normals from k_m."""
    k_rs, k_m = jax.random.split(key)
    if scheme == "systematic":
        r = np.asarray(jax.random.uniform(k_rs, ()))
    elif scheme == "stratified":
        r = np.asarray(jax.random.uniform(k_rs, (NX,)))
    else:
        r = np.asarray(jax.random.exponential(k_rs, (NX + 1,)))
    return r, np.asarray(jax.random.normal(k_m, (NX,)))


def _port_draws(rows, fk_name):
    """(rs_draw, move) from the rows' JAX draws."""
    r = torch.from_numpy(np.stack([d[0] for d in rows]))
    eps = torch.from_numpy(np.concatenate([d[1] for d in rows]))

    def move(fk, t, xp):
        law = _law(fk, fk_name, t, xp)
        return law.loc + law.scale * eps

    return r, move


def _theta_row(b):
    return {k: jnp.float32(v[b]) for k, v in SV_THETA.items()}


CASES = [(s, f) for f in ("Bootstrap", "GuidedPF")
         for s in ("systematic", "stratified", "multinomial")]


@pytest.mark.parametrize("scheme,fk_name", CASES)
def test_inner_step_matches_jax_inner_step(scheme, fk_name):
    """One batched step of 3 rows against ``SMC2._inner_step`` of each row,
    on its draws: row 0 degenerate (resamples), row 1 flat (does not),
    row 2 in between."""
    y = _sv_data()
    rng = np.random.default_rng(5)
    xs = rng.normal(-1.0, 0.5, size=(3, NX)).astype(np.float32)
    lws = np.stack([rng.normal(scale=s, size=NX) for s in (4.0, 0.05, 1.2)]
                   ).astype(np.float32)
    t = 3
    inner_step = jax.jit(_jax_sv_smc2(fk_name, scheme, y)._inner_step,
                         static_argnums=4)
    keys = jax.random.split(jax.random.key(11), 3)
    want, rows = [], []
    for b in range(3):
        want.append(inner_step(keys[b], _theta_row(b), jnp.asarray(xs[b]),
                               jnp.asarray(lws[b]), t))
        rows.append(_jax_step_draws(keys[b], scheme, fk_name))
    pf = _port_pf(fk_name, scheme, y)
    got = pf.step_with(t, torch.from_numpy(xs), torch.from_numpy(lws),
                       *_port_draws(rows, fk_name))
    for b in range(3):
        for g, w, what in zip(got, want[b], ("xs", "lws", "loglt")):
            np.testing.assert_allclose(_np(g[b]), np.asarray(w), rtol=TOL,
                                       atol=TOL, err_msg=f"row {b} {what}")


@pytest.mark.parametrize("fk_name", ["Bootstrap", "GuidedPF"])
def test_replay_matches_jax_replay_one(fk_name):
    """A fresh filter over observations 0..3 against ``_replay_one``, on
    its draws (M0's normals from the key, step s's from fold_in(key, s))."""
    y, t, scheme = _sv_data(), 4, "systematic"
    replay_one = jax.jit(_jax_sv_smc2(fk_name, scheme, y)._replay_one,
                         static_argnums=(2, 3))
    keys = jax.random.split(jax.random.key(12), 3)
    want = [replay_one(keys[b], _theta_row(b), t, NX) for b in range(3)]
    eps0 = torch.from_numpy(np.concatenate(
        [np.asarray(jax.random.normal(k, (NX,))) for k in keys]))

    def move0(fk):
        law = _law(fk, fk_name, 0, None)
        return law.loc + law.scale * eps0

    steps = [_port_draws([_jax_step_draws(jax.random.fold_in(k, s), scheme,
                                          fk_name) for k in keys], fk_name)
             for s in range(1, t)]
    pf = _port_pf(fk_name, scheme, y)
    got = pf.replay(None, t, draws=(move0, steps))
    for b in range(3):
        for g, w, what in zip(got, want[b], ("xs", "lws", "loglik")):
            np.testing.assert_allclose(_np(g[b]), np.asarray(w), rtol=TOL,
                                       atol=TOL, err_msg=f"row {b} {what}")


@pytest.mark.parametrize("fk_name", ["Bootstrap", "GuidedPF",
                                     "AuxiliaryBootstrap", "AuxiliaryPF"])
def test_inner_filter_likelihood_is_unbiased(fk_name):
    """Every row at one θ: the mean of exp(logLt - exact) over 2000 rows is
    1 (the estimate is unbiased) within 4 standard errors; the auxiliary
    filters through the batched auxiliary branch."""
    lg = kalman.LinearGauss(rho=0.8, sigmaX=1.0, sigmaY=0.5)
    x, y = lg.simulate(torch.Generator().manual_seed(3), 25)
    exact = float(kalman.Kalman(ssm=lg, data=y.double()).logLt)
    B = 2000
    theta = {"rho": torch.full((B,), 0.8)}

    class LG(kalman.LinearGauss):
        default_params = {"sigmaY": 0.5, "rho": 0.9, "sigmaX": 1.0,
                          "sigma0": None}

    pf = inner_pf.InnerPF(getattr(ssms, fk_name), LG, y, theta, 100)
    ll = pf.loglik(torch.Generator().manual_seed(4), 25).double()
    r = torch.exp(ll - exact)
    se = float(r.std()) / B ** 0.5
    assert abs(float(r.mean()) - 1.0) < 4 * se + 1e-3, (float(r.mean()), se)


@pytest.mark.parametrize("scheme", ["residual", "ssp"])
def test_row_loop_schemes_run_every_row(scheme):
    y = _sv_data()
    pf = _port_pf("Bootstrap", scheme, y)
    gen = torch.Generator().manual_seed(1)
    xs, lws, ll = pf.replay(gen, len(y))
    assert xs.shape == (3, NX) and lws.shape == (3, NX)
    assert torch.isfinite(ll).all()


def test_model_whose_laws_do_not_broadcast_raises():
    class Scalar(ssms.StochVol):
        def PX0(self):
            return dists.Normal(loc=float(self.mu), scale=1.0)

    with pytest.raises(ValueError, match="Scalar"):
        inner_pf.InnerPF(ssms.Bootstrap, Scalar, torch.zeros(5),
                         {k: torch.from_numpy(v)
                          for k, v in SV_THETA.items()}, 8).init(
            torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# SMC² itself
# ---------------------------------------------------------------------------

class LGfixed(kalman.LinearGauss):
    default_params = {"sigmaY": 0.5, "rho": 0.9, "sigmaX": 1.0,
                      "sigma0": None}


RHO_PRIOR = dists.StructDist({"rho": dists.Uniform(a=-0.99, b=0.99)})


def _lg_y(T, seed=0):
    true = kalman.LinearGauss(rho=0.8, sigmaX=1.0, sigmaY=0.5)
    return true.simulate(torch.Generator().manual_seed(seed), T)[1]


@pytest.fixture(scope="module")
def smc2_setup():
    """T = 12, the Kalman grid evidence and posterior mean of rho (the JAX
    test's oracle, computed with the port's Kalman filter)."""
    y = _lg_y(12)
    grid = np.linspace(-0.985, 0.985, 80)
    lls = np.array([float(kalman.Kalman(ssm=LGfixed(rho=float(r)),
                                        data=y.double()).logLt)
                    for r in grid])
    exact_ev = logsumexp(lls) + np.log((grid[1] - grid[0]) / (2 * 0.99))
    post = np.exp(lls - lls.max())
    post /= post.sum()
    return y, exact_ev, float(np.sum(post * grid))


def test_evidence_and_posterior_match_kalman(smc2_setup):
    """As ``tests/test_smc_samplers.py::TestSMC2``: 4 seeds, Ntheta = Nx =
    150, len_chain = 4; |mean logLt - exact| < 0.4, posterior mean within
    0.25."""
    y, exact_ev, exact_pmean = smc2_setup
    lls, means = [], []
    for s in range(4):
        fk = ssp.SMC2(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, init_Nx=150,
                      len_chain=4)
        pf = SMC(fk=fk, N=150, seed=s)
        pf.run()
        lls.append(float(pf.logLt))
        means.append(float((pf.wgts.W * pf.X.theta["rho"]).sum()))
        assert pf.X.xs.shape == (150, 150)
    assert abs(np.mean(lls) - exact_ev) < 0.4, (np.mean(lls), exact_ev)
    assert abs(np.mean(means) - exact_pmean) < 0.25


def test_wastefree_smc2(smc2_setup):
    """Waste-free SMC²: N0 = M·P θ-particles, the inner filters' rows
    carried through the move's (P, M, ...) buffers."""
    y, exact_ev, _ = smc2_setup
    fk = ssp.SMC2(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, init_Nx=100,
                  wastefree=True, len_chain=5)
    pf = SMC(fk=fk, N=40, seed=3)
    pf.run()
    assert pf.X.N == 200 and pf.X.xs.shape == (200, 100)
    assert pf.X.lws.shape == (200, 100)
    assert abs(float(pf.logLt) - exact_ev) < 1.0


def test_exchange_updates_logLt_by_weighted_delta():
    """``tests/test_smc_samplers.py::TestSMC2ExchangeAccounting``: a replay
    that pretends each new filter's loglik is the old one + 0.3."""
    y = _lg_y(8)
    known_delta = 0.3

    class FixedDeltaSMC2(ssp.SMC2):
        def _replay_all(self, gen, x, t, new_Nx):
            xs = torch.zeros(x.xs.shape[:1] + (new_Nx,) + x.xs.shape[2:])
            lws = torch.zeros(x.lws.shape[:1] + (new_Nx,))
            return xs, lws, x.loglik + known_delta

    fk = FixedDeltaSMC2(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, init_Nx=16,
                        len_chain=3, ar_to_increase_Nx=2.0)
    pf = SMC(fk=fk, N=32, seed=5)
    next(pf)
    while not pf.rs_flag:
        next(pf)
    logLt_before = float(pf._carry.logLt)
    lw_before = _np(pf._carry.lw).astype(np.float64)
    W = np.exp(lw_before - lw_before.max())
    W /= W.sum()
    expected_corr = np.log(np.sum(W * np.exp(known_delta)))
    fk.maybe_exchange(pf)
    assert pf.X.xs.shape[1] == 32 and fk.exchanges == [(pf.t, 32)]
    got_corr = float(pf._carry.logLt) - logLt_before
    assert abs(got_corr - expected_corr) < 1e-4
    lw_new = lw_before + known_delta
    lme_new = np.log(np.mean(np.exp(lw_new - lw_new.max()))) + lw_new.max()
    assert abs(float(pf._carry.log_mean_w) - lme_new) < 1e-4
    assert abs(got_corr - known_delta) < 1e-4


def test_exchange_runs_in_a_whole_run(smc2_setup):
    """ar_to_increase_Nx above every acceptance rate: Nx doubles after each
    resample-move, the run stays finite."""
    y, exact_ev, _ = smc2_setup
    fk = ssp.SMC2(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, init_Nx=20,
                  len_chain=3, ar_to_increase_Nx=1.5)
    pf = SMC(fk=fk, N=100, seed=2)
    pf.run()
    n_rs = int(pf.summaries.rs_flags[1:-1].sum())
    assert len(fk.exchanges) == n_rs > 0
    assert pf.X.xs.shape[1] == 20 * 2 ** n_rs
    assert abs(float(pf.logLt) - exact_ev) < 1.0


def test_move_target_replays_with_fresh_draws():
    """Every chain step replays the proposed θ's filters with draws of its
    own: the Metropolis step passes the target a generator (its draws),
    two replays from one stream differ, and the same seed replays the
    same."""
    y = _lg_y(8)
    fk = ssp.SMC2(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, init_Nx=16,
                  len_chain=3)
    gen = torch.Generator().manual_seed(0)
    x = fk.M0(gen, 20)
    target = fk.move_target(5, x)
    d = fk.move.mcmc.draws(gen, x, target)
    assert len(d) == 3 and d[2] is gen
    a, b = target(x, gen), target(x, gen)
    assert not torch.equal(a.loglik, b.loglik)
    c = target(x, torch.Generator().manual_seed(9))
    e = target(x, torch.Generator().manual_seed(9))
    assert torch.equal(c.loglik, e.loglik) and torch.equal(c.xs, e.xs)
    with pytest.raises(ValueError, match="generator"):
        target(x)


def test_smc_options_and_fk_cls_raise():
    y = _lg_y(8)
    with pytest.raises(ValueError, match="smc_options"):
        ssp.SMC2(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y,
                 smc_options={"qmc": True})
    with pytest.raises(ValueError, match="resampling"):
        ssp.SMC2(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y,
                 smc_options={"resampling": "killing"})
    for aux in (ssms.AuxiliaryPF, ssms.AuxiliaryBootstrap):
        with pytest.raises(ValueError, match="auxiliary"):
            ssp.SMC2(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, fk_cls=aux)
    fk = ssp.SMC2(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y,
                  smc_options={"resampling": "stratified", "ESSrmin": 0.3})
    assert (fk.inner_resampling, fk.inner_ESSrmin) == ("stratified", 0.3)


def test_smc2_steps_one_inner_step_a_step():
    """At t = 0 the potential is the stored increment (no inner step); each
    later step adds one inner increment to loglik and lpost."""
    y = _lg_y(8)
    fk = ssp.SMC2(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, init_Nx=16,
                  len_chain=3)
    gen = torch.Generator().manual_seed(0)
    x = fk.M0(gen, 10)
    G, x0 = fk.logG_and_update(0, x, gen)
    assert torch.equal(G, x.loglik) and x0 is x
    G1, x1 = fk.logG_and_update(1, x, gen)
    assert torch.allclose(x1.loglik, x.loglik + G1)
    assert torch.allclose(x1.lpost, x.lpost + G1)
    lp = RHO_PRIOR.logpdf(x.theta)
    assert torch.allclose(x.lpost, lp + x.loglik)
