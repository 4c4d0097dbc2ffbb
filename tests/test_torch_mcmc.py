"""The port's MCMC and particle MCMC (``particles_tpu_torch.mcmc``) against
the JAX package (``particles_tpu.mcmc``) and exact oracles.

Deterministic pieces get the same numpy inputs and the same draws in both
packages: the covariance tracker on one sequence of vectors (a failed
Cholesky among them), the vector packing, a 20-iteration adaptive
random-walk chain on the normals and uniforms the JAX chain splits from
its keys, and one conditional SMC step on the JAX step's ancestors and
normals (all within 1e-5).  Whole chains are held, as
``tests/test_mcmc.py`` holds the JAX package's, to the Kalman grid
posterior and the conjugate posterior, at that file's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particles_tpu.distributions as jd
import particles_tpu.kalman as jkalman
import particles_tpu.mcmc as jmcmc
import particles_tpu.resampling as jrs
import particles_tpu.smc_samplers as jssp
import particles_tpu.state_space_models as jssms
from particles_tpu_torch import core, kalman, mcmc
from particles_tpu_torch import distributions as dists
from particles_tpu_torch import smc_samplers as ssp
from particles_tpu_torch import state_space_models as ssms

TOL = 1e-5


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


class GaussianMean(ssp.StaticModel):
    def logpyt(self, theta, t):
        return dists.Normal(loc=theta["mu"], scale=1.0).logpdf(self.data[t])


class TwoParam(ssp.StaticModel):
    def logpyt(self, theta, t):
        return dists.Normal(loc=theta["mu"],
                            scale=theta["sigma"]).logpdf(self.data[t])


class JTwoParam(jssp.StaticModel):
    def logpyt(self, theta, t):
        return jd.Normal(loc=theta["mu"],
                         scale=theta["sigma"]).logpdf(self.data[t])


def _gm_model(seed, T):
    y = np.random.default_rng(seed).normal(loc=1.0, size=T).astype(
        np.float32)
    prior = dists.StructDist({"mu": dists.Normal(loc=0.0, scale=1.0)})
    return GaussianMean(data=y, prior=prior, device="cpu"), y


def _two_param(y):
    prior = dists.StructDist({"mu": dists.Normal(loc=0.0, scale=1.0),
                              "sigma": dists.Gamma(a=2.0, b=2.0)})
    jprior = jd.StructDist({"mu": jd.Normal(loc=0.0, scale=1.0),
                            "sigma": jd.Gamma(a=2.0, b=2.0)})
    return (TwoParam(data=y, prior=prior, device="cpu"),
            JTwoParam(data=y, prior=jprior))


# ---------------------------------------------------------------------------
# the tracker, the packing and the chain, on the same inputs
# ---------------------------------------------------------------------------

def test_vanish_cov_tracker_matches_jax():
    """Ten updates in dimension 2, the sixth a NaN vector (its Cholesky
    fails, so L falls back to L0 from there on), each state within 1e-5."""
    rng = np.random.default_rng(0)
    vs = rng.normal(size=(10, 2)).astype(np.float32)
    vs[5] = np.nan
    Sigma0 = np.array([[2.0, 0.3], [0.3, 0.5]], np.float32)
    jt = jmcmc.VanishCovTracker(dim=2, Sigma0=Sigma0)
    tt = mcmc.VanishCovTracker(dim=2, Sigma0=Sigma0, device="cpu")
    js, ts = jt.init_state(), tt.init_state()
    for i, v in enumerate(vs):
        js = jt.update(js, jnp.asarray(v))
        ts = tt.update(ts, torch.from_numpy(v))
        assert ts.t == int(js.t)
        for name in ("mu", "Sigma", "L"):
            np.testing.assert_allclose(
                _np(getattr(ts, name)), np.asarray(getattr(js, name)),
                rtol=TOL, atol=TOL, err_msg=f"update {i} {name}")
    np.testing.assert_allclose(_np(ts.L), np.linalg.cholesky(Sigma0),
                               rtol=TOL, atol=TOL)


def test_vanish_cov_tracker_batches_chains():
    """A (3, dim) batch updates as three trackers would, one failing."""
    rng = np.random.default_rng(1)
    vs = rng.normal(size=(6, 3, 2)).astype(np.float32)
    vs[2, 1] = np.inf
    tt = mcmc.VanishCovTracker(dim=2, device="cpu")
    batch = tt.init_state((3,))
    singles = [tt.init_state() for _ in range(3)]
    for v in vs:
        batch = tt.update(batch, torch.from_numpy(v))
        singles = [tt.update(s, torch.from_numpy(v[c]))
                   for c, s in enumerate(singles)]
    for c in range(3):
        torch.testing.assert_close(batch.L[c], singles[c].L)
    assert torch.equal(batch.L[1], tt.L0)


def test_vector_packing_matches_jax():
    """Pack and unpack in the template's order, with a vector field."""
    tmpl = {"b": np.zeros(3, np.float32), "a": np.float32(0.0)}
    th = {"a": np.float32(1.5), "b": np.array([2.0, 3.0, 4.0], np.float32)}
    jt = {k: jnp.asarray(v) for k, v in tmpl.items()}
    tt = {k: torch.as_tensor(v) for k, v in tmpl.items()}
    jv = jmcmc._dict_to_vec({k: jnp.asarray(th[k]) for k in tmpl})
    tv = mcmc._dict_to_vec({k: torch.as_tensor(th[k]) for k in tmpl})
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    jd_ = jmcmc._vec_to_dict(jv, jt)
    td = mcmc._vec_to_dict(tv, tt)
    assert list(td) == list(jd_) == ["b", "a"]
    for k in td:
        np.testing.assert_array_equal(_np(td[k]), np.asarray(jd_[k]))
    # a batch unpacks at once, and packs back in template order
    batch = torch.stack([tv, 2 * tv])
    tb = mcmc._vec_to_dict(batch, tt)
    assert tb["b"].shape == (2, 3) and tb["a"].shape == (2,)
    torch.testing.assert_close(mcmc._dicts_to_vecs(
        {"a": tb["a"], "b": tb["b"]}, tt), batch)


def _jax_rwhm_draws(key, niter, dim):
    """The normals and uniforms of a JAX single-chain ``GenericRWHM.run``
    (one segment): its key splits as in ``__init__`` and ``run``."""
    _, key = jax.random.split(key)
    _, _, kchain = jax.random.split(key, 3)
    _, kc = jax.random.split(kchain)
    z, u = [], []
    for k in jax.random.split(kc, niter - 1):
        k1, k2, _ = jax.random.split(k, 3)
        z.append(np.asarray(jax.random.normal(k1, (dim,))))
        u.append(np.asarray(jax.random.uniform(k2, ())))
    return torch.from_numpy(np.stack(z)), torch.from_numpy(np.stack(u))


@pytest.mark.parametrize("adaptive", [True, False])
def test_basic_rwhm_chain_matches_jax_on_its_draws(adaptive):
    """20 iterations of the two-parameter chain, θ and lpost within 1e-5
    of the JAX chain's, on its draws."""
    y = np.random.default_rng(3).normal(size=8).astype(np.float32)
    model, jmodel = _two_param(y)
    theta0 = {"sigma": 1.2, "mu": 0.3}
    kw = dict(niter=20, adaptive=adaptive, theta0=theta0)
    if not adaptive:
        kw["rw_cov"] = 0.2 * np.eye(2)
    jm = jmcmc.BasicRWHM(model=jmodel, key=jax.random.key(3), **kw)
    jm.run()
    m = mcmc.BasicRWHM(model=model, **kw)
    m.run(draws=_jax_rwhm_draws(jax.random.key(3), 20, 2))
    for k in ("mu", "sigma"):
        np.testing.assert_allclose(_np(m.chain.theta[k]),
                                   np.asarray(jm.chain.theta[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    np.testing.assert_allclose(_np(m.chain.lpost), np.asarray(jm.chain.lpost),
                               rtol=TOL, atol=TOL)
    assert m.nacc == int(jm.nacc) and 0 < m.nacc < 19


def test_theta0_packs_in_template_order():
    y = np.random.default_rng(3).normal(size=8).astype(np.float32)
    model, _ = _two_param(y)
    m = mcmc.BasicRWHM(model=model, niter=3, adaptive=False,
                       theta0={"sigma": 0.25, "mu": 3.0})
    m.run()
    assert abs(float(m.chain.theta["mu"][0]) - 3.0) < 1e-6
    assert abs(float(m.chain.theta["sigma"][0]) - 0.25) < 1e-6
    with pytest.raises(ValueError, match="theta0 keys"):
        mcmc.BasicRWHM(model=model, niter=3, theta0={"mu": 1.0}).run()


def test_multichain_theta0_broadcast_and_per_chain():
    model, _ = _gm_model(4, 10)
    m = mcmc.BasicRWHM(model=model, niter=50, nchains=3, theta0={"mu": 0.3},
                       seed=6)
    m.run()
    assert m.chain.theta["mu"].shape == (50, 3)
    assert m.chain.lpost.shape == (50, 3)
    np.testing.assert_allclose(_np(m.chain.theta["mu"][0]), 0.3, atol=1e-6)
    m2 = mcmc.BasicRWHM(model=model, niter=50, nchains=3, seed=7,
                        theta0={"mu": np.array([0.1, 0.2, 0.3], np.float32)})
    m2.run()
    np.testing.assert_allclose(_np(m2.chain.theta["mu"][0]), [0.1, 0.2, 0.3],
                               atol=1e-6)
    assert m2.acc_rate.shape == (3,) and m2.nacc.shape == (3,)
    with pytest.raises(ValueError, match="theta0"):
        mcmc.BasicRWHM(model=model, niter=50, nchains=3, seed=8,
                       theta0={"mu": np.zeros(2, np.float32)}).run()


def test_multichain_conjugate_posterior_and_diagnostics():
    """``tests/test_mcmc.py::TestMultiChain``: 4 chains of 2000 on the
    conjugate mean: pooled mean within 0.05, variance within 0.02, each
    chain's acceptance rate in (0.05, 0.9), split-Rhat below 1.05."""
    T = 25
    model, y = _gm_model(3, T)
    m = mcmc.BasicRWHM(model=model, niter=2000, nchains=4, seed=5)
    m.run()
    chain = _np(m.chain.theta["mu"])
    post_var = 1.0 / (1.0 + T)
    post_mean = post_var * y.astype(np.float64).sum()
    pooled = chain[500:].ravel()
    assert abs(pooled.mean() - post_mean) < 0.05
    assert abs(pooled.var() - post_var) < 0.02
    assert ((m.acc_rate > 0.05) & (m.acc_rate < 0.9)).all()
    assert np.std(chain[-1]) > 0
    d = m.diagnostics(discard_frac=0.2)
    assert d["mu"]["rhat"] < 1.05 and 50 < d["mu"]["ess"] <= 8000
    assert float(m.mean_sq_jump_dist()) > 0


def test_mesh_raises_naming_the_roadmap_item():
    """``mesh`` splits the chains over a mesh axis's ranks (held in
    tests/test_torch_distributed.py::test_pmmh_chains_across_ranks); what
    it cannot take raises ValueError: an axis with no mesh, and a given
    generator (each rank makes its own from the seed)."""
    model, _ = _gm_model(4, 10)
    with pytest.raises(ValueError, match="mesh_axis given without a mesh"):
        mcmc.BasicRWHM(model=model, mesh_axis="chains")
    with pytest.raises(ValueError, match="pass seed, not generator"):
        mcmc.BasicRWHM(model=model, mesh=object(),
                       generator=torch.Generator())


# ---------------------------------------------------------------------------
# PMMH
# ---------------------------------------------------------------------------

class LGfixed(kalman.LinearGauss):
    default_params = {"sigmaY": 0.5, "rho": 0.9, "sigmaX": 1.0,
                      "sigma0": None}


RHO_PRIOR = dists.StructDist({"rho": dists.Uniform(a=-0.99, b=0.99)})


@pytest.fixture(scope="module")
def lg_pmmh_setup():
    """T = 25 from the true rho = 0.8, the Kalman grid posterior of rho."""
    true = kalman.LinearGauss(rho=0.8, sigmaX=1.0, sigmaY=0.5)
    _, y = true.simulate(torch.Generator().manual_seed(0), 25)
    grid = np.linspace(-0.985, 0.985, 100)
    lls = np.array([float(kalman.Kalman(ssm=LGfixed(rho=float(r)),
                                        data=y.double()).logLt)
                    for r in grid])
    post = np.exp(lls - lls.max())
    post /= post.sum()
    post_mean = float(np.sum(post * grid))
    post_sd = float(np.sqrt(np.sum(post * grid ** 2) - post_mean ** 2))
    return y, post_mean, post_sd


def test_pmmh_multichain_posterior(lg_pmmh_setup):
    """``tests/test_mcmc.py::TestMultiChain::test_pmmh_multichain`` at 200
    iterations: the pooled mean within 0.15 of the grid posterior mean,
    every chain moves."""
    y, post_mean, post_sd = lg_pmmh_setup
    m = mcmc.PMMH(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, Nx=100,
                  niter=200, nchains=4, seed=9)
    m.run()
    chain = _np(m.chain.theta["rho"])
    assert chain.shape == (200, 4)
    pooled = chain[50:].ravel()
    assert abs(pooled.mean() - post_mean) < 0.15, (pooled.mean(), post_mean)
    assert 0.3 < pooled.std() / post_sd < 3.0
    assert (m.nacc > 10).all()


def test_pmmh_logpost_masks_theta_outside_the_support(lg_pmmh_setup):
    """A θ outside the prior's support (the model gives NaN there) has
    log-posterior -inf, computed without a host branch; the others are
    finite."""
    y, _, _ = lg_pmmh_setup
    m = mcmc.PMMH(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, Nx=50, niter=2)
    lp = m.logpost({"rho": torch.tensor([0.5, 1.5, -2.0, 0.9])})
    assert torch.isfinite(lp[[0, 3]]).all()
    assert (lp[[1, 2]] == -torch.inf).all()


@pytest.mark.parametrize("fk_name", ["GuidedPF", "AuxiliaryBootstrap"])
def test_pmmh_other_inner_filters_run(lg_pmmh_setup, fk_name):
    y, post_mean, _ = lg_pmmh_setup
    m = mcmc.PMMH(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, Nx=50,
                  niter=60, nchains=2, seed=3,
                  fk_cls=getattr(ssms, fk_name))
    m.run()
    assert torch.isfinite(m.chain.lpost).all() and (m.nacc > 0).all()


def test_pmmh_smc_options_and_cls(lg_pmmh_setup):
    """As ``tests/test_mcmc.py::TestPMMHSmcOptions``: qmc through either
    option runs SQMC inner filters; unsupported options raise."""
    y, _, _ = lg_pmmh_setup
    m = mcmc.PMMH(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, Nx=32, niter=5,
                  smc_options={"qmc": True}, seed=2)
    assert m.qmc
    m.run()
    assert torch.isfinite(m.chain.lpost).all()
    m = mcmc.PMMH(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, Nx=32, niter=5,
                  smc_cls=core.SQMC)
    assert m.qmc
    m = mcmc.PMMH(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, Nx=32, niter=5,
                  smc_options={"qmc": True, "ESSrmin": 0.7})
    pf = m.alg_instance({"rho": 0.5}, seed=0)
    assert pf.qmc and pf.ESSrmin == 0.7
    pf.run()
    assert np.isfinite(float(pf.logLt))
    with pytest.raises(ValueError, match="smc_options"):
        mcmc.PMMH(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, Nx=32, niter=5,
                  smc_options={"store_history": True})
    with pytest.raises(ValueError, match="smc_cls"):
        mcmc.PMMH(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, Nx=32, niter=5,
                  smc_cls=dict)


# ---------------------------------------------------------------------------
# conditional SMC and (Particle) Gibbs
# ---------------------------------------------------------------------------

def test_csmc_pins_particle_zero():
    ssm = kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    _, y = ssm.simulate(torch.Generator().manual_seed(5), 15)
    fk = ssms.Bootstrap(ssm=ssm, data=y)
    xstar = torch.linspace(-1.0, 1.0, 15)
    cpf = mcmc.CSMC(fk=fk, N=100, xstar=xstar, seed=6)
    cpf.run()
    assert torch.equal(cpf.hist.X[:, 0], xstar)
    assert (cpf.hist.A[:, 0] == 0).all()
    assert cpf.hist.X.shape == (15, 100) and cpf.hist.lw.shape == (15, 100)
    assert np.isfinite(float(cpf.logLt))
    # a bad xstar does not hold the extracted trajectories
    bad = mcmc.CSMC(fk=fk, N=500, xstar=torch.full((15,), 5.0), seed=8)
    bad.run()
    traj = bad.hist.extract_one_trajectory(torch.Generator().manual_seed(9))
    assert float((traj - y).abs().mean()) < 2.0


@pytest.mark.parametrize("ESSrmin", [0.0, 1.1])
def test_csmc_step_matches_jax_on_its_draws(ESSrmin):
    """``_csmc_run`` over T = 2 (one step) against the port's CSMC step
    fed the JAX run's initial normals, multinomial ancestors and
    transition normals: X, A, lw and logLt within 1e-5 (ESSrmin 0: no
    resampling; 1.1: resampling)."""
    N = 64
    rng = np.random.default_rng(2)
    y = rng.normal(size=2).astype(np.float32)
    xstar = np.array([0.4, -0.3], np.float32)
    jssm = jkalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.5)
    jfk = jssms.Bootstrap(ssm=jssm, data=y)
    key = jax.random.key(4)
    hX, hA, hlw, jlogLt = jax.jit(lambda k: jmcmc._csmc_run(
        jfk, k, N, 2, jnp.asarray(xstar), ESSrmin))(key)
    k0, kloop = jax.random.split(key)
    k_rs, k_m = jax.random.split(jax.random.split(kloop, 1)[0])
    A_res = jax.jit(lambda k, lw: jrs.multinomial(
        k, jrs.Weights(lw).W, N))(k_rs, hlw[0])
    eps = torch.from_numpy(np.array(jax.random.normal(k_m, (N,))))
    fk = ssms.Bootstrap(ssm=kalman.LinearGauss(rho=0.9, sigmaX=1.0,
                                               sigmaY=0.5),
                        data=torch.from_numpy(y))
    X0 = torch.from_numpy(np.array(hX[0]))
    lw0 = fk.logG(0, None, X0)
    np.testing.assert_allclose(_np(lw0), np.asarray(hlw[0]), rtol=TOL,
                               atol=TOL)
    lm0 = core.rs.Weights(lw0).log_mean

    def move(fk, t, xp):
        law = fk.ssm.PX(t, xp)
        return law.loc + law.scale * eps

    X1, lw1, _, loglt, A = mcmc._csmc_step(
        fk, 1, X0, lw0, lm0, torch.from_numpy(xstar[1:2]), ESSrmin,
        torch.from_numpy(np.array(A_res)).long(), move)
    np.testing.assert_array_equal(_np(A), np.asarray(hA[1]))
    np.testing.assert_allclose(_np(X1), np.asarray(hX[1]), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(_np(lw1), np.asarray(hlw[1]), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(lm0 + loglt), float(jlogLt), rtol=TOL,
                               atol=TOL)


def test_gibbs_sweep_updates_states_on_the_fresh_theta():
    """``tests/test_mcmc.py::TestGibbsSweepFreshTheta``."""
    seen = []

    class G(mcmc.GenericGibbs):
        def update_theta(self, gen, theta, x):
            return {"mu": theta["mu"] + 1.0}

        def update_states(self, gen, theta, x):
            seen.append(float(theta["mu"]))
            return torch.zeros(3)

    prior = dists.StructDist({"mu": dists.Normal(loc=0.0, scale=1.0)})
    g = G(prior=prior, data=np.zeros(3, np.float32), niter=4,
          theta0={"mu": torch.tensor(0.0)}, device="cpu")
    g.run()
    assert seen == [0.0, 1.0, 2.0, 3.0]
    assert _np(g.chain.theta["mu"]).tolist() == [0.0, 1.0, 2.0, 3.0]


class PG(mcmc.ParticleGibbs):
    """The conjugate update of rho given the states (sigmaX = 1, a N(0, 1)
    prior), clipped to (-0.99, 0.99), as ``tests/test_mcmc.py``."""

    def update_theta(self, gen, theta, x):
        xp, xc = x[:-1], x[1:]
        prec = (xp * xp).sum() + 1.0
        draw = (xp * xc).sum() / prec + torch.randn((), generator=gen) \
            / prec.sqrt()
        return {"rho": draw.clamp(-0.99, 0.99)}


def _pg(niter, **kw):
    true = kalman.LinearGauss(rho=0.8, sigmaX=1.0, sigmaY=0.5)
    _, y = true.simulate(torch.Generator().manual_seed(1), 30)
    return PG(ssm_cls=LGfixed, prior=RHO_PRIOR, data=y, Nx=100, niter=niter,
              store_x=True, seed=2, **kw)


def test_particle_gibbs_posterior_concentration():
    pg = _pg(80)
    pg.run()
    chain = _np(pg.chain.theta["rho"])[20:]
    assert abs(chain.mean() - 0.8) < 0.25
    assert pg.chain.x.shape == (80, 30)


@pytest.mark.parametrize("kw", [{"backward_step": True},
                                {"regenerate_data": True}])
def test_particle_gibbs_options_run(kw):
    pg = _pg(12, **kw)
    pg.run()
    assert torch.isfinite(pg.chain.theta["rho"]).all()
    assert torch.isfinite(pg.chain.x).all()
