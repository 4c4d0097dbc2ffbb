"""The port's nested sampling (``particles_tpu_torch.nested``) against the
JAX package and the exact evidence of a conjugate Gaussian model.

Deterministic pieces get the same numpy inputs and the same draws in both
packages: the NS-SMC level, evidence and potentials (finite, -inf and
stopping levels; 1e-5), ``done``, one whole NS-SMC sampler step, and
K = 20 vanilla contractions on the JAX package's draws (the offset of the
starting point, the random walk's normals and uniforms; 1e-5), and
``MeanCovTracker``.  Whole port runs are held to the exact evidence at the
JAX tests' tolerances (``tests/test_nested.py``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import particles_tpu.distributions as jd
import particles_tpu.nested as jnested
import particles_tpu.smc_samplers as jssp
from particles_tpu_torch import convert, core, nested
from particles_tpu_torch import distributions as dists
from particles_tpu_torch import smc_samplers as ssp
from particles_tpu_torch.core import SMC

RTOL = 1e-5
T_NS = 10


class GaussianMean(ssp.StaticModel):
    def logpyt(self, theta, t):
        return dists.Normal(loc=theta["mu"], scale=1.0).logpdf(self.data[t])


class JGaussianMean(jssp.StaticModel):
    def logpyt(self, theta, t):
        return jd.Normal(loc=theta["mu"], scale=1.0).logpdf(self.data[t])


class Linear2(ssp.StaticModel):
    """y_t ~ N(a + b x_t, 1), (a, b) ~ N(0, I): a two-column theta."""

    def logpyt(self, theta, t):
        mu = theta["ab"][:, 0] + theta["ab"][:, 1] * self.data[t, 0]
        return dists.Normal(loc=mu).logpdf(self.data[t, 1])


class JLinear2(jssp.StaticModel):
    def logpyt(self, theta, t):
        mu = theta["ab"][:, 0] + theta["ab"][:, 1] * self.data[t, 0]
        return jd.Normal(loc=mu).logpdf(self.data[t, 1])


@pytest.fixture(scope="module")
def conj():
    """tests/test_nested.py's model: both packages' and the exact
    log-evidence."""
    y = np.random.default_rng(3).normal(loc=0.8, size=T_NS).astype(
        np.float32)
    jmodel = JGaussianMean(data=y, prior=jd.StructDist(
        {"mu": jd.Normal(loc=0.0, scale=1.0)}))
    model = GaussianMean(data=y, prior=dists.StructDist(
        {"mu": dists.Normal(0.0, 1.0)}), device="cpu")
    exact = st.multivariate_normal(
        np.zeros(T_NS), np.eye(T_NS) + np.ones((T_NS, T_NS))).logpdf(y)
    return jmodel, model, exact


def _linear2_pair(T=12):
    rng = np.random.default_rng(5)
    x = rng.normal(size=T)
    data = np.stack([x, 0.5 - 0.8 * x + rng.normal(size=T)], 1).astype(
        np.float32)
    return (JLinear2(data=data, prior=jd.StructDist(
        {"ab": jd.IID(jd.Normal(), 2)})),
            Linear2(data=data, prior=dists.StructDist(
                {"ab": dists.IID(dists.Normal(), 2)}), device="cpu"))


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else \
        np.asarray(v)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def test_unif_minus_one_is_never_m_and_uniform():
    gen = torch.Generator().manual_seed(0)
    N, draws = 7, 7000
    for m in (0, 3, 6, torch.tensor(4)):
        out = torch.stack([nested.unif_minus_one(gen, N, m)
                           for _ in range(draws // 7)])
        assert int((out == m).sum()) == 0
        assert int(out.min()) >= 0 and int(out.max()) < N
    # chi-square on many draws at once (the chunk's form)
    r = torch.randint(0, N - 1, (draws,), generator=gen)
    m = torch.randint(0, N, (draws,), generator=gen)
    out = (m + 1 + r) % N
    assert not bool((out == m).any())
    for k in range(N):
        counts = np.bincount(_np(out[m == k]), minlength=N)
        assert counts[k] == 0
        others = np.delete(counts, k)
        assert st.chisquare(others).pvalue > 1e-3


def test_mean_cov_tracker_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(30, 3)).astype(np.float32)
    extra = rng.normal(size=3).astype(np.float32)
    jt = jnested.MeanCovTracker(jnp.asarray(x))
    tt = nested.MeanCovTracker(torch.from_numpy(x))
    for op, v in (("remove_point", x[4]), ("add_point", extra)):
        getattr(jt, op)(jnp.asarray(v))
        getattr(tt, op)(torch.from_numpy(v))
        assert tt.N == jt.N
        for k in ("mean", "cov", "L"):
            np.testing.assert_allclose(_np(getattr(tt, k)),
                                       np.asarray(getattr(jt, k)),
                                       rtol=RTOL, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(_np(tt.cov), np.cov(
        np.vstack([np.delete(x, 4, 0), extra]).T, bias=True), atol=1e-5)


def test_nested_particles_container():
    th = {"mu": torch.arange(4.0)}
    x = nested.NestedParticles(theta=th, lprior=torch.zeros(4),
                               llik=torch.ones(4), shared={"s": 1})
    assert x.N == 4 and x.shared == {"s": 1}
    assert torch.equal(x.llik, torch.ones(4))
    sub = x.subset(torch.tensor([3, 0]))
    assert torch.equal(sub.theta["mu"], torch.tensor([3.0, 0.0]))


@pytest.mark.parametrize("n", [10, 2 ** 10 + 3])
def test_level_quantile_matches_jnp_percentile(n):
    rng = np.random.default_rng(n)
    v = (rng.normal(size=n) * 5).astype(np.float32)
    v[rng.choice(n, n // 2, replace=False)] = -np.inf
    for ESSrmin in (0.1, 0.3, 0.5):
        q = 100.0 * (1.0 - ESSrmin)
        want = float(jnp.percentile(jnp.asarray(v), q))
        got = float(nested._quantile(torch.from_numpy(v),
                                     np.float32(q) / np.float32(100.0)))
        if np.isinf(want):
            assert got == want
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL)


# ---------------------------------------------------------------------------
# NS-SMC: the level, done, one sampler step
# ---------------------------------------------------------------------------

def _llik_case(kind, N0=200):
    rng = np.random.default_rng(7)
    llik = (rng.normal(size=N0) * 3 - 10).astype(np.float32)
    if kind == "-inf level":
        llik[:150] = -np.inf
    if kind == "stopping":
        llik[:] = -10.0 + 1e-3 * rng.normal(size=N0).astype(np.float32)
    return llik


@pytest.mark.parametrize("kind", ["finite", "-inf level", "stopping"])
def test_logG_and_update_matches_jax(kind):
    llik = _llik_case(kind)
    N0 = llik.shape[0]
    evid = {"finite": -8.5, "-inf level": -np.inf, "stopping": 0.0}[kind]
    t = 3
    jfk = jnested.NestedSamplingSMC(ESSrmin=0.3)
    fk = nested.NestedSamplingSMC(ESSrmin=0.3)
    shared = {"lt": np.float32(-2.0), "log_evid": np.float32(evid)}
    jx = jssp.ThetaParticles(theta={"mu": jnp.zeros(N0)},
                             llik=jnp.asarray(llik),
                             shared={k: jnp.asarray(v)
                                     for k, v in shared.items()})
    tx = convert.theta_particles_from_numpy(
        {"mu": np.zeros(N0, np.float32)}, {"llik": llik}, shared,
        device="cpu")
    jlw, jout = jax.jit(lambda x: jfk.logG_and_update(jnp.int32(t), x))(jx)
    lw, out = fk.logG_and_update(t, tx)
    lt, jlt = float(out.shared["lt"]), float(jout.shared["lt"])
    if kind == "stopping":
        assert lt == jlt == np.inf
    elif kind == "-inf level":
        assert lt == jlt == -np.inf
    else:
        np.testing.assert_allclose(lt, jlt, rtol=RTOL)
    np.testing.assert_allclose(float(out.shared["log_evid"]),
                               float(jout.shared["log_evid"]), rtol=RTOL)
    np.testing.assert_array_equal(np.isinf(lw.numpy()),
                                  np.isinf(np.asarray(jlw)))
    np.testing.assert_allclose(lw.numpy(), np.asarray(jlw), rtol=RTOL)


def test_done_reads_only_an_inf_level():
    """tests/test_nested.py's cases: only lt == +inf ends the run."""
    fk = nested.NestedSamplingSMC()

    def view(lt):
        return types.SimpleNamespace(X=types.SimpleNamespace(
            shared={"lt": torch.tensor(lt, dtype=torch.float32)}))

    assert fk.done(view(np.inf)) is True
    assert fk.done(view(-np.inf)) is False
    assert fk.done(view(1.5)) is False
    assert fk.done(types.SimpleNamespace(X=None)) is False


def _jax_step_draws(key, M, d):
    """The normals and uniforms of one JAX ArrayRandomWalk step."""
    k1, k2, _ = jax.random.split(key, 3)
    return (torch.from_numpy(np.array(jax.random.normal(k1, (M, d)))),
            torch.from_numpy(np.array(jax.random.uniform(k2, (M,)))))


@pytest.fixture(scope="module")
def ns_smc_pair(conj):
    """Both packages' NS-SMC at N = 16, P = 3, the JAX step jitted once."""
    jmodel, model, _ = conj
    N, P = 16, 3
    jfk = jnested.NestedSamplingSMC(model=jmodel, len_chain=P, ESSrmin=0.3)
    fk = nested.NestedSamplingSMC(model=model, len_chain=P, ESSrmin=0.3)
    jcarry = jax.jit(lambda k: jssp._sampler_step0(jfk, k, N))(
        jax.random.key(2))
    jstep = jax.jit(lambda c, t: jssp._sampler_step(jfk, c, t, N,
                                                    "systematic", 0.5))
    return fk, jcarry, jstep, N, P


@pytest.mark.parametrize("t", [1, 2])
def test_ns_smc_sampler_step_matches_jax(ns_smc_pair, t):
    """One whole NS-SMC step (calibrate, resample by the systematic z-form,
    two random-walk chain steps under the level, the new level) from one
    JAX state, on the JAX package's draws: at t = 1 from the first level,
    at t = 2 from a state whose level is -inf."""
    fk, jcarry, jstep, N, P = ns_smc_pair
    X = jcarry.X
    if t == 2:
        X = X.with_shared(lt=jnp.float32(-jnp.inf))
        jcarry = jcarry._replace(X=X)
    fields = {k: np.asarray(v) for k, v in X._particle_fields().items()
              if k != "theta"}
    tX = convert.theta_particles_from_numpy(
        {"mu": np.asarray(X.theta["mu"])}, fields,
        {k: np.asarray(v) for k, v in X.shared.items()}, device="cpu")
    carry = core._Carry(X=tX, lw=torch.tensor(np.asarray(jcarry.lw)),
                        logLt=torch.tensor(float(jcarry.logLt)),
                        log_mean_w=torch.tensor(float(jcarry.log_mean_w)))
    jnew, _ = jstep(jcarry, jnp.int32(t))
    _, k_rs, k_mv = jax.random.split(jcarry.key, 3)
    draws = {"rs_u": torch.tensor(float(jax.random.uniform(k_rs, ()))),
             "move": [_jax_step_draws(k, N, 1)
                      for k in jax.random.split(k_mv, P - 1)]}
    new, view = ssp._sampler_step(fk, None, carry, t, N, "systematic", 0.5,
                                  draws=draws)
    assert view.rs_flag and new.X.N == jnew.X.N == N * P
    np.testing.assert_allclose(new.X.theta["mu"].numpy(),
                               np.asarray(jnew.X.theta["mu"]), rtol=RTOL,
                               atol=1e-6)
    for k in fields:
        np.testing.assert_allclose(_np(getattr(new.X, k)),
                                   np.asarray(getattr(jnew.X, k)),
                                   rtol=RTOL, atol=1e-4, err_msg=k)
    for k in ("lt", "log_evid", "acc_rate", "chol_cov"):
        np.testing.assert_allclose(_np(new.X.shared[k]),
                                   np.asarray(jnew.X.shared[k]), rtol=RTOL,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(np.isinf(new.lw.numpy()),
                                  np.isinf(np.asarray(jnew.lw)))


# ---------------------------------------------------------------------------
# vanilla NS: K contractions on the JAX package's draws
# ---------------------------------------------------------------------------

@jax.jit
def _jax_contraction_draws(key, span):
    """One JAX contraction's draws, and the key it leaves: the offset r of
    ``unif_minus_one`` (``randint(..., m + 1, m + N)``'s offset depends
    only on the key and the span N - 1) and the random walk's normals and
    uniforms (its ``nsteps`` is the length of ``span``'s second axis)."""
    key, k = jax.random.split(key)
    r = jax.random.randint(jax.random.fold_in(k, 1), (), 0, span.shape[0])

    def step(k, _):
        k, k1, k2 = jax.random.split(k, 3)
        return k, (jax.random.normal(k1, (span.shape[2],)),
                   jax.random.uniform(k2, ()))

    _, (z, u) = jax.lax.scan(step, k, None, length=span.shape[1])
    return key, r, z, u


def _jax_chunk_draws(key, K, N, nsteps, d):
    """The JAX ``_chunk``'s draws for K contractions."""
    span = jnp.zeros((N - 1, nsteps, d))
    r, z, u = [], [], []
    for _ in range(K):
        key, rr, zz, uu = _jax_contraction_draws(key, span)
        r.append(int(rr))
        z.append(np.asarray(zz))
        u.append(np.asarray(uu))
    return (torch.tensor(r), torch.from_numpy(np.array(z, np.float32)),
            torch.from_numpy(np.array(u, np.float32)))


@pytest.mark.parametrize("model_name", ["conjugate", "two columns"])
def test_vanilla_chunk_matches_jax(conj, model_name):
    if model_name == "conjugate":
        jmodel, model, _ = conj
    else:
        jmodel, model = _linear2_pair()
    N, K, nsteps = 30, 20, 3
    jns = jnested.Nested_RWmoves(model=jmodel, N=N, nsteps=nsteps,
                                 key=jax.random.key(0))
    jns.setup()
    ns = nested.Nested_RWmoves(model=model, N=N, nsteps=nsteps,
                               device="cpu")
    arr, lprior, llik, lZ = convert.nested_state_from_numpy(
        np.asarray(jns.arr), np.asarray(jns.lprior), np.asarray(jns.llik),
        np.float32(-3.0), device="cpu")
    ns.template = {k: torch.from_numpy(np.array(v))
                   for k, v in jns.template.items()}
    key = jax.random.key(1)
    i0 = 7
    out = jax.jit(jns._chunk, static_argnames=("K",))(
        key, jns.arr, jns.lprior, jns.llik, jnp.float32(-3.0),
        jnp.int32(i0), K=K)
    jarr, jlprior, jllik, jlZ, jpll, jpth, jlZs = map(np.asarray, out)
    draws = _jax_chunk_draws(key, K, N, nsteps, arr.shape[1])
    lZ, pll, pth, lZs = ns._chunk(arr, lprior, llik, lZ, i0, K, draws)
    # some mutations moved, some steps were refused
    assert 0 < int((arr.numpy() != np.asarray(jns.arr)).any(1).sum())
    for got, want, name in ((arr, jarr, "arr"), (lprior, jlprior, "lprior"),
                            (llik, jllik, "llik"), (lZ, jlZ, "lZ"),
                            (pll, jpll, "points llik"),
                            (pth, jpth, "points theta"), (lZs, jlZs, "lZs")):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# whole runs against the exact evidence (tests/test_nested.py)
# ---------------------------------------------------------------------------

def test_vanilla_ns_evidence(conj):
    _, model, exact = conj
    ns = nested.Nested_RWmoves(model=model, N=100, nsteps=5, eps=1e-6,
                               seed=0)
    ns.run()
    assert abs(ns.lZhats[-1] - exact) < 0.8, (ns.lZhats[-1], exact)
    assert all(np.diff(ns.lZhats) >= -1e-6)
    n = len(ns.lZhats)
    assert n % 50 == 0 and len(ns.log_weights) == n
    assert ns.points["llik"].shape == (n,)
    assert ns.points["theta"].shape == (n, 1)
    assert bool((ns.points["llik"][1:] >= ns.points["llik"][:-1]).all())
    np.testing.assert_allclose(
        ns.log_weights[:2], np.log(1 - np.exp(-1 / 100)) - np.arange(2) / 100)


def test_ns_smc_evidence(conj):
    _, model, exact = conj
    ests = []
    for s in range(5):
        pf = SMC(fk=nested.NestedSamplingSMC(model=model, len_chain=5,
                                             ESSrmin=0.3, eps=0.01),
                 N=100, seed=s)
        pf.run()
        assert float(pf.X.shared["lt"]) == np.inf and pf.t < 1000
        ests.append(float(pf.X.shared["log_evid"]))
    assert abs(np.mean(ests) - exact) < 0.4, (np.mean(ests), exact)


def test_generator_follows_the_model(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class NoData(ssp.StaticModel):
        pass

    with pytest.raises(RuntimeError, match='device="cpu"'):
        nested.Nested_RWmoves(model=NoData(prior=None), N=10)
    with pytest.raises(ValueError, match="N >= 2"):
        nested.Nested_RWmoves(model=NoData(prior=None), N=1, device="cpu")
