"""The port's binary SMC (``particles_tpu_torch.binary_smc``) against the
JAX package and exact enumeration.

Deterministic pieces get the same numpy inputs in both packages: the
binary words, the bool laws, ``chol_and_friends`` and every likelihood
(the JAX output at rtol 1e-5, a float64 explicit-submatrix computation at
rtol 1e-4), ``complete_enum`` (1e-4), the nested-logistic fit (``edgy``
equal, probabilities and ``logpdf`` within 1e-4) and its draws on the JAX
package's uniforms (equal wherever |u - p| >= 1e-6), one
``BinaryMetropolis`` step and one whole sampler step of a binary
``AdaptiveTempering`` on the JAX package's draws.  Whole port runs are held
to the enumerated posterior of a small design (within 0.1, as
``tests/test_binary_smc.py`` holds the JAX package's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particles_tpu.binary_smc as jbs
import particles_tpu.distributions as jd
import particles_tpu.smc_samplers as jssp
from particles_tpu_torch import binary_smc as bs
from particles_tpu_torch import collectors, convert, core, ops
from particles_tpu_torch import distributions as dists
from particles_tpu_torch import smc_samplers as ssp
from particles_tpu_torch.core import SMC

RTOL = 1e-5


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else \
        np.asarray(v)


def _design(n=40, p=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    beta = np.zeros(p, np.float32)
    beta[[0, 1, 4]] = [1.5, -1.0, 0.8]
    y = (X @ beta + 0.5 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _priors(p, q=0.5):
    return (jd.StructDist({"gamma": jd.IID(jbs.Bernoulli(p=q), p)}),
            dists.StructDist({"gamma": dists.IID(bs.Bernoulli(p=q), p)}))


_MODELS = {
    "BayesianVS": ("BayesianVS", {}),
    "BayesianVS sparse": ("BayesianVS", {"nu": 0.0, "iv2": 0.01}),
    "BIC": ("BIC", {}),
    "BayesianVS_gprior": ("BayesianVS_gprior", {}),
}


def _model_pair(name, p=6, q=0.5):
    cls, kw = _MODELS[name]
    X, y = _design(p=p)
    jprior, prior = _priors(p, q)
    return (getattr(jbs, cls)(data=(X, y), prior=jprior, **kw),
            getattr(bs, cls)(data=(X, y), prior=prior, device="cpu", **kw))


@pytest.fixture(scope="module")
def vs():
    """The toy of tests/test_binary_smc.py: both packages' models and the
    enumerated inclusion probabilities (float64)."""
    jmodel, model = _model_pair("BayesianVS")
    gammas, lp = model.complete_enum()
    post = torch.softmax(lp.double(), 0)
    return jmodel, model, _np(gammas.double().T @ post)


def _gammas(N, p, seed, q=0.5):
    return np.random.default_rng(seed).uniform(size=(N, p)) < q


# ---------------------------------------------------------------------------
# helpers and laws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 3, 5])
def test_all_binary_words_match_jax(p):
    w = bs.all_binary_words(p, "cpu")
    assert w.dtype == torch.bool and w.shape == (2 ** p, p)
    np.testing.assert_array_equal(w.numpy(),
                                  np.asarray(jbs.all_binary_words(p)))


def test_bernoulli_laws_are_bool():
    gen = torch.Generator().manual_seed(0)
    law = dists.IID(bs.Bernoulli(0.3), 4)
    assert law.dtype == "bool" and law._one_law
    x = law.rvs(gen, size=5000)
    assert x.dtype == torch.bool and x.shape == (5000, 4)
    assert abs(float(x.float().mean()) - 0.3) < 0.02
    jlaw = jd.IID(jbs.Bernoulli(0.3), 4)
    np.testing.assert_allclose(
        law.logpdf(x[:50]).numpy(),
        np.asarray(jlaw.logpdf(jnp.asarray(_np(x[:50])))), rtol=RTOL)
    # a product of bool laws that are not one law, and one mixing types
    two = dists.IndepProd(bs.Bernoulli(0.2), bs.Bernoulli(0.9))
    assert two.dtype == "bool" and not two._one_law
    assert two.rvs(gen, size=7).dtype == torch.bool
    assert dists.IndepProd(bs.Bernoulli(0.2), dists.Normal()).dtype == \
        "float32"
    # an (N,) probability draws one value a particle
    pv = torch.tensor([0.0, 1.0, 0.5])
    b = bs.Bernoulli(pv)
    assert not b.elementwise
    draw = b.rvs(gen)
    assert draw.shape == (3,) and not draw[0] and draw[1]
    np.testing.assert_allclose(
        b.logpdf(torch.tensor([False, True, True])).numpy(),
        np.asarray(jbs.Bernoulli(jnp.asarray(pv.numpy())).logpdf(
            jnp.asarray([False, True, True]))), rtol=RTOL)


def test_corr_bin_and_log_no_warn_match_jax():
    rng = np.random.default_rng(1)
    pi, pj = rng.uniform(size=20).astype(np.float32), \
        rng.uniform(size=20).astype(np.float32)
    pij = (np.minimum(pi, pj) * rng.uniform(size=20)).astype(np.float32)
    pi[:3] = 0.0
    pj[3:5] = 1.0
    out = bs.corr_bin(*map(torch.from_numpy, (pi, pj, pij)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jbs.corr_bin(
        *map(jnp.asarray, (pi, pj, pij)))), rtol=RTOL, atol=1e-6)
    assert torch.all(out[:5] == 0.0)
    v = np.array([0.0, 1e-40, 0.5], np.float32)
    np.testing.assert_allclose(bs.log_no_warn(torch.from_numpy(v)).numpy(),
                               np.asarray(jbs.log_no_warn(jnp.asarray(v))))
    assert bs.log_no_warn(0.0) == np.log(1e-30)


# ---------------------------------------------------------------------------
# the likelihoods
# ---------------------------------------------------------------------------

def _explicit(xtx, xty, gamma, vm2):
    """(len, ldet, wtw) of each particle, float64, from its submatrix."""
    out = []
    for g in gamma:
        if not g.any():
            out.append((0.0, 0.0, 0.0))
            continue
        C = np.linalg.cholesky(xtx[np.ix_(g, g)] + vm2 * np.eye(g.sum()))
        w = np.linalg.solve(C, xty[g])
        out.append((g.sum(), np.log(np.diag(C)).sum(), w @ w))
    return np.array(out).T


@pytest.mark.parametrize("vm2", [0.0, 0.5])
def test_chol_and_friends_matches_jax_and_float64(vs, vm2, monkeypatch):
    jmodel, model, _ = vs
    gamma = _gammas(64, 6, 2)
    gamma[0] = False
    gamma[1] = True
    out = bs.chol_and_friends(torch.from_numpy(gamma), model.xtx, model.xty,
                              vm2)
    jout = jax.jit(jbs.chol_and_friends)(jnp.asarray(gamma), jmodel.xtx,
                                         jmodel.xty, vm2)
    exact = _explicit(_np(model.xtx).astype(np.float64),
                      _np(model.xty).astype(np.float64), gamma, vm2)
    for a, ja, e in zip(out, jout, exact):
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=RTOL,
                                   atol=1e-5)
        np.testing.assert_allclose(a.numpy(), e, rtol=1e-4, atol=1e-5)
    # in blocks of particles: the same values
    monkeypatch.setattr(bs, "CHOL_CHUNK", 7 * 36)
    for a, b in zip(bs.chol_and_friends(torch.from_numpy(gamma), model.xtx,
                                        model.xty, vm2), out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(_MODELS))
def test_loglik_gamma_matches_jax(name):
    jmodel, model = _model_pair(name)
    gamma = _gammas(64, 6, 3)
    ll = model.loglik({"gamma": torch.from_numpy(gamma)})
    jll = jax.jit(lambda g: jmodel.loglik({"gamma": g}))(jnp.asarray(gamma))
    assert np.isfinite(ll.numpy()).all()
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=RTOL)
    np.testing.assert_allclose(float(model.sig2_full()),
                               float(jmodel.sig2_full()), rtol=RTOL)


def test_likelihoods_match_float64_submatrices():
    """BayesianVS, BIC and the g-prior from float64 submatrix formulas."""
    X, y = _design()
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    gamma = _gammas(32, 6, 4)
    n = X.shape[0]
    yty = y64 @ y64
    sig2 = (yty - _explicit(X64.T @ X64, X64.T @ y64,
                            np.ones((1, 6), bool), 0.0)[2][0]) / n
    _, prior = _priors(6)
    for name, (cls, kw) in _MODELS.items():
        model = getattr(bs, cls)(data=(X, y), prior=prior, device="cpu", **kw)
        nu = kw.get("nu", 4.0)
        iv2 = kw.get("iv2", sig2 / 10.0)
        if cls == "BayesianVS":
            L, ldet, wtw = _explicit(X64.T @ X64, X64.T @ y64, gamma, iv2)
            want = -(-0.5 * np.log(iv2) * L + ldet + 0.5 * (nu + n)
                     * np.log(nu * sig2 + yty - wtw))
        else:
            L, _, wtw = _explicit(X64.T @ X64, X64.T @ y64, gamma, 0.0)
            if cls == "BIC":
                want = -(np.log(n) * 10.0 * L + n * 10.0 * np.log(yty - wtw))
            else:
                g = float(n)
                want = -(0.5 * np.log(1 + g) * L + 0.5 * (n + nu)
                         * np.log(nu * sig2 + yty - g / (g + 1) * wtw))
        got = model.loglik({"gamma": torch.from_numpy(gamma)}).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("name", ["BayesianVS", "BIC", "BayesianVS_gprior"])
def test_complete_enum_matches_jax(name):
    jmodel, model = _model_pair(name, p=5)
    gammas, lp = model.complete_enum()
    jg, jlp = jax.jit(jmodel.complete_enum)()
    np.testing.assert_array_equal(gammas.numpy(), np.asarray(jg))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-4,
                               rtol=1e-6)
    # the strong signals (the first two predictors) are in the best model
    best = gammas[int(torch.argmax(lp))]
    assert best[0] and best[1]


# ---------------------------------------------------------------------------
# the nested-logistic proposal
# ---------------------------------------------------------------------------

def _binary_cloud(N=500, d=6, seed=5):
    """Correlated binary columns, one nearly always 0 (edgy), and
    Dirichlet weights."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(N, 1))
    x = (rng.normal(size=(N, d)) + 1.2 * z) > 0
    x[:, 2] = rng.uniform(size=N) < 0.005
    x[:, 4] = x[:, 0] ^ (rng.uniform(size=N) < 0.1)
    W = rng.dirichlet(np.ones(N)).astype(np.float32)
    return x, W


@pytest.fixture(scope="module")
def fitted():
    x, W = _binary_cloud()
    jprop = jax.jit(jbs.NestedLogistic.fit)(jnp.asarray(W), jnp.asarray(x))
    prop = bs.NestedLogistic.fit(torch.from_numpy(W), torch.from_numpy(x))
    return x, W, jprop, prop


def test_nested_logistic_fit_matches_jax(fitted, monkeypatch):
    x, W, jprop, prop = fitted
    edgy = prop.edgy.numpy()
    np.testing.assert_array_equal(edgy, np.asarray(jprop.edgy))
    assert edgy[2] and not edgy.all()
    # some components regress on earlier ones
    assert np.count_nonzero(np.tril(prop.coeffs.numpy(), -1)) >= 2
    xx = _gammas(200, 6, 6)
    np.testing.assert_allclose(
        prop._probs(torch.from_numpy(xx)).numpy(),
        np.asarray(jprop._probs(jnp.asarray(xx))), atol=1e-4)
    np.testing.assert_allclose(
        prop.logpdf(torch.from_numpy(xx)).numpy(),
        np.asarray(jprop.logpdf(jnp.asarray(xx))), atol=1e-4, rtol=1e-5)
    # the Gram matrices in blocks of rows: the same fit
    monkeypatch.setattr(bs, "FIT_CHUNK", 2 * 500 * 6)
    again = bs.NestedLogistic.fit(torch.from_numpy(W), torch.from_numpy(x))
    np.testing.assert_allclose(again.coeffs.numpy(), prop.coeffs.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_nested_logistic_draws_match_jax(fitted):
    """``rvs`` on the JAX package's uniforms: equal wherever the uniform is
    1e-6 or more from its probability; the law's moments match the cloud."""
    x, W, jprop, prop = fitted
    key = jax.random.key(8)
    N = 4000
    jdraw = np.asarray(jax.jit(lambda k: jprop.rvs(k, size=N))(key))
    u = np.array(jax.random.uniform(key, (N, 6)))
    draw = prop.rvs_with(torch.from_numpy(u))
    assert draw.dtype == torch.bool
    p = prop._probs(draw).numpy()
    clear = np.abs(u - p) >= 1e-6
    assert clear.mean() > 0.999
    np.testing.assert_array_equal(draw.numpy()[clear], jdraw[clear])
    gen = torch.Generator().manual_seed(0)
    many = prop.rvs(gen, size=20000).float().mean(0).numpy()
    np.testing.assert_allclose(many, W @ x, atol=0.03)


def test_binary_metropolis_step_matches_jax(vs):
    """One step on the JAX package's draws (``k1``: the proposal's
    uniforms, ``k2``: the accept uniforms)."""
    jmodel, model, _ = vs
    M = 64
    x, W = _binary_cloud(N=M, seed=9)
    jx = jssp.ThetaParticles(theta={"gamma": jnp.asarray(x)})
    jtarget = jssp.AdaptiveTempering(model=jmodel).current_target(
        jnp.float32(0.4))
    jx = jax.jit(jtarget)(jx)
    jmove = jbs.BinaryMetropolis()
    jx = jx.with_shared(**jax.jit(jmove.calibrate)(jnp.asarray(W), jx))
    tx = convert.theta_particles_from_numpy(
        {"gamma": x}, {k: np.asarray(getattr(jx, k))
                       for k in ("lprior", "llik", "lpost")},
        {k: np.asarray(v) for k, v in jx.shared.items()}, device="cpu")
    assert tx.theta["gamma"].dtype == torch.bool
    target = ssp.AdaptiveTempering(model=model).current_target(
        torch.tensor(0.4))
    key = jax.random.key(10)
    jout, jacc = jax.jit(lambda k, xx: jmove.step(k, xx, jtarget))(key, jx)
    k1, k2, _ = jax.random.split(key, 3)
    u_prop = torch.from_numpy(np.asarray(jax.random.uniform(k1, (M, 6))))
    u_acc = torch.from_numpy(np.asarray(jax.random.uniform(k2, (M,))))
    out, acc = bs.BinaryMetropolis().step_with(tx, target, u_prop, u_acc)
    moved = (out.theta["gamma"] != tx.theta["gamma"]).any(1)
    assert 0 < int(moved.sum()) < M
    np.testing.assert_array_equal(out.theta["gamma"].numpy(),
                                  np.asarray(jout.theta["gamma"]))
    for k in ("lpost", "lprior", "llik"):
        np.testing.assert_allclose(getattr(out, k).numpy(),
                                   np.asarray(getattr(jout, k)), rtol=RTOL,
                                   err_msg=k)
    # the two packages' float32 Cholesky factors put lpost 4e-7 apart
    # (relative), which moves each acceptance probability by up to 5e-5
    np.testing.assert_allclose(float(acc), float(jacc), rtol=RTOL)


def test_binary_sampler_step_matches_jax(vs):
    """One whole step of a waste-free binary AdaptiveTempering (fit,
    resample by B1's plain version and B2's, two chain steps) from one
    state, on the JAX package's draws."""
    jmodel, model, _ = vs
    N, P = 16, 3
    jfk = jssp.AdaptiveTempering(
        model=jmodel, len_chain=P,
        move=jssp.MCMCSequenceWF(mcmc=jbs.BinaryMetropolis(), len_chain=P))
    fk = ssp.AdaptiveTempering(
        model=model, len_chain=P,
        move=ssp.MCMCSequenceWF(mcmc=bs.BinaryMetropolis(), len_chain=P))
    jcarry = jax.jit(lambda k: jssp._sampler_step0(jfk, k, N))(
        jax.random.key(4))
    X = jcarry.X
    fields = {k: np.asarray(v) for k, v in X._particle_fields().items()
              if k != "theta"}
    tX = convert.theta_particles_from_numpy(
        {"gamma": np.asarray(X.theta["gamma"])}, fields,
        {k: np.asarray(v) for k, v in X.shared.items()}, device="cpu")
    carry = core._Carry(X=tX, lw=torch.tensor(np.asarray(jcarry.lw)),
                        logLt=torch.tensor(float(jcarry.logLt)),
                        log_mean_w=torch.tensor(float(jcarry.log_mean_w)))
    jnew, _ = jax.jit(lambda c: jssp._sampler_step(
        jfk, c, jnp.int32(1), N, "systematic", 0.5))(jcarry)
    _, k_rs, k_mv = jax.random.split(jcarry.key, 3)
    move = []
    for k in jax.random.split(k_mv, P - 1):
        k1, k2, _ = jax.random.split(k, 3)
        move.append((torch.from_numpy(np.asarray(
            jax.random.uniform(k1, (N, 6)))), torch.from_numpy(
                np.asarray(jax.random.uniform(k2, (N,))))))
    draws = {"rs_u": torch.tensor(float(jax.random.uniform(k_rs, ()))),
             "move": move}
    new, view = ssp._sampler_step(fk, None, carry, 1, N, "systematic", 0.5,
                                  draws=draws)
    assert view.rs_flag and new.X.N == jnew.X.N == N * P
    np.testing.assert_array_equal(new.X.theta["gamma"].numpy(),
                                  np.asarray(jnew.X.theta["gamma"]))
    for k in fields:
        np.testing.assert_allclose(_np(getattr(new.X, k)),
                                   np.asarray(getattr(jnew.X, k)),
                                   rtol=RTOL, atol=1e-4, err_msg=k)
    for k in ("exponent", "path_sampling", "acc_rate"):
        np.testing.assert_allclose(_np(new.X.shared[k]),
                                   np.asarray(jnew.X.shared[k]), rtol=RTOL,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(new.X.shared["prop_edgy"].numpy(),
                                  np.asarray(jnew.X.shared["prop_edgy"]))
    np.testing.assert_allclose(new.X.shared["prop_coeffs"].numpy(),
                               np.asarray(jnew.X.shared["prop_coeffs"]),
                               atol=1e-4)
    np.testing.assert_allclose(new.lw.numpy(), np.asarray(jnew.lw),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(new.logLt), float(jnew.logLt),
                               rtol=RTOL)


def test_bool_leaf_served_by_z():
    """The resampling move on a bool (N, 103) leaf beside float ones: the
    rows the z-form names, bool kept."""
    rng = np.random.default_rng(11)
    N, M = 300, 100
    x = convert.theta_particles_from_numpy(
        {"gamma": rng.uniform(size=(N, 103)) < 0.3},
        {"lpost": rng.normal(size=N)}, device="cpu")
    counts = rng.multinomial(M, np.full(N, 1.0 / N))
    z = torch.from_numpy(np.cumsum(counts).astype(np.int32))
    out = x.subset_by_z(z, M)
    A = np.repeat(np.arange(N), counts)
    assert out.theta["gamma"].dtype == torch.bool
    np.testing.assert_array_equal(out.theta["gamma"].numpy(),
                                  x.theta["gamma"].numpy()[A])
    np.testing.assert_array_equal(out.lpost.numpy(), x.lpost.numpy()[A])
    served, _ = ops.repeat_cols(z, M, [x.theta["gamma"]])
    assert torch.equal(served[0], out.theta["gamma"])


# ---------------------------------------------------------------------------
# whole runs against enumeration
# ---------------------------------------------------------------------------

def _binary_fk(model, P=4):
    move = ssp.MCMCSequenceWF(mcmc=bs.BinaryMetropolis(), len_chain=P)
    return ssp.AdaptiveTempering(model=model, len_chain=P, move=move,
                                 ESSrmin=0.5)


def _inclusion(pf):
    return _np(pf.X.theta["gamma"].double().T @ pf.wgts.W.double())


def test_toy_recovers_the_enumerated_posterior(vs):
    """tests/test_binary_smc.py's check: the mean inclusion probabilities
    of 3 runs within 0.1 of enumeration, the active predictors above the
    inactive ones."""
    _, model, exact = vs
    incls = []
    for s in range(3):
        pf = SMC(fk=_binary_fk(model), N=300, seed=s)
        pf.run()
        assert float(pf.X.shared["exponent"]) == 1.0
        assert np.isfinite(float(pf.logLt))
        assert pf.X.theta["gamma"].dtype == torch.bool
        incls.append(_inclusion(pf))
    est = np.mean(incls, axis=0)
    np.testing.assert_allclose(est, exact, atol=0.1)
    assert est[[0, 1, 4]].min() > est[[2, 3, 5]].max()


def test_moments_and_var_wf_on_a_binary_run(vs):
    """The default ``Moments`` collector and the waste-free variance
    estimates take the bool leaf; the moments are the weighted inclusion
    probabilities."""
    _, model, _ = vs
    pf = SMC(fk=_binary_fk(model), N=100, seed=7,
             collect=[collectors.Moments(), ssp.Var_logLt()])
    pf.run()
    last = pf.summaries.moments[-1]
    np.testing.assert_allclose(_np(last["mean"]["gamma"]), _inclusion(pf),
                               rtol=1e-5, atol=1e-6)
    var = _np(last["var"]["gamma"])
    assert np.all(var > -1e-6) and np.all(var < 0.25 + 1e-6)
    v = ssp.var_wf(pf, lambda X: X.theta["gamma"][:, 0])
    assert np.isfinite(v) and v >= 0.0
    assert all(np.isfinite(pf.summaries.var_logLt))


def test_data_goes_to_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _design()
    _, prior = _priors(6)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bs.BayesianVS(data=(X, y), prior=prior)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bs.all_binary_words(3)
    model = bs.BayesianVS(data=(torch.from_numpy(X), torch.from_numpy(y)),
                          prior=prior)
    assert model.xtx.device.type == "cpu"
    pf = SMC(fk=_binary_fk(model), N=10)        # follows (x, y)'s device
    assert pf.device.type == "cpu"


def test_gram_of_a_near_singular_design():
    """The Boston design of examples/binary_smc_boston_interactions.py
    (main effects, squares, interactions: 506 x 103, Gram condition number
    ~2.6e8): the full model's residual variance within 1e-3 of float64's,
    where a float32 Gram matrix gave -1.12 (ROADMAP C.12)."""
    from particles_tpu_torch import datasets

    raw = np.asarray(datasets.Boston().raw_data, np.float64)
    base = raw[:, :-1]
    cols = []
    for i in range(13):
        cols.append(base[:, i])
        if i != 3:                                  # CHAS is binary
            cols.append(base[:, i] ** 2)
        cols.extend(base[:, i] * base[:, j] for j in range(i))
    X = np.stack(cols, 1)
    X = (X - X.mean(0)) / X.std(0)
    y = np.log(raw[:, -1])
    y = (y - y.mean()) / y.std()
    X, y = X.astype(np.float32), y.astype(np.float32)
    assert X.shape == (506, 103)
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    beta = np.linalg.solve(X64.T @ X64, X64.T @ y64)
    exact = (y64 @ y64 - (X64.T @ y64) @ beta) / 506
    _, prior = _priors(103)
    model = bs.BayesianVS(data=(X, y), prior=prior, device="cpu")
    np.testing.assert_allclose(float(model.lamb), exact, rtol=1e-3)
    gamma = torch.from_numpy(_gammas(8, 103, 12))
    assert torch.isfinite(model.loglik({"gamma": gamma})).all()
