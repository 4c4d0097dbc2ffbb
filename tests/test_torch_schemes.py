"""The port's resampling schemes (``particles_tpu_torch.resampling``), its
engine under each scheme, and ``multiSMC``, against the JAX package.

Torch generators and JAX keys give different streams, so the schemes are
held to the facts ``tests/test_resampling.py`` pins for the JAX package
(range, shape, unbiasedness, support, exact totals, SSP's sum and
support), to the JAX functions on the same uniforms (the z-forms, |dz| <=
1: the two CDFs differ in the last ulp), to the JAX package's host SSP on
the same inputs (exact), and whole filters by statistics over seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particles_tpu.core as jcore
import particles_tpu.kalman as jk
import particles_tpu.resampling as jrs
import particles_tpu.state_space_models as jssms
import particles_tpu_torch.resampling as trs
from particles_tpu import native
from particles_tpu_torch import convert, core, kalman

SCHEMES = ["multinomial", "residual", "stratified", "systematic", "ssp",
           "killing"]
SORTED = ["multinomial", "stratified", "systematic", "residual", "ssp"]


def _weights(seed, N, concentrated=False):
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.full(N, 0.3 if concentrated else 1.0))
    return torch.from_numpy(W.astype(np.float32))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# the schemes' facts (tests/test_resampling.py::TestSchemes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES + ["idiotic"])
def test_output_range_and_shape(scheme):
    A = trs.resampling(scheme, _gen(0), _weights(1, 64))
    assert A.shape == (64,) and A.dtype == torch.int64
    assert int(A.min()) >= 0 and int(A.max()) < 64


@pytest.mark.parametrize("scheme", SORTED)
def test_M_not_N(scheme):
    W = _weights(2, 50)
    for M in (120, 17):
        A = trs.resampling(scheme, _gen(1), W, M=M)
        assert A.shape == (M,) and int(A.max()) < 50
        assert bool((A[1:] >= A[:-1]).all())
        c = trs.resampling_counts(scheme, _gen(1), W, M=M)
        assert c.dtype == torch.int32 and int(c.sum()) == M
        assert int(c.min()) >= 0


@pytest.mark.parametrize("scheme", SCHEMES)
def test_unbiasedness(scheme):
    """E[#offspring(n)] == M W_n, to 6 standard errors."""
    N, reps = 32, 600
    W = _weights(3, N, concentrated=True)
    g = _gen(42)
    counts = np.stack([
        np.bincount(trs.resampling(scheme, g, W).numpy(), minlength=N)
        for _ in range(reps)])
    expected = N * W.numpy().astype(np.float64)
    se = np.sqrt(np.maximum(expected, 0.05)) / np.sqrt(reps)
    assert np.all(np.abs(counts.mean(0) - expected) < 6 * se + 0.05), scheme


@pytest.mark.parametrize("scheme", ["systematic", "stratified", "ssp"])
def test_offspring_floor_ceil(scheme):
    """systematic and ssp: #offspring(n) in {floor(M W_n), floor(M W_n) +
    1}.  stratified only keeps |#offspring(n) - M W_n| < 2: an interval
    shorter than one stratum can meet two strata and draw in both."""
    N = 40
    W = _weights(4, N, concentrated=True)
    MW = N * W.numpy().astype(np.float64)
    g = _gen(0)
    for _ in range(20):
        counts = np.bincount(trs.resampling(scheme, g, W).numpy(),
                             minlength=N)
        if scheme == "stratified":
            assert np.all(np.abs(counts - MW) < 2)
        else:
            assert np.all((counts >= np.floor(MW)) & (counts <= np.floor(MW)
                                                       + 1))


@pytest.mark.parametrize("scheme", SORTED)
def test_exact_count(scheme):
    """Total offspring is exactly M, and the z-form ends at M."""
    for seed in range(10):
        W = _weights(seed, 77)
        c = trs.resampling_counts(scheme, _gen(seed + 100), W)
        assert int(c.sum()) == 77 and int(c.min()) >= 0
        z = trs.resampling_z(scheme, _gen(seed + 100), W)
        assert int(z[-1]) == 77 and bool((z[1:] >= z[:-1]).all())


def test_killing_idiotic_and_unknown():
    W = _weights(6, 10)
    with pytest.raises(ValueError, match="M=N"):
        trs.killing(_gen(0), W, M=5)
    A = trs.idiotic(_gen(0), _weights(7, 10), 10)
    assert len(np.unique(A.numpy())) == 1
    with pytest.raises(ValueError):
        trs.resampling("nope", _gen(0), W)


def test_degenerate_weights():
    """One-hot weights resolve to the single live particle."""
    W = torch.zeros(16)
    W[5] = 1.0
    for scheme in SORTED + ["killing"]:
        A = trs.resampling(scheme, _gen(0), W)
        assert bool((A == 5).all()), scheme


# ---------------------------------------------------------------------------
# inverse CDF, spacings, IID draws (TestInverseCdf, TestMultinomialQueue)
# ---------------------------------------------------------------------------

def test_inverse_cdf_matches_two_pointer():
    rng = np.random.default_rng(0)
    W = rng.dirichlet(np.ones(30)).astype(np.float32)
    su = np.sort(rng.uniform(size=25)).astype(np.float32)
    j, s = 0, W[0]
    expected = np.empty(25, dtype=np.int64)
    for n in range(25):
        while su[n] > s:
            j += 1
            s += W[j]
        expected[n] = j
    got = trs.inverse_cdf(torch.from_numpy(su), torch.from_numpy(W))
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jrs.inverse_cdf(jnp.asarray(su),
                                                jnp.asarray(W))))


def test_uniform_spacings_sorted():
    su = trs.uniform_spacings(_gen(0), 1000).numpy()
    assert np.all(np.diff(su) > 0)
    assert su[0] > 0 and su[-1] < 1
    assert abs(su.mean() - 0.5) < 0.05


def test_multinomial_iid_is_the_inverse_cdf_of_its_uniforms():
    """Ancestors #{i: cs_i < u_j} of unsorted uniforms, cs the pinned B3
    CDF; the served values ride the same move."""
    N, M = 500, 1500
    W = _weights(9, N, concentrated=True)
    u = torch.rand(M, generator=_gen(3))
    cs = trs._normalised_cumsum_mono(W)[0].numpy()
    cs[-1] = 1.0
    ref = np.minimum(np.searchsorted(cs, u.numpy(), side="left"), N - 1)
    np.testing.assert_array_equal(trs.multinomial_iid(_gen(3), W, M).numpy(),
                                  ref)
    x = torch.randn(N, 2, generator=_gen(4))
    A, (vals,) = trs.multinomial_iid_values(_gen(3), W, [x], M)
    np.testing.assert_array_equal(A.numpy(), ref)
    assert torch.equal(vals, x[A])
    assert (np.diff(ref) < 0).any()   # IID: the output is not sorted


def test_multinomial_once_and_queue():
    W = _weights(8, 20)
    a = trs.multinomial_once(_gen(0), W)
    assert a.ndim == 0 and 0 <= int(a) < 20
    q = trs.MultinomialQueue(_gen(0), W)
    first = q.dequeue(7)
    second = q.dequeue(15)   # triggers re-enqueue
    assert first.shape == (7,) and second.shape == (15,)
    assert int(second.max()) < 20
    with pytest.raises(ValueError):
        q.dequeue(25)


# ---------------------------------------------------------------------------
# the z-forms on the JAX package's own uniforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,M", [(2048, 2048), (1000, 333)])
def test_stratified_and_multinomial_z_match_jax_on_same_uniforms(N, M):
    """The JAX functions draw ``uniform(key, (M,))`` and
    ``uniform_spacings(key, M)``; the port's z-forms get those arrays."""
    rng = np.random.default_rng(N + M)
    W = np.array(jrs.exp_and_normalise(
        jnp.asarray(2.0 * rng.normal(size=N), jnp.float32)))
    Wt = torch.from_numpy(W)
    key = jax.random.key(N)
    draws = {
        "stratified": (jrs.stratified_z, trs._stratified_z_of,
                       jax.random.uniform(key, (M,))),
        "multinomial": (jrs.multinomial_z, trs._multinomial_z_of,
                        jrs.uniform_spacings(key, M)),
    }
    for name, (jax_z, port_z_of, u) in draws.items():
        zj = np.asarray(jax.jit(jax_z, static_argnums=2)(
            key, jnp.asarray(W), M)).astype(np.int64)
        zt = port_z_of(torch.from_numpy(np.array(u)), Wt, M).numpy()
        assert zt[-1] == M and np.all(np.diff(zt) >= 0), name
        assert np.abs(zt.astype(np.int64) - zj).max() <= 1, name


# ---------------------------------------------------------------------------
# SSP: the sequential host loop and the tree form (TestBlockedSSP)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,M", [(1, 1), (77, 77), (2048, 2048), (300, 120)])
def test_sequential_ssp_matches_the_jax_package_host_loop(N, M):
    rng = np.random.default_rng(N)
    W = rng.dirichlet(np.full(N, 0.3))
    u = rng.uniform(size=N - 1)
    np.testing.assert_array_equal(
        trs._ssp_counts_sequential(list(W), M, list(u)),
        native.ssp_counts(W, M, u))


def test_blocked_ssp_sum_support_unbiasedness():
    N, R = 10_000, 40     # above the routing threshold
    W = _weights(0, N, concentrated=True)
    MW = N * W.numpy().astype(np.float64)
    tot = np.zeros(N)
    g = _gen(0)
    for _ in range(R):
        c = trs.resampling_counts("ssp", g, W).numpy()
        assert c.sum() == N
        assert ((c >= np.floor(MW) - 1e-6) & (c <= np.ceil(MW) + 1e-6)).all()
        tot += c
    p = MW - np.floor(MW)
    sd = np.sqrt(np.maximum(p * (1 - p), 1e-12) / R)
    assert (((tot / R - MW) / sd) ** 2).mean() < 1.6


def test_blocked_ssp_unaligned_and_degenerate():
    for N in (8192 + 37, 9999):
        c = trs.resampling_counts("ssp", _gen(N), _weights(N, N)).numpy()
        assert c.sum() == N and (c >= 0).all()
    N = 8192
    W = torch.zeros(N)
    W[1234] = 1.0
    c = trs.resampling_counts("ssp", _gen(2), W).numpy()
    assert c[1234] == N and c.sum() == N


# ---------------------------------------------------------------------------
# the filter under each scheme, and multiSMC
# ---------------------------------------------------------------------------

PARAMS = dict(rho=0.9, sigmaX=1.0, sigmaY=0.2)


def _data(T, seed):
    rng = np.random.default_rng(seed)
    xs = np.empty(T)
    xs[0] = rng.normal() / np.sqrt(1 - PARAMS["rho"] ** 2)
    for t in range(1, T):
        xs[t] = PARAMS["rho"] * xs[t - 1] + PARAMS["sigmaX"] * rng.normal()
    return (xs + PARAMS["sigmaY"] * rng.normal(size=T)).astype(np.float32)


@pytest.mark.parametrize("scheme", ["multinomial", "stratified", "residual",
                                    "ssp", "killing"])
def test_filter_matches_kalman_and_jax_by_statistics(scheme):
    """T=25, 8 fixed seeds, N=4096 (ssp 2048: its sequential host loop).
    One run's logLt has sd ~ 0.15, so the mean of 8 has sd ~ 0.05: the
    port's mean within 0.3 of Kalman, and within 0.4 of the JAX package's
    mean on the same data."""
    T, seeds = 25, range(8)
    N = 2048 if scheme == "ssp" else 4096
    y = _data(T, 1)
    tfk = convert.bootstrap_from_numpy(kalman.LinearGauss(**PARAMS), y,
                                       device="cpu")
    jfk = jssms.Bootstrap(ssm=jk.LinearGauss(**PARAMS), data=jnp.asarray(y))
    kf = float(kalman.Kalman(ssm=tfk.ssm,
                             data=torch.from_numpy(y.astype(np.float64))).logLt)
    port, jax_runs = [], []
    for s in seeds:
        pf = core.SMC(fk=tfk, N=N, seed=s, resampling=scheme)
        pf.run()
        port.append(float(pf.logLt))
        jpf = jcore.SMC(fk=jfk, N=N, seed=s, resampling=scheme)
        jpf.run()
        jax_runs.append(float(jpf.logLt))
    assert np.all(np.isfinite(port))
    assert abs(np.mean(port) - kf) < 0.3
    assert abs(np.mean(port) - np.mean(jax_runs)) < 0.4


def test_multiSMC_output():
    T, N, nruns = 8, 256, 2
    fk = convert.bootstrap_from_numpy(kalman.LinearGauss(**PARAMS),
                                      _data(T, 2), device="cpu")
    schemes = ["systematic", "ssp", "killing"]
    out = core.multiSMC(fk=fk, N=N, resampling=schemes, nruns=nruns, seed=3)
    assert len(out) == len(schemes) * nruns
    assert [(o["resampling"], o["run"]) for o in out] == [
        (s, r) for s in schemes for r in range(nruns)]
    for o in out:
        assert set(o) == {"resampling", "run", "output"}
        res = o["output"]
        assert np.isfinite(float(res.logLt)) and res.cpu_time > 0
        assert res.summaries.ESSs.shape == res.rs_flags.shape == (T,)
        assert res.lw.shape == (N,) and abs(float(res.W.sum()) - 1) < 1e-5
    # run r draws from the same stream in every combination
    same = core.multiSMC(fk={"a": fk, "b": fk}, N=N, nruns=nruns, seed=3,
                         out_func=lambda res: float(res.logLt))
    assert [o["fk"] for o in same] == ["a", "a", "b", "b"]
    assert same[0]["output"] == same[2]["output"]
    assert same[0]["output"] != same[1]["output"]
    assert same[0]["output"] == float(out[0]["output"].logLt)
