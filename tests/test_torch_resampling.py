"""The port's weight numerics and scheme registry
(``particles_tpu_torch.resampling``) against ``particles_tpu.resampling``.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerance: rtol 1e-5 in float32 (reductions are summed in another order);
normalised weights below 1e-10 are compared absolutely at that level,
since they are subnormal or underflow in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particles_tpu.resampling as jrs
import particles_tpu_torch.resampling as trs
from particles_tpu_torch import ops

RTOL = 1e-5


def _close(t, j, atol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL,
                               atol=atol)


_CASES = ["normal", "nan", "spread", "neginf"]


def _lw(case, N=1000):
    rng = np.random.default_rng(_CASES.index(case))
    lw = 3.0 * rng.normal(size=N)
    if case == "nan":
        lw[rng.integers(N, size=20)] = np.nan
    elif case == "spread":   # spread > 88: W of half the particles underflows
        lw[: N // 2] -= 120.0
    elif case == "neginf":
        lw[:10] = -np.inf
    return lw.astype(np.float32)


@pytest.mark.parametrize("case", _CASES)
def test_weights_match_jax(case):
    lw = _lw(case)
    jw = jrs.Weights(jnp.asarray(lw))
    tw = trs.Weights(torch.from_numpy(lw))
    np.testing.assert_array_equal(tw.lw.numpy(), np.asarray(jw.lw))
    _close(tw.W, jw.W, atol=1e-10)
    _close(tw.ESS, jw.ESS)
    _close(tw.log_mean, jw.log_mean)
    assert tw.N == len(lw)
    t2, j2 = tw.add(torch.ones(len(lw))), jw.add(jnp.ones(len(lw)))
    _close(t2.log_mean, j2.log_mean)
    assert trs.Weights().lw is None and trs.Weights().N == 0


@pytest.mark.parametrize("case", ["normal", "spread"])
def test_log_mean_exp_matches_jax(case):
    lw = _lw(case)
    v = np.random.default_rng(1).normal(size=lw.shape).astype(np.float32)
    vt, vj = torch.from_numpy(v), jnp.asarray(v)
    _close(trs.log_mean_exp(vt), jrs.log_mean_exp(vj))
    _close(trs.log_mean_exp(vt, lw=torch.from_numpy(lw)),
           jrs.log_mean_exp(vj, lw=jnp.asarray(lw)))
    W = np.array(jrs.exp_and_normalise(jnp.asarray(lw)))
    _close(trs.log_mean_exp(vt, W=torch.from_numpy(W)),
           jrs.log_mean_exp(vj, W=jnp.asarray(W)))


def test_log_mean_exp_stabilises_jointly():
    """The max-v particle carries ~zero weight: stabilising by max(v)
    alone would underflow every term to 0 (-inf)."""
    v = np.array([200.0, 0.0, 0.0], np.float32)
    lw = np.array([-300.0, 0.0, 0.0], np.float32)
    out = trs.log_mean_exp(torch.from_numpy(v), lw=torch.from_numpy(lw))
    assert np.isfinite(float(out))
    _close(out, jrs.log_mean_exp(jnp.asarray(v), lw=jnp.asarray(lw)))


def test_numerics_match_jax():
    rng = np.random.default_rng(7)
    lw = (2.0 * rng.normal(size=500)).astype(np.float32)
    lt, lj = torch.from_numpy(lw), jnp.asarray(lw)
    _close(trs.exp_and_normalise(lt), jrs.exp_and_normalise(lj), atol=1e-10)
    _close(trs.essl(lt), jrs.essl(lj))
    _close(trs.log_sum_exp(lt), jrs.log_sum_exp(lj))
    a, b = lw[:250], lw[250:]
    _close(trs.log_sum_exp_ab(torch.from_numpy(a), torch.from_numpy(b)),
           jrs.log_sum_exp_ab(jnp.asarray(a), jnp.asarray(b)))
    W = np.array(jrs.exp_and_normalise(lj))
    for x in (rng.normal(size=500), rng.normal(size=(500, 2))):
        x = x.astype(np.float32)
        t = trs.wmean_and_var(torch.from_numpy(W), torch.from_numpy(x))
        j = jrs.wmean_and_var(jnp.asarray(W), jnp.asarray(x))
        _close(t["mean"], j["mean"], atol=1e-6)
        _close(t["var"], j["var"])


def test_scheme_registry():
    assert set(trs.rs_funcs) == {"systematic", "stratified", "multinomial",
                                 "residual", "ssp", "killing", "idiotic"}
    assert set(trs.rs_counts_funcs) == set(trs.rs_funcs) - {"killing",
                                                             "idiotic"}
    assert set(trs.rs_z_funcs) == {"systematic", "stratified", "multinomial"}
    W = torch.from_numpy(
        np.random.default_rng(2).dirichlet(np.ones(300)).astype(np.float32))
    g = torch.Generator().manual_seed(5)
    A = trs.resampling("systematic", g, W)
    assert A.dtype == torch.int64 and A.shape == (300,)
    assert bool((A[1:] >= A[:-1]).all())
    g = torch.Generator().manual_seed(5)
    z = trs.resampling_z("systematic", g, W, M=150)
    assert z.dtype == torch.int32 and int(z[-1]) == 150
    g = torch.Generator().manual_seed(5)
    np.testing.assert_array_equal(
        trs.systematic(g, W, 150).numpy(), ops.ancestors_by_z(z, 150).numpy())
    for name in trs.rs_counts_funcs:
        z = trs.resampling_z(name, g, W, M=150)
        assert z.dtype == torch.int32 and int(z[-1]) == 150
        assert bool((z[1:] >= z[:-1]).all())
    for name in ("killing", "idiotic"):
        with pytest.raises(ValueError, match="no counts-based"):
            trs.resampling_z(name, g, W)
    with pytest.raises(ValueError):
        trs.resampling("nonsense", g, W)


def test_systematic_offspring_counts():
    """Same W, many uniforms: each offspring count is floor(N W_i) or
    floor(N W_i) + 1, and its mean over u is N W_i (to 4 sd of the mean
    over 400 draws)."""
    N = 64
    W = np.random.default_rng(4).dirichlet(np.ones(N)).astype(np.float32)
    Wt = torch.from_numpy(W)
    g = torch.Generator().manual_seed(0)
    counts = np.stack([
        np.bincount(trs.systematic(g, Wt).numpy(), minlength=N)
        for _ in range(400)])
    lo = np.floor(N * W.astype(np.float64))
    assert np.all((counts >= lo - 1e-9) & (counts <= lo + 1 + 1e-9))
    sd = np.sqrt(0.25 / 400)
    assert np.all(np.abs(counts.mean(0) - N * W) < 4 * sd + 1e-6)
