"""The port's weighted moments and quantiles, its experiment helpers of
``utils``, and its tree SSP pairing, against the JAX package.

- ``wmean_and_cov``, ``wmean_and_var_str_array``, ``wquantiles`` and
  ``wquantiles_str_array`` on the same numpy weights and particles:
  moments rtol 1e-5 (atol 1e-6) in float32, quantiles exact (a quantile
  is one of the particles).
- ``add_to_dict``, ``cartesian_lists``, ``worker``, ``distribute_work``,
  ``seeder`` and ``multiplexer``: the same outputs as the JAX package's
  for the same inputs, where a JAX key becomes a torch generator.
- The tree SSP (``resampling._ssp_counts_blocked``) against the
  sequential pairing, as ``tests/test_resampling.py::TestBlockedSSP`` holds
  the JAX package's, at N = 1024 with fewer replicates (R = 300, a few
  seconds): the mean total variation TV(W, counts/N) of the two within 5
  Monte Carlo standard errors of their difference (computed from the
  replicates); the same marginals (each count's variance within 10% of
  p(1 - p) on average); and the documented joint-law difference (adjacent
  covariance < -0.02 for the sequential pairing, |.| < 0.01 for the tree,
  the variance of a 64-wide window sum more than 5 times larger).
"""

import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particles_tpu.resampling as jrs
import particles_tpu.utils as jutils
import particles_tpu_torch.resampling as trs
from particles_tpu_torch import utils as tutils

rng = np.random.default_rng(0)
N = 500
W_NP = rng.dirichlet(np.ones(N)).astype(np.float32)
X_NP = rng.normal(size=(N, 3)).astype(np.float32)


def _close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def test_wmean_and_cov_matches_jax():
    m_t, c_t = trs.wmean_and_cov(torch.from_numpy(W_NP),
                                 torch.from_numpy(X_NP))
    m_j, c_j = jrs.wmean_and_cov(jnp.asarray(W_NP), jnp.asarray(X_NP))
    _close(m_t, m_j)
    _close(c_t, c_j)


def _dict_particles(mod):
    conv = torch.from_numpy if mod is trs else jnp.asarray
    return {"mu": conv(X_NP[:, 0]), "theta": conv(X_NP[:, 1:])}


def test_str_array_moments_match_jax():
    got = trs.wmean_and_var_str_array(torch.from_numpy(W_NP),
                                      _dict_particles(trs))
    want = jrs.wmean_and_var_str_array(jnp.asarray(W_NP),
                                       _dict_particles(jrs))
    for stat in ("mean", "var"):
        assert set(got[stat]) == {"mu", "theta"}
        for k in got[stat]:
            _close(got[stat][k], want[stat][k])


@pytest.mark.parametrize("alphas", [(0.25, 0.5, 0.75), (0.0, 0.01, 1.0)])
def test_wquantiles_match_jax(alphas):
    W_t, W_j = torch.from_numpy(W_NP), jnp.asarray(W_NP)
    for x in (X_NP[:, 0], X_NP):
        got = trs.wquantiles(W_t, torch.from_numpy(x), alphas)
        want = jrs.wquantiles(W_j, jnp.asarray(x), alphas)
        assert got.shape == tuple(want.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = trs.wquantiles_str_array(W_t, _dict_particles(trs), alphas)
    want = jrs.wquantiles_str_array(W_j, _dict_particles(jrs), alphas)
    for k in ("mu", "theta"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_add_to_dict_and_cartesian_lists_match_jax():
    d = {"a": 1, "b": [2]}
    for mod in (tutils, jutils):
        out = mod.add_to_dict(d, 3.5, key="res")
        assert out == {"a": 1, "b": [2], "res": 3.5} and "res" not in d
    grid = {"a": [0, 2], "b": [3, 4], "c": ["x"]}
    assert tutils.cartesian_lists(grid) == jutils.cartesian_lists(grid)
    assert tutils.cartesian_lists(grid)[1] == {"a": 0, "b": 4, "c": "x"}


def _f(x, y=1):
    return {"sum": x + y} if x > 1 else x * y


def test_worker_and_distribute_work_match_jax():
    inputs = [{"x": 1, "y": 3}, {"x": 2}, {"x": 5, "y": -1}]
    outs = []
    for mod in (tutils, jutils):
        qin, qout = queue.Queue(), queue.Queue()
        for i, args in enumerate(inputs):
            qin.put((i, args))
        qin.put((None, None))
        mod.worker(qin, qout, _f)
        got = [qout.get_nowait() for _ in inputs]
        assert qout.empty()
        outs.append((got, mod.distribute_work(_f, inputs, nprocs=4),
                     mod.distribute_work(_f, inputs, outputs=[
                         {"tag": k} for k in range(3)], out_key="o")))
    assert outs[0] == outs[1]
    assert outs[0][1][0] == {"x": 1, "y": 3, "output": 3}
    assert outs[0][1][1] == {"x": 2, "sum": 3}


def test_seeder_turns_a_seed_into_a_generator():
    """JAX: ``seed`` becomes ``key=jax.random.key(seed)``; the port:
    ``gen=torch.Generator(device).manual_seed(seed)``.  A caller's own
    key or generator wins, and other keywords pass through."""
    @tutils.seeder
    def draw(gen, scale=1.0):
        return scale * torch.rand(3, generator=gen, device=gen.device)

    @jutils.seeder
    def jdraw(key, scale=1.0):
        return scale * jax.random.uniform(key, (3,))

    port = tutils.seeder(draw.func, device="cpu")
    want = torch.rand(3, generator=torch.Generator().manual_seed(7))
    assert torch.equal(port(seed=7, scale=2.0), 2.0 * want)
    own = torch.Generator().manual_seed(1)
    assert torch.equal(port(seed=7, gen=own),
                       torch.rand(3, generator=torch.Generator().manual_seed(
                           1)))
    np.testing.assert_array_equal(
        np.asarray(jdraw(seed=7, scale=2.0)),
        2.0 * np.asarray(jax.random.uniform(jax.random.key(7), (3,))))
    assert draw.__name__ == "draw" and jdraw.__name__ == "jdraw"


def test_multiplexer_matches_jax():
    """The same list of dicts (labels of the varying options, run,
    output) in the same order; replicate r gets the same stream in every
    combination, as the JAX package's key r."""
    def port_f(gen, a, b, c):
        return (a, b, c, float(torch.rand((), generator=gen)))

    def jax_f(key, a, b, c):
        return (a, b, c, float(jax.random.uniform(key)))

    opts = dict(nruns=3, a=[1, 2], b={"lo": 0.1, "hi": 0.9}, c=5)
    got = tutils.multiplexer(f=port_f, device="cpu", **opts)
    want = jutils.multiplexer(f=jax_f, **opts)
    strip = [{k: (v[:3] if k == "output" else v) for k, v in e.items()}
             for e in got]
    assert strip == [{k: (v[:3] if k == "output" else v) for k, v in e.items()}
                     for e in want]
    assert [sorted(e) for e in got] == [["a", "b", "output", "run"]] * 12
    for entries in (got, want):
        draws = {}
        for e in entries:
            draws.setdefault(e["run"], set()).add(e["output"][3])
        assert all(len(v) == 1 for v in draws.values())
        assert len({next(iter(v)) for v in draws.values()}) == 3
    with pytest.raises(ValueError):
        tutils.multiplexer(device="cpu")


def _peaked_weights(N):
    lw = 3.0 * np.random.default_rng(1).standard_normal(N)
    W = np.exp(lw - lw.max())
    return torch.tensor(W / W.sum(), dtype=torch.float32)


def _replicates(counts_fn, R, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([counts_fn(gen) for _ in range(R)]).double().numpy()


def test_tree_ssp_tv_matches_sequential():
    """Identical marginals: the mean TV(W, counts/N) over R replicates of
    the tree pairing and of the sequential one agree within 5 Monte Carlo
    standard errors of their difference (the JAX package's calibration at
    R = 400: difference -1.1e-4, standard error 1.0e-4)."""
    Nw, R = 1024, 300
    W = _peaked_weights(Nw)
    Wn = W.double().numpy()

    def tv(counts):
        return 0.5 * np.abs(counts / Nw - Wn).sum(1)

    tv_seq = tv(_replicates(lambda g: trs.ssp_counts(g, W, Nw), R, 5))
    tv_tree = tv(_replicates(lambda g: trs._ssp_counts_blocked(g, W, Nw), R,
                             6))
    se = np.sqrt(tv_seq.var(ddof=1) / R + tv_tree.var(ddof=1) / R)
    diff = tv_tree.mean() - tv_seq.mean()
    assert abs(diff) < 5 * se, (diff, se)


def test_tree_vs_sequential_joint_law():
    """Geometric weights: both pairings give count_i = floor(N w_i) +
    Bernoulli(frac_i), but the sequential one couples adjacent indices
    (negative adjacent covariance, near-deterministic window sums) and the
    tree couples strided block partners (adjacent covariance ~0, noisier
    window sums)."""
    Nw, R = 1024, 300
    Wg = 0.99 ** np.arange(Nw)
    Wg = torch.tensor(Wg / Wg.sum(), dtype=torch.float32)
    MW = Nw * Wg.double().numpy()
    p = MW - np.floor(MW)
    stats = {}
    for name, fn, seed in (
            ("seq", lambda g: trs.ssp_counts(g, Wg, Nw), 7),
            ("tree", lambda g: trs._ssp_counts_blocked(g, Wg, Nw), 8)):
        cs = _replicates(fn, R, seed)
        assert np.all(cs.sum(1) == Nw)
        assert np.all((cs >= np.floor(MW) - 1e-6) & (cs <= np.ceil(MW) + 1e-6))
        well = (p > 0.1) & (p < 0.9)
        v = cs.var(axis=0, ddof=1)
        rel = np.abs(v[well] - (p * (1 - p))[well]) / (p * (1 - p))[well]
        assert rel.mean() < 0.10, (name, rel.mean())
        assert rel.max() < 0.50, (name, rel.max())
        cov_adj = np.mean([np.cov(cs[:, i], cs[:, i + 1])[0, 1]
                           for i in range(256)])
        stats[name] = (cov_adj, cs[:, :64].sum(axis=1).var(ddof=1))
    assert stats["seq"][0] < -0.02, stats
    assert abs(stats["tree"][0]) < 0.01, stats
    assert stats["tree"][1] > 5 * stats["seq"][1], stats
