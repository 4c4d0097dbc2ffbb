"""The port's particle-sharded filter on gloo CPU ranks, against the JAX
package's shard_map engine on the virtual CPU mesh, the Kalman oracles and
the port's single-device engine.

One module-scoped launch of D = 4 ranks runs every scenario of
``torch_dist_ranks.run_all`` (the rings over the 4 ranks and over a group
of two of them, every filter, scheme, collector and history, sharded
FFBS, the collective counts, the documented raises, distributed SQMC and
its sort, the sharded samplers, NS-SMC and SMC², PMMH's chains across the
ranks and the mesh entry points) and returns plain arrays, so that each
assertion below is its own test.  The inputs are numpy arrays made from
seeds; the JAX side runs in this process.

Tolerances.  The rings: bit for bit against JAX's on weights j 2^-12
(every float sum exact, so no summation order matters; the log-weights
JAX takes are chosen so that XLA's exp gives the weight back exactly);
on Dirichlet weights each output served exactly once (a valid ancestor,
sorted) and the z-forms within 1 of JAX's.  The filters: the mean logLt
of three seeds within the tolerances of ``tests/test_parallel.py`` of the
Kalman value, and within 0.6 of JAX's ``run_shardmap_smc`` at the same N,
D and T.  Distributed SQMC: its sort, keys and reorder equal JAX's
``parallel.dqmc`` bit for bit on the same arrays (the keys on points whose
sums are exact and which lie away from every cell boundary); its logLt
within JAX's tolerances (tests/test_parallel.py) of Kalman, and within
1e-3 of the port's single-device SQMC at the same seed.  The samplers:
the tolerances of ``TestShardedSamplers`` and ``TestShardedSMC2`` against
the exact evidence and the Kalman grid.
"""

import fcntl
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from particles_tpu import hilbert as jhilbert
from particles_tpu import kalman as jkalman
from particles_tpu import parallel as jparallel
from particles_tpu import state_space_models as jssms
from particles_tpu.parallel import distributed as jdist
from particles_tpu.parallel import dqmc as jdqmc

import torch_dist_ranks as ranks
from particles_tpu_torch import convert, hilbert, ops
from particles_tpu_torch import resampling as trs
from particles_tpu_torch import nested as tnested
from particles_tpu_torch import smc_samplers as tssp
from particles_tpu_torch import state_space_models as tssms
from particles_tpu_torch import kalman as tkalman
from particles_tpu_torch.core import SMC
from particles_tpu_torch import collectors as tcol
from particles_tpu_torch.parallel import dqmc as tdqmc
from particles_tpu_torch.parallel import launch

N, T = 4096, 25
N_SMOOTH, T_SMOOTH, M_SMOOTH = 2048, 20, 1600
ONE_HOT = (0, 700, N - 1)
RINGS = ("systematic", "stratified", "merge")
# the mean of three seeds against Kalman (tests/test_parallel.py:144-200)
KALMAN_TOL = {"Bootstrap": 0.6, "GuidedPF": 0.5, "AuxiliaryPF": 0.6,
              "AuxiliaryBootstrap": 0.6}
JAX_TOL = 0.6


def _simulate(rho, sigy, T, seed):
    """Observations of LinearGauss(rho, sigmaX=1, sigmaY=sigy) from a
    numpy seed, the state started at its stationary law."""
    rng = np.random.default_rng(seed)
    x = rng.normal() / np.sqrt(1.0 - rho * rho)
    y = np.empty(T)
    for t in range(T):
        if t:
            x = rho * x + rng.normal()
        y[t] = x + sigy * rng.normal()
    return y.astype(np.float32)


def _exact_weights(rng, n):
    """``(lw, w)``: weights ``w = j 2^-12`` (j in [1, 4096], one of them
    4096, so max lw = 0) and float32 log-weights whose exp in XLA is
    exactly ``w``; every partial sum of ``w`` is exact in float32."""
    js = np.arange(1, 4097)
    target = (js * 2.0 ** -12).astype(np.float32)
    base = np.log(js * 2.0 ** -12).astype(np.float32)
    lw_of = np.full(js.shape, np.nan, np.float32)
    up = down = base
    for _ in range(8):          # up to 8 ulps either side of log(w)
        for c in (up, down):
            hit = np.isnan(lw_of) & (np.asarray(jnp.exp(c)) == target)
            lw_of[hit] = c[hit]
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
    reachable = js[~np.isnan(lw_of)]
    assert 4096 in reachable and reachable.size > 3000, reachable.size
    j = rng.choice(reachable, n)
    j[rng.integers(n)] = 4096
    return lw_of[j - 1], (j * 2.0 ** -12).astype(np.float32)


def _exact_sum_points(n, seed=2):
    """(n, 2) float32 points k 2^-8, |k| <= 60, so that every sum of x
    and of x^2 over them is exact in float32 (the two packages' moments
    agree bit for bit); many points repeat, so that keys tie.  At n = N
    and this seed no point lies within 2^-12 of a cell's edge."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-60, 61, (n, 2)) * 2.0 ** -8).astype(np.float32)


def _conjugate(T=40):
    """The data and exact evidence of ``TestShardedSamplers``'s model."""
    rng = np.random.default_rng(0)
    y = rng.normal(loc=0.7, size=T).astype(np.float32)
    C = np.eye(T) + 4.0 * np.ones((T, T))
    yv = y.astype(np.float64)
    exact = (-0.5 * T * np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(C)[1]
             - 0.5 * yv @ np.linalg.solve(C, yv))
    return y, float(exact), 4.0 * float(yv.sum()) / (4.0 * T + 1.0)


def _lg_fixed_y(T):
    true = tkalman.LinearGauss(rho=0.8, sigmaX=1.0, sigmaY=0.5)
    return true.simulate(torch.Generator().manual_seed(0), T)[1].numpy()


def _inputs(engine, seed):
    rng = np.random.default_rng(seed)
    lw_exact, w_exact = _exact_weights(rng, N)
    g = rng.standard_gamma(1.0, N)
    w_dir = (g / g.sum()).astype(np.float32)
    key = jax.random.key(7)
    inp = {
        "x": rng.normal(size=N).astype(np.float32),
        "x2": rng.normal(size=(N, 2)).astype(np.float32),
        "u": np.float32(0.37),
        "w_exact": w_exact, "lw_exact": lw_exact,
        "w_dirichlet": w_dir, "lw_dirichlet": np.log(w_dir),
        "u_table": np.asarray(jdist._counter_uniforms(key,
                                                      jnp.arange(N))),
        "su": np.sort(rng.random(N)).astype(np.float32),
        "one_hot": ONE_HOT,
    }
    if engine:
        inp.update(
            y=_simulate(0.9, 0.2, T, 42), N=N,
            y_smooth=_simulate(0.9, 0.3, T_SMOOTH, 7), N_smooth=N_SMOOTH,
            M_smooth=M_SMOOTH, replicates=200,
            w_multi=trs.exp_and_normalise(torch.from_numpy(
                rng.normal(size=512).astype(np.float32) * 1.5)).numpy(),
            sort_keys=rng.integers(0, 50, N).astype(np.int32),
            sort_idx=np.arange(N, dtype=np.int32),
            sort_x=rng.normal(size=N).astype(np.float32),
            hx=_exact_sum_points(N),
            hlw=rng.normal(size=N).astype(np.float32),
            y_mv=tkalman.MVLinearGauss_Guarniero_etal(
                alpha=0.4, dx=3, device="cpu").simulate(
                    torch.Generator().manual_seed(7), 15)[1].numpy(),
            y_conj=_conjugate()[0], y_smc2=_lg_fixed_y(12),
            y_pmmh=_lg_fixed_y(25))
    return inp


def _join(results, get, axis=0):
    return convert.join_slices([get(r) for r in results], axis=axis)


def _jax_rings(inp, D):
    """JAX's three rings on the same arrays, all in one shard_map program:
    ``{name: (y, ..., A)}``."""
    mesh = jparallel.make_mesh(D, ("particles",))
    key = jax.random.key(7)
    u = jnp.float32(inp["u"])
    sh = P("particles")

    def local(x, x2, su, lw_exact, lw_dir, w_exact, w_dir):
        out = []
        for lw, w in ((lw_exact, w_exact), (lw_dir, w_dir)):
            y, A = jdist.ring_systematic_resample(
                {"a": x, "b": x2}, lw, u, N, "particles", D,
                return_ancestors=True)
            out += [y["a"], y["b"], A]
            y, A = jdist.ring_stratified_resample(
                {"a": x}, lw, key, N, "particles", D, return_ancestors=True)
            out += [y["a"], A]
            y, A = jdqmc.ring_merge_resample(
                {"a": x}, su, w, "particles", D, return_ancestors=True)
            out += [y["a"], A]
        return tuple(out)

    f = jdist._shard_map(local, mesh, in_specs=(sh,) * 7,
                         out_specs=(sh,) * 14)
    with mesh:
        out = [np.asarray(a) for a in jax.jit(f)(
            inp["x"], inp["x2"], inp["su"], inp["lw_exact"],
            inp["lw_dirichlet"], inp["w_exact"], inp["w_dirichlet"])]
    rings = {}
    for kind, o in (("exact", out[:7]), ("dirichlet", out[7:])):
        rings[f"systematic_{kind}"] = tuple(o[:3])
        rings[f"stratified_{kind}"] = tuple(o[3:5])
        rings[f"merge_{kind}"] = tuple(o[5:7])
    return rings


def _jax_dqmc(inp):
    """JAX's distributed sort, Hilbert keys and reorders on the same
    arrays, in one shard_map program over 4 devices."""
    D = 4
    mesh = jparallel.make_mesh(D, ("particles",))
    sh = P("particles")

    def local(k, idx, x, hx, hlw):
        (ks,), (ids, xs) = jdqmc.dist_sort_with((k,), (idx, x), "particles",
                                                D)
        keys = jdqmc._dist_hilbert_keys(hx, "particles", D)
        assert len(keys) == 1          # sort_nbits keeps d nbits <= 32
        X, (lw, ix) = jdqmc.dist_qmc_reorder(hx, (hlw, idx), "particles", D)
        X1, (ix1,) = jdqmc.dist_qmc_reorder(x, (idx,), "particles", D)
        return ks, ids, xs, keys[0], X, lw, ix, X1, ix1

    f = jdist._shard_map(local, mesh, in_specs=(sh,) * 5,
                         out_specs=(sh,) * 9)
    with mesh:
        out = [np.asarray(a) for a in jax.jit(f)(
            inp["sort_keys"], inp["sort_idx"], inp["sort_x"], inp["hx"],
            inp["hlw"])]
    return {"sort": tuple(out[:3]), "keys": out[3],
            "reorder": tuple(out[4:7]), "reorder_1d": tuple(out[7:])}


def _jax_filters(y):
    """JAX's ``run_shardmap_smc`` at the same N, D = 4 and T: logLt by
    filter."""
    ssm = jkalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    mesh = jparallel.make_mesh(4, ("particles",))
    return {name: float(jparallel.run_shardmap_smc(
        getattr(jssms, name)(ssm=ssm, data=jnp.asarray(y)), N=N,
        key=jax.random.key(0), mesh=mesh).logLt) for name in ranks.FILTERS}


def _scenarios():
    """The launch, run while this process computes the JAX side: ``{D:
    (inputs, the ranks' results)}`` for D = 4 and 2 (the rings over ranks
    0 and 1), ``"jax_rings"`` (by D) and ``"jax_filters"``."""
    inputs = {4: _inputs(engine=True, seed=0),
              2: _inputs(engine=False, seed=1)}
    with ThreadPoolExecutor(1) as pool:
        launched = pool.submit(launch.spawn, ranks.run_all, 4,
                               args=(inputs,), timeout=240)
        out = {"jax_rings": {D: _jax_rings(inputs[D], D) for D in inputs},
               "jax_filters": _jax_filters(inputs[4]["y"]),
               "jax_dqmc": _jax_dqmc(inputs[4])}
        results = launched.result()
    out[4] = (inputs[4], [dict(r, rings=r["rings"][4]) for r in results])
    out[2] = (inputs[2], [{"rings": r["rings"][2]} for r in results[:2]])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """:func:`_scenarios`, computed once per test run: under pytest-xdist
    the first worker to need it computes it under a file lock in the
    run's shared temporary directory and the others read its pickle."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None:
        return _scenarios()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"torch_distributed-{run}.pkl"
    with open(root / f"torch_distributed-{run}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return pickle.loads(path.read_bytes())
        out = _scenarios()
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(pickle.dumps(out))
        os.replace(tmp, path)
        return out


@pytest.fixture(scope="module")
def run4(runs):
    return runs[4]


@pytest.fixture(scope="module")
def jax_rings(runs):
    return runs["jax_rings"]


def _port_ring(results, name):
    k = len(results[0]["rings"][name])
    return tuple(_join(results, lambda r, i=i: r["rings"][name][i])
                 for i in range(k))


def _z_of(A, n):
    """The z-form of sorted ancestors: ``z_i = #{j: A_j <= i}``."""
    return np.searchsorted(A, np.arange(n), side="right")


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("ring", RINGS)
def test_ring_matches_jax_bit_for_bit_on_exact_weights(runs, jax_rings, D,
                                                       ring):
    got = _port_ring(runs[D][1], f"{ring}_exact")
    want = jax_rings[D][f"{ring}_exact"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.astype(g.dtype))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("ring", RINGS)
def test_ring_on_dirichlet_weights_serves_each_output_once(runs, jax_rings,
                                                           D, ring):
    inp, results = runs[D]
    y, A = (_port_ring(results, f"{ring}_dirichlet")[i] for i in (0, -1))
    assert A.min() >= 0 and A.max() < N          # every output served
    assert (np.diff(A) >= 0).all()               # sorted ancestors
    np.testing.assert_array_equal(y, inp["x"][A])
    A_jax = jax_rings[D][f"{ring}_dirichlet"][-1]
    assert np.abs(_z_of(A, N) - _z_of(A_jax, N)).max() <= 1


@pytest.mark.parametrize("D", [2, 4])
def test_ring_matches_single_device_z_form(runs, D):
    """The ring's served particles equal the port's single-device move by
    the z-form of the joined arrays: exactly where the sums are exact, and
    on Dirichlet weights within 1 of B1's z."""
    inp, results = runs[D]
    u = torch.tensor(inp["u"])
    for kind in ("exact", "dirichlet"):
        w = torch.from_numpy(inp[f"w_{kind}"])
        ya, yb, A = _port_ring(results, f"systematic_{kind}")
        if kind == "exact":
            cs = torch.cumsum(w, 0)
            z = (torch.floor(N * cs / cs[-1] - u).to(torch.int32) + 1
                 ).clamp_(0, N)
            z[-1:].fill_(N)
            (want_a, want_b), want_A = ops.repeat_cols(
                ops.running_max(z), N,
                [torch.from_numpy(inp["x"]), torch.from_numpy(inp["x2"])],
                want_anc=True)
            np.testing.assert_array_equal(ya, want_a.numpy())
            np.testing.assert_array_equal(yb, want_b.numpy())
            np.testing.assert_array_equal(A, want_A.numpy())
        else:
            z1 = ops.systematic_z_fused(w, u, N).numpy()
            assert np.abs(_z_of(A, N) - z1).max() <= 1


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("pos", ONE_HOT)
def test_ring_extreme_concentration(runs, D, pos):
    """All the weight on one particle: every output, on every rank, is
    that particle."""
    inp, results = runs[D]
    got = _join(results, lambda r: r["rings"][f"one_hot_{pos}"])
    assert (got == inp["x"][pos]).all()


# -- the engine at D = 4 ----------------------------------------------------

@pytest.fixture(scope="module")
def kalman_logLt(run4):
    ssm = jkalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    kf = jkalman.Kalman(ssm=ssm, data=jnp.asarray(run4[0]["y"]))
    kf.filter()
    return float(kf.logLt)


def _logLts(results, tag):
    vals = [r["engine"][tag]["logLt"] for r in results]
    assert len(set(vals)) == 1, vals        # replicated on every rank
    return vals[0]


@pytest.mark.parametrize("name", ranks.FILTERS)
def test_filter_matches_kalman_and_jax(runs, kalman_logLt, name):
    port = np.mean([_logLts(runs[4][1], f"{name}_{s}") for s in ranks.SEEDS])
    assert abs(port - kalman_logLt) < KALMAN_TOL[name], (port, kalman_logLt)
    jax_logLt = runs["jax_filters"][name]
    assert abs(port - jax_logLt) < JAX_TOL, (port, jax_logLt)


@pytest.mark.parametrize("name", ranks.FILTERS)
def test_filter_resampling_every_step_matches_kalman(run4, kalman_logLt,
                                                     name):
    """ESSrmin = 1: every step runs the ring (and an auxiliary filter's
    reset weights)."""
    results = run4[1]
    flags = results[0]["engine"][f"{name}_always"]["rs_flags"]
    assert flags[1:].all()
    assert abs(_logLts(results, f"{name}_always") - kalman_logLt) < 0.6


@pytest.mark.parametrize("scheme", ["stratified", "multinomial"])
def test_ring_schemes_match_kalman(run4, kalman_logLt, scheme):
    port = np.mean([_logLts(run4[1], f"{scheme}_{s}") for s in ranks.SEEDS])
    assert abs(port - kalman_logLt) < 0.6, (port, kalman_logLt)


def test_every_rank_takes_the_same_branches(run4):
    results = run4[1]
    for tag, rec in results[0]["engine"].items():
        for r in results[1:]:
            np.testing.assert_array_equal(r["engine"][tag]["rs_flags"],
                                          rec["rs_flags"], err_msg=tag)
            np.testing.assert_array_equal(r["engine"][tag]["ESSs"],
                                          rec["ESSs"], err_msg=tag)
    assert results[0]["engine"]["Bootstrap_0"]["rs_flags"].any()


def test_moments_are_the_global_moments(run4):
    """The last step's Moments equal the single-device weighted moments of
    the joined particles and weights, and the run's means agree with a
    single-device run of the port within Monte Carlo error."""
    inp, results = run4
    rec = results[0]["engine"]["moments"]
    for r in results[1:]:
        np.testing.assert_array_equal(r["engine"]["moments"]["mean"],
                                      rec["mean"])
    X = torch.from_numpy(_join(results, lambda r: r["engine"]["moments"]["X"]))
    lw = torch.from_numpy(
        _join(results, lambda r: r["engine"]["moments"]["lw"]))
    want = trs.wmean_and_var(trs.exp_and_normalise(lw), X)
    np.testing.assert_allclose(rec["mean"][-1], want["mean"].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rec["var"][-1], want["var"].numpy(),
                               rtol=1e-4, atol=1e-6)
    ssm = tkalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    pf = SMC(fk=tssms.Bootstrap(ssm=ssm, data=inp["y"], device="cpu"), N=N,
             seed=3, collect=[tcol.Moments()])
    pf.run()
    single = np.array([float(m["mean"]) for m in pf.summaries.moments])
    assert single.shape == rec["mean"].shape
    assert np.abs(rec["mean"] - single).max() < 0.25


def test_full_history_has_global_ancestors(run4):
    inp, results = run4
    A = _join(results, lambda r: r["engine"]["full"]["A"], axis=1)
    X = _join(results, lambda r: r["engine"]["full"]["X"], axis=1)
    lw = _join(results, lambda r: r["engine"]["full"]["lw"], axis=1)
    flags = results[0]["engine"]["full"]["rs_flags"]
    assert A.shape == X.shape == lw.shape == (T, N)
    assert A.min() >= 0 and A.max() < N
    ident = np.arange(N)
    np.testing.assert_array_equal(A[0], ident)
    for t in range(1, T):
        if flags[t]:
            assert (np.diff(A[t]) >= 0).all()       # sorted, global
            # ancestors cross the ranks' slices
            assert len(np.unique(A[t] // (N // 4))) > 1
        else:
            np.testing.assert_array_equal(A[t], ident)
    # the joined history feeds the single-device smoothers
    ssm = tkalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    fk = tssms.Bootstrap(ssm=ssm, data=inp["y"], device="cpu")
    hist = convert.history_from_numpy(fk, X, A, lw, device="cpu")
    paths = hist.backward_sampling_mcmc(torch.Generator().manual_seed(0), 8)
    assert paths.shape == (T, 8) and torch.isfinite(paths).all()


def test_rolling_and_partial_histories(run4):
    results = run4[1]
    for r in results:
        roll, part = r["engine"]["rolling"], r["engine"]["partial"]
        assert roll["T"] == 4 and roll["X"].shape == (4, N // 4)
        assert roll["A"].shape == (4, N // 4)
        assert roll["A"].min() >= 0 and roll["A"].max() < N    # global
        assert part["times"] == [t for t in range(T) if t % 5 == 0]
        assert part["X"].shape == (len(part["times"]), N // 4)


@pytest.mark.parametrize("case,match", [
    ("qmc_not_a_power_of_two",
     "NotImplementedError: .*power of two \\(got N=768\\)"),
    ("ssp", "NotImplementedError: .*resampling scheme 'ssp'"),
    ("collector", "NotImplementedError: .*Online_smooth_naive"),
    ("indivisible", "ValueError: N=514 not divisible"),
    ("sampler_ssp", "NotImplementedError: .*resampling scheme 'ssp'"),
    ("nchains", "ValueError: nchains=6 not divisible by mesh axis None "
                "size 4"),
])
def test_documented_raises(run4, case, match):
    import re

    for r in run4[1]:
        assert r["raises"][case] is not None, case
        assert re.search(match, r["raises"][case]), r["raises"][case]


# -- the collective budget (the port's tests/test_collective_budget.py) -----

def _calls(run4, tag):
    calls = [r["engine"][tag]["calls"] for r in run4[1]]
    assert all(c == calls[0] for c in calls)
    return calls[0]


def test_budget_without_resampling(run4):
    """A step that does not resample: two all-reduces (the weights' max
    and their fused pair of sums), no gather, no shift; T steps."""
    flags = run4[1][0]["engine"]["GuidedPF_0"]["rs_flags"]
    assert not flags.any()
    assert _calls(run4, "GuidedPF_0") == {
        "pmax": T, "psum": T, "all_gather": 0, "ring_shift": 0,
        "exchange": 0}


def test_budget_at_resampling_steps(run4):
    """A resampling step adds one (D,) all-gather and D - 1 shifts (D
    hops), and no all-reduce."""
    D = 4
    assert _calls(run4, "Bootstrap_always") == {
        "pmax": T, "psum": T, "all_gather": T - 1,
        "ring_shift": (D - 1) * (T - 1), "exchange": 0}


def test_budget_apf_adds_no_gather_or_shift(run4):
    """An auxiliary filter adds only its auxiliary weights' two
    all-reduces a step: its reset reuses their sums, and its ring moves
    the particles alone."""
    D = 4
    for name in ("AuxiliaryPF", "AuxiliaryBootstrap"):
        assert _calls(run4, f"{name}_always") == {
            "pmax": 2 * T - 1, "psum": 2 * T - 1, "all_gather": T - 1,
            "ring_shift": (D - 1) * (T - 1), "exchange": 0}, name


def test_budget_sharded_ffbs(run4):
    """L + 2 all-gathers a backward step (L = 1 leaf, lw_t, A_{t+1}), L + 1
    to start, and nothing else."""
    calls = [r["ffbs"]["calls"] for r in run4[1]]
    L = 1
    assert all(c == {"pmax": 0, "psum": 0,
                     "all_gather": (L + 1) + (T_SMOOTH - 1) * (L + 2),
                     "ring_shift": 0, "exchange": 0} for c in calls), calls


def test_sharded_ffbs_matches_kalman_and_single_device(run4):
    inp, results = run4
    paths = _join(results, lambda r: r["ffbs"]["paths"], axis=1)
    assert paths.shape == (T_SMOOTH, M_SMOOTH)
    ssm = jkalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.3)
    kf = jkalman.Kalman(ssm=ssm, data=jnp.asarray(inp["y_smooth"]))
    kf.smoother()
    exact = np.asarray(kf.smth.mean)[:, 0]
    exact_sd = np.sqrt(np.asarray(kf.smth.cov)[:, 0, 0])
    np.testing.assert_allclose(paths.mean(1), exact, atol=0.12)
    np.testing.assert_allclose(paths.std(1), exact_sd, atol=0.12)
    # the same history, joined, through the single-device pass
    tssm = tkalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.3)
    fk = tssms.Bootstrap(ssm=tssm, data=inp["y_smooth"], device="cpu")
    hist = convert.history_from_numpy(
        fk, *(_join(results, lambda r, k=k: r["ffbs"][k], axis=1)
              for k in ("X", "A", "lw")), device="cpu")
    single = hist.backward_sampling_mcmc(torch.Generator().manual_seed(3),
                                         M_SMOOTH, nsteps=2)
    np.testing.assert_allclose(paths.mean(1), single.mean(1).numpy(),
                               atol=0.15)


def test_multinomial_ring_is_unbiased(run4):
    """Mean offspring of each particle over 200 replicates ~ N W."""
    inp, results = run4
    counts = sum(r["multinomial_counts"].astype(np.int64) for r in results)
    R, n = counts.shape
    assert (counts.sum(1) == n).all()
    NW = n * inp["w_multi"].astype(np.float64)
    se = np.sqrt(np.maximum(NW, 0.05) / R)
    assert np.all(np.abs(counts.mean(0) - NW) < 6 * se + 0.1)


# -- distributed SQMC: the sort, the keys, the reorder -----------------------

@pytest.fixture(scope="module")
def jax_dqmc(runs):
    return runs["jax_dqmc"]


def _dqmc_part(results, name):
    k = len(results[0]["dqmc"][name])
    return tuple(_join(results, lambda r, i=i: r["dqmc"][name][i])
                 for i in range(k))


def test_dist_sort_matches_jax_and_one_stable_sort(run4, jax_dqmc):
    """Integer keys with many ties: the port's sorted keys and payloads
    equal JAX's bit for bit, and both are one stable sort of the global
    arrays."""
    inp, results = run4
    got = _dqmc_part(results, "sort")
    for g, w in zip(got, jax_dqmc["sort"]):
        np.testing.assert_array_equal(g, w)
    order = np.argsort(inp["sort_keys"], kind="stable")
    np.testing.assert_array_equal(got[0], inp["sort_keys"][order])
    np.testing.assert_array_equal(got[1], inp["sort_idx"][order])
    np.testing.assert_array_equal(got[2], inp["sort_x"][order])


def test_dist_sort_exchanges_once_a_paired_round(run4):
    """One exchange in each round a rank has a partner, and no other
    collective: ranks 0 and 3 sit out the odd rounds."""
    D = 4
    for d, r in enumerate(run4[1]):
        paired = sum(tdqmc._round_pairing(D, rd)[0][d] is not None
                     for rd in range(D))
        assert paired == (4 if d in (1, 2) else 2)
        assert r["dqmc"]["sort_calls"] == {
            "pmax": 0, "psum": 0, "all_gather": 0, "ring_shift": 0,
            "exchange": paired}, (d, r["dqmc"]["sort_calls"])


def test_dist_hilbert_keys_match_jax_and_single_device(run4, jax_dqmc):
    """The rank's keys: equal to JAX's one-word keys bit for bit (tied
    keys included), and to the single-device keys of the joined points
    on the same global mean and sd."""
    inp, results = run4
    hx = inp["hx"]
    keys = _join(results, lambda r: r["dqmc"]["keys"][0])
    m, sd = results[0]["dqmc"]["keys"][1:]
    for r in results[1:]:
        np.testing.assert_array_equal(r["dqmc"]["keys"][1], m)
        np.testing.assert_array_equal(r["dqmc"]["keys"][2], sd)
    # the moments are exact here, and no point lies near a cell boundary,
    # so the two packages' logistic values cannot fall in different cells
    nbits = hilbert.sort_nbits(N, 2)
    x64 = hx.astype(np.float64)
    g = (1 << nbits) / (1 + np.exp(-(x64 - x64.mean(0)) / x64.std(0)))
    assert np.abs(g - np.round(g)).min() > 2.0 ** (nbits - 20)
    np.testing.assert_array_equal(m, hx.mean(0, dtype=np.float64))
    assert len(np.unique(keys)) < N - 400           # many ties
    np.testing.assert_array_equal(keys, jax_dqmc["keys"].astype(np.int64))
    single = hilbert.hilbert_index(hilbert._integerise(
        torch.from_numpy(hx), torch.from_numpy(m), torch.from_numpy(sd),
        nbits), nbits).numpy()
    np.testing.assert_array_equal(keys, single)
    lo = jhilbert.hilbert_index(
        jhilbert._standardise_and_integerise(jnp.asarray(hx), nbits),
        nbits)[-1]
    np.testing.assert_array_equal(keys, np.asarray(lo).astype(np.int64))


@pytest.mark.parametrize("form", ["reorder", "reorder_1d"])
def test_dist_qmc_reorder_matches_jax(run4, jax_dqmc, form):
    got = _dqmc_part(run4[1], form)
    for g, w in zip(got, jax_dqmc[form]):
        np.testing.assert_array_equal(g, w.astype(g.dtype))


# -- distributed SQMC: the filter ---------------------------------------------

def _sqmc(run4, tag):
    recs = [r["sqmc"][tag] for r in run4[1]]
    assert len({rec["logLt"] for rec in recs}) == 1      # replicated
    return recs[0]


@pytest.mark.parametrize("name,tol", [("Bootstrap", 0.3), ("GuidedPF", 0.35),
                                      ("AuxiliaryPF", 0.35)])
def test_sqmc_matches_kalman(run4, kalman_logLt, name, tol):
    """tests/test_parallel.py's tolerances, on the mean of three seeds;
    every step resamples, on every rank alike."""
    recs = [_sqmc(run4, f"{name}_{s}") for s in ranks.SEEDS]
    port = np.mean([rec["logLt"] for rec in recs])
    assert abs(port - kalman_logLt) < tol, (port, kalman_logLt)
    for rec in recs:
        assert rec["rs_flags"][1:].all()
    for r in run4[1][1:]:
        np.testing.assert_array_equal(r["sqmc"][f"{name}_0"]["ESSs"],
                                      recs[0]["ESSs"])


def test_sqmc_is_the_single_device_sqmc(run4):
    """The same seed: the distributed run takes its rows of the same
    Sobol sets as the single-device run, so the two filters agree up to
    float association (tests/test_parallel.py::test_sqmc_matches_single_device)."""
    inp, _ = run4
    rec = _sqmc(run4, "same_seed")
    ssm = tkalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    pf = SMC(fk=tssms.Bootstrap(ssm=ssm, data=inp["y"], device="cpu"),
             N=ranks.SQMC_N, seed=11, qmc=True)
    pf.run()
    assert abs(rec["logLt"] - float(pf.logLt)) < 1e-3, (rec["logLt"],
                                                         float(pf.logLt))
    np.testing.assert_allclose(rec["ESSs"], pf.summaries.ESSs.numpy(),
                               rtol=1e-3)


def test_sqmc_collective_budget(run4):
    """A step: the weights' max and sums twice (before and after the
    move), the merge ring's all-gather and D - 1 shifts, and the Hilbert
    sort's exchanges (one a paired round, D rounds a sort, one sort a
    step); step 0 one pair of all-reduces and one sort."""
    D, T_ = 4, T
    for d, r in enumerate(run4[1]):
        paired = 4 if d in (1, 2) else 2
        assert r["sqmc"]["Bootstrap_0"]["calls"] == {
            "pmax": 2 * T_ - 1, "psum": 2 * T_ - 1, "all_gather": T_ - 1,
            "ring_shift": (D - 1) * (T_ - 1), "exchange": paired * T_}


def test_sqmc_history_global_genealogy(run4):
    """tests/test_parallel.py::test_sqmc_history_global_genealogy: global
    ancestors, Hilbert-ordered frames, and the joined history feeds both
    FFBS-MCMC and QMC FFBS."""
    inp, results = run4
    h = [r["sqmc"]["hist"] for r in results]
    assert all(x["hilbert_ordered"] for x in h)
    X, A, lw = (_join(results, lambda r, k=k: r["sqmc"]["hist"][k], axis=1)
                for k in ("X", "A", "lw"))
    assert A.shape == (T, ranks.SQMC_N) and A.min() >= 0
    assert A.max() < ranks.SQMC_N
    for t in range(T):
        assert (np.diff(X[t]) >= 0).all()       # 1-d: the global order
    ssm = tkalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    fk = tssms.Bootstrap(ssm=ssm, data=inp["y"], device="cpu")
    hist = convert.history_from_numpy(fk, X, A, lw, device="cpu")
    hist.hilbert_ordered = True
    gen = torch.Generator().manual_seed(0)
    assert torch.isfinite(hist.backward_sampling_mcmc(gen, 4)).all()
    assert torch.isfinite(hist.backward_sampling_qmc(gen, 4)).all()


def test_sqmc_multivariate_matches_kalman(run4):
    """d = 3: the distributed Hilbert keys (one fused all-reduce of the
    moments, then the odd-even merge) against the exact evidence."""
    inp, results = run4
    mv = tkalman.MVLinearGauss_Guarniero_etal(alpha=0.4, dx=3, device="cpu")
    kf = tkalman.Kalman(ssm=mv, data=torch.from_numpy(inp["y_mv"]).double())
    rec = _sqmc(run4, "mv")
    assert abs(rec["logLt"] - float(kf.logLt)) < 0.5, (rec["logLt"],
                                                       float(kf.logLt))
    assert results[0]["sqmc"]["mv"]["X"].shape == (ranks.SQMC_N // 4, 3)


# -- the sharded samplers, NS-SMC and SMC² ------------------------------------

def _samplers(run4, tag):
    recs = [r["samplers"][tag] for r in run4[1]]
    for rec in recs[1:]:
        for k in ("logLt", "log_evid", "T"):
            if k in rec:
                assert rec[k] == recs[0][k], (tag, k)
    return recs[0]


def test_sharded_ibis_matches_exact_evidence_and_collectors(run4):
    """TestShardedSamplers.test_ibis_matches_exact_evidence_and_collectors:
    Moments global, a host-side collector and the history on the
    gathered particles, the rank's own slice returned."""
    _, exact, post_mean = _conjugate()
    rec = _samplers(run4, "ibis")
    assert abs(rec["logLt"] - exact) < 1.0, (rec["logLt"], exact)
    assert abs(rec["mean"] - post_mean) < 0.2, (rec["mean"], post_mean)
    assert rec["hist_T"] == 40 and len(rec["ESSs"]) == 40
    assert rec["hist_N"] == 10 * ranks.SAMPLER_N          # global N0
    assert rec["X_N"] == 10 * ranks.SAMPLER_N // 4       # the rank's
    assert len(rec["var_logLt"]) == 40
    assert np.isfinite(np.asarray(rec["var_logLt"], np.float64)).all()


def test_sharded_adaptive_tempering_matches_exact_evidence(run4):
    _, exact, _ = _conjugate()
    recs = [_samplers(run4, f"tempering_{s}") for s in ranks.SEEDS]
    assert abs(np.mean([r["logLt"] for r in recs]) - exact) < 0.8
    assert all(r["exponent"] >= 1.0 for r in recs)
    # the step count of the single-device engine
    inp = run4[0]
    model = ranks.GaussTarget(data=inp["y_conj"], prior=ranks.dists.StructDist(
        {"m": ranks.dists.Normal(scale=2.0)}), device="cpu")
    pf = SMC(fk=tssp.AdaptiveTempering(model=model, len_chain=10),
             N=ranks.SAMPLER_N, seed=0)
    pf.run()
    steps = [r["T"] for r in recs]
    assert pf.t in steps or abs(pf.t - steps[0]) <= 1, (pf.t, steps)


@pytest.mark.parametrize("scheme", ["stratified", "multinomial"])
def test_sharded_sampler_rings(run4, scheme):
    _, exact, _ = _conjugate()
    rec = _samplers(run4, f"tempering_{scheme}")
    assert abs(rec["logLt"] - exact) < 1.2, (scheme, rec["logLt"], exact)


def test_sharded_ns_smc_matches_exact_evidence(run4):
    """NS-SMC's level and evidence on one gathered llik: the mean of three
    seeds within 1.0 of exact, a level count near the single device's."""
    _, exact, _ = _conjugate()
    recs = [_samplers(run4, f"ns_{s}") for s in ranks.SEEDS]
    assert abs(np.mean([r["log_evid"] for r in recs]) - exact) < 1.0
    assert all(np.isinf(r["lt"]) for r in recs)
    inp = run4[0]
    model = ranks.GaussTarget(data=inp["y_conj"], prior=ranks.dists.StructDist(
        {"m": ranks.dists.Normal(scale=2.0)}), device="cpu")
    pf = SMC(fk=tnested.NestedSamplingSMC(model=model, len_chain=5,
                                          ESSrmin=0.3, eps=0.01),
             N=ranks.SAMPLER_N, seed=0)
    pf.run()
    steps = np.mean([r["T"] for r in recs])
    assert abs(pf.t - steps) <= max(3, 0.3 * pf.t), (pf.t, steps)


@pytest.fixture(scope="module")
def smc2_oracle(run4):
    """The Kalman grid evidence and posterior mean of rho at T = 12."""
    from scipy.special import logsumexp

    y = run4[0]["y_smc2"]
    grid = np.linspace(-0.985, 0.985, 80)
    lls = np.array([float(tkalman.Kalman(
        ssm=ranks.LGfixed(rho=float(r)), data=torch.from_numpy(y).double()
    ).logLt) for r in grid])
    ev = logsumexp(lls) + np.log((grid[1] - grid[0]) / (2 * 0.99))
    post = np.exp(lls - lls.max())
    return float(ev), float(np.sum(post * grid) / post.sum())


def test_sharded_smc2_matches_the_kalman_grid(run4, smc2_oracle):
    """TestShardedSMC2: the θ axis sharded, each rank's inner filters its
    own; 4 seeds, the mean evidence within 0.4 and the posterior mean
    within 0.25 of the grid."""
    exact_ev, exact_mean = smc2_oracle
    results = run4[1]
    lls, means = [], []
    for s in range(4):
        rec = _samplers(run4, f"smc2_{s}")
        assert rec["T"] == 12
        assert rec["xs"] == (ranks.SMC2_NTHETA // 4, ranks.SMC2_NX)
        lw = _join(results, lambda r, s=s: r["samplers"][f"smc2_{s}"]["lw"])
        rho = _join(results, lambda r, s=s: r["samplers"][f"smc2_{s}"]["rho"])
        W = np.exp(lw - lw.max())
        lls.append(rec["logLt"])
        means.append(float(np.sum(W * rho) / W.sum()))
    assert abs(np.mean(lls) - exact_ev) < 0.4, (np.mean(lls), exact_ev)
    assert abs(np.mean(means) - exact_mean) < 0.25, (means, exact_mean)


# -- chains across ranks --------------------------------------------------------

def test_pmmh_chains_across_ranks(run4):
    """The 8 chains split 2 a rank; every rank ends with the whole chain,
    whose pooled mean lies within 0.15 of the Kalman grid posterior mean
    (the single-device chains' test, tests/test_torch_mcmc.py)."""
    y = run4[0]["y_pmmh"]
    results = run4[1]
    rho = results[0]["chains"]["rho"]
    assert rho.shape == (ranks.PMMH_NITER, ranks.PMMH_CHAINS)
    for r in results[1:]:
        np.testing.assert_array_equal(r["chains"]["rho"], rho)
        np.testing.assert_array_equal(r["chains"]["nacc"],
                                      results[0]["chains"]["nacc"])
    grid = np.linspace(-0.985, 0.985, 100)
    lls = np.array([float(tkalman.Kalman(
        ssm=ranks.LGfixed(rho=float(g)), data=torch.from_numpy(y).double()
    ).logLt) for g in grid])
    post = np.exp(lls - lls.max())
    post /= post.sum()
    post_mean = float(np.sum(post * grid))
    post_sd = float(np.sqrt(np.sum(post * grid ** 2) - post_mean ** 2))
    pooled = rho[50:].ravel()
    assert abs(pooled.mean() - post_mean) < 0.15, (pooled.mean(), post_mean)
    assert 0.3 < pooled.std() / post_sd < 3.0
    assert (results[0]["chains"]["nacc"] > 10).all()
    # the ranks' chains start apart: each rank draws from its own stream
    assert len({float(v) for v in rho[0]}) == ranks.PMMH_CHAINS


# -- the mesh entry points ------------------------------------------------------

def _meshes(run4, tag):
    recs = [r["meshes"][tag] for r in run4[1]]
    assert len({rec["logLt"] for rec in recs}) == 1
    return recs[0]


@pytest.mark.parametrize("scheme", ["ssp", "residual", "killing"])
def test_run_sharded_smc_schemes_without_a_ring(run4, kalman_logLt, scheme):
    """A (1, 4) mesh: the scheme's z-form of the gathered weights on every
    rank, then the z ring; within 0.6 of Kalman, the ancestors global
    and sorted, and one all-gather and D - 1 shifts a resampling step."""
    D = 4
    seeds = ranks.SEEDS if scheme == "ssp" else (0,)
    port = np.mean([_meshes(run4, f"{scheme}_{s}")["logLt"] for s in seeds])
    assert abs(port - kalman_logLt) < 0.6, (scheme, port, kalman_logLt)
    rec = _meshes(run4, f"{scheme}_0")
    n_rs = int(rec["rs_flags"].sum())
    assert n_rs > 0
    assert rec["calls"] == {"pmax": T, "psum": T, "all_gather": n_rs,
                            "ring_shift": (D - 1) * n_rs, "exchange": 0}
    A = _join(run4[1], lambda r: r["meshes"][f"{scheme}_0"]["A"], axis=1)
    assert A.shape == (T, N) and A.min() >= 0 and A.max() < N
    for t in np.flatnonzero(rec["rs_flags"]):
        assert (np.diff(A[t]) >= 0).all()


def test_run_sharded_smc_qmc(run4, kalman_logLt):
    vals = {r["meshes"]["qmc"] for r in run4[1]}
    assert len(vals) == 1
    assert abs(vals.pop() - kalman_logLt) < 0.3


def test_run_sharded_multismc_on_a_2x2_mesh(run4, kalman_logLt):
    """Rows of the mesh take two runs each, each over the row's two
    ranks: the (4,) logLts on every rank, each rank's (2, N/2) block of
    log-weights."""
    results = run4[1]
    logLts = results[0]["meshes"]["multi"]["logLts"]
    assert logLts.shape == (4,) and len(set(logLts.tolist())) == 4
    for r in results:
        np.testing.assert_array_equal(r["meshes"]["multi"]["logLts"],
                                      logLts)
        assert r["meshes"]["multi"]["lws"].shape == (2, N // 2)
    assert np.abs(logLts - kalman_logLt).max() < 1.0, logLts


def test_particle_constrain_keeps_the_slices(run4):
    assert all(r["meshes"]["constrain"] for r in run4[1])
