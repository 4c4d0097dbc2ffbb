"""The port's particle-sharded filter on gloo CPU ranks, against the JAX
package's shard_map engine on the virtual CPU mesh, the Kalman oracles and
the port's single-device engine.

One module-scoped launch of D = 4 ranks runs every scenario of
``torch_dist_ranks.run_all`` (the rings over the 4 ranks and over a group
of two of them, every filter, scheme, collector and history, sharded
FFBS, the collective counts and the documented raises) and returns plain
arrays, so that each assertion below is its own test.  The inputs are numpy arrays made from
seeds; the JAX side runs in this process.

Tolerances.  The rings: bit for bit against JAX's on weights j 2^-12
(every float sum exact, so no summation order matters; the log-weights
JAX takes are chosen so that XLA's exp gives the weight back exactly);
on Dirichlet weights each output served exactly once (a valid ancestor,
sorted) and the z-forms within 1 of JAX's.  The filters: the mean logLt
of three seeds within the tolerances of ``tests/test_parallel.py`` of the
Kalman value, and within 0.6 of JAX's ``run_shardmap_smc`` at the same N,
D and T.
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

from particles_tpu import kalman as jkalman
from particles_tpu import parallel as jparallel
from particles_tpu import state_space_models as jssms
from particles_tpu.parallel import distributed as jdist
from particles_tpu.parallel import dqmc as jdqmc

import torch_dist_ranks as ranks
from particles_tpu_torch import convert, ops
from particles_tpu_torch import resampling as trs
from particles_tpu_torch import state_space_models as tssms
from particles_tpu_torch import kalman as tkalman
from particles_tpu_torch.core import SMC
from particles_tpu_torch import collectors as tcol
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
                rng.normal(size=512).astype(np.float32) * 1.5)).numpy())
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
               "jax_filters": _jax_filters(inputs[4]["y"])}
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
    ("qmc", "NotImplementedError: .*A.11b"),
    ("ssp", "NotImplementedError: .*resampling scheme 'ssp'"),
    ("collector", "NotImplementedError: .*Online_smooth_naive"),
    ("indivisible", "ValueError: N=514 not divisible"),
    ("sampler", "NotImplementedError: .*samplers.*A.11b"),
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
        "pmax": T, "psum": T, "all_gather": 0, "ring_shift": 0}


def test_budget_at_resampling_steps(run4):
    """A resampling step adds one (D,) all-gather and D - 1 shifts (D
    hops), and no all-reduce."""
    D = 4
    assert _calls(run4, "Bootstrap_always") == {
        "pmax": T, "psum": T, "all_gather": T - 1,
        "ring_shift": (D - 1) * (T - 1)}


def test_budget_apf_adds_no_gather_or_shift(run4):
    """An auxiliary filter adds only its auxiliary weights' two
    all-reduces a step: its reset reuses their sums, and its ring moves
    the particles alone."""
    D = 4
    for name in ("AuxiliaryPF", "AuxiliaryBootstrap"):
        assert _calls(run4, f"{name}_always") == {
            "pmax": 2 * T - 1, "psum": 2 * T - 1, "all_gather": T - 1,
            "ring_shift": (D - 1) * (T - 1)}, name


def test_budget_sharded_ffbs(run4):
    """L + 2 all-gathers a backward step (L = 1 leaf, lw_t, A_{t+1}), L + 1
    to start, and nothing else."""
    calls = [r["ffbs"]["calls"] for r in run4[1]]
    L = 1
    assert all(c == {"pmax": 0, "psum": 0,
                     "all_gather": (L + 1) + (T_SMOOTH - 1) * (L + 2),
                     "ring_shift": 0} for c in calls), calls


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
