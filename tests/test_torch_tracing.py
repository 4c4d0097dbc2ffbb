"""The port's spans and counters (``particles_tpu_torch.tracing``).

Without a profiler every span is the one shared null context.  Under
``torch.profiler`` a bootstrap filter and a waste-free adaptive tempering
sampler mark each step, each host read, the model's calls, the weights
and the exponent search, and every host read of a device value inside a
step (``aten::_local_scalar_dense``) lies inside a ``particles.sync.*``
span.  The host-read counters are the same with and without the
profiler, and so are the results, bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from particles_tpu_torch import collectors, kalman, tracing
from particles_tpu_torch import distributions as dists
from particles_tpu_torch import smc_samplers as ssp
from particles_tpu_torch import state_space_models as ssms
from particles_tpu_torch.core import SMC

T = 10
N = 1024
READ = "aten::_local_scalar_dense"


def _filter(seed=3):
    y = torch.from_numpy(
        np.random.default_rng(0).normal(size=T).astype(np.float32))
    fk = ssms.Bootstrap(ssm=kalman.LinearGauss(rho=0.9, sigmaX=1.0,
                                               sigmaY=0.2), data=y)
    return SMC(fk=fk, N=N, seed=seed, device="cpu",
               collect=[collectors.Moments()])


class GaussianMean(ssp.StaticModel):
    """y_t ~ N(mu, 1), mu ~ N(0, 3^2)."""

    def logpyt(self, theta, t):
        return dists.Normal(loc=theta["mu"], scale=1.0).logpdf(self.data[t])


def _sampler(seed=5):
    y = np.random.default_rng(1).normal(1.0, 1.0, size=100).astype(
        np.float32)
    model = GaussianMean(data=y, prior=dists.StructDist(
        {"mu": dists.Normal(scale=3.0)}), device="cpu")
    return SMC(fk=ssp.AdaptiveTempering(model=model, len_chain=4), N=64,
               seed=seed)


def _steps(pf):
    """Step ``pf`` until it stops; the number of ``next`` calls."""
    calls = 0
    while True:
        calls += 1
        try:
            next(pf)
        except StopIteration:
            return calls


def _profiled(tmp_path, fn):
    """``fn()`` under a CPU profiler: (its result, the host's operators
    and ranges as (name, start, end), sorted by start)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ops = sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events
                 if e.get("ph") == "X" and e.get("cat") == "cpu_op")
    return out, sorted(ops, key=lambda o: o[1])


def _named(ops, name):
    return [o for o in ops if o[0] == name]


def _inside(op, spans):
    """Whether ``op`` starts inside one of ``spans``."""
    return any(a <= op[1] <= b for _, a, b in spans)


def _within(spans, outer):
    """The items of ``spans`` that start inside the span ``outer``."""
    return [s for s in spans if outer[1] <= s[1] <= outer[2]]


def _every_read_marked(ops, steps):
    syncs = [o for o in ops if o[0].startswith("particles.sync.")]
    reads = [o for o in _named(ops, READ) if _inside(o, steps)]
    unmarked = [o for o in reads if not _inside(o, syncs)]
    assert reads and not unmarked, unmarked


def test_spans_are_one_null_context_without_a_profiler(monkeypatch):
    def entered(*args, **kwargs):
        raise AssertionError("a range was entered with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", entered)
    monkeypatch.setattr(torch.profiler, "record_function", entered)
    assert tracing.span("step", t=1) is tracing.OFF
    assert tracing.span("model") is tracing.OFF
    assert tracing.sync("decide") is tracing.OFF
    _filter().run()
    _steps(_sampler())


def test_counters_count_reset_and_copy():
    tracing.reset()
    tracing.count("launch.k")
    tracing.count("launch.k", 2)
    seen = tracing.counts()
    assert seen["launch.k"] == 3
    seen["launch.k"] = 0
    assert tracing.counts()["launch.k"] == 3
    tracing.reset()
    assert tracing.counts()["launch.k"] == 0


def test_filter_marks_each_step_read_model_and_weights(tmp_path):
    pf = _filter()
    _, ops = _profiled(tmp_path, lambda: [next(pf) for _ in range(T)])
    steps = _named(ops, "particles.step")
    assert len(steps) == T
    for t, step in enumerate(steps):
        decides = _within(_named(ops, "particles.sync.decide"), step)
        assert len(decides) == (t > 0), (t, decides)
        assert _within(_named(ops, "particles.model"), step)
        assert _within(_named(ops, "particles.weights"), step)
    for name in ("particles.model", "particles.weights"):
        assert all(_inside(o, steps) for o in _named(ops, name)), name
    _every_read_marked(ops, steps)


def test_sampler_marks_done_the_exponent_search_and_every_read(tmp_path):
    calls, ops = _profiled(tmp_path, lambda: _steps(_sampler()))
    steps = _named(ops, "particles.step")
    assert len(steps) == calls >= 4
    assert not _named(ops, "particles.sync.decide")   # always resamples
    for t, step in enumerate(steps):
        done = _within(_named(ops, "particles.sync.done"), step)
        search = _within(_named(ops, "particles.sampler.epn_search"), step)
        assert len(done) == (t > 0), (t, done)
        # step 0 chooses the first exponent too; the last call only reads
        # that the sampler is done
        moved = t < calls - 1
        assert len(search) == moved, (t, search)
        assert bool(_within(_named(ops, "particles.model"), step)) == moved
    _every_read_marked(ops, steps)


def _sync_counts(run):
    tracing.reset()
    run()
    return {k: v for k, v in tracing.counts().items()
            if k.startswith("sync.") and v}


@pytest.mark.parametrize("make", [_filter, _sampler],
                         ids=["filter", "sampler"])
def test_sync_counts_do_not_depend_on_the_profiler(tmp_path, make):
    plain = _sync_counts(lambda: _steps(make()))
    traced = _sync_counts(lambda: _profiled(tmp_path,
                                            lambda: _steps(make())))
    assert plain == traced and plain


def test_filter_counts_one_decision_a_step():
    assert _sync_counts(lambda: _filter().run()) == {"sync.decide": T - 1}


def test_results_are_bit_identical_with_the_profiler(tmp_path):
    def run():
        pf = _filter(seed=11)
        pf.run()
        return pf.logLt, torch.stack([m["mean"]
                                      for m in pf.summaries.moments])

    plain = run()
    traced, _ = _profiled(tmp_path, run)
    assert torch.equal(plain[0], traced[0])
    assert torch.equal(plain[1], traced[1])


def _smc2(T=8, ar=0.99):
    """A tiny SMC² of stochastic volatility with leverage; ``ar`` 0.99 makes
    the exchange step fire after every resample-move."""
    y = np.random.default_rng(2).normal(scale=0.5, size=T).astype(np.float32)
    prior = dists.StructDist({"mu": dists.Normal(loc=-1.0, scale=2.0),
                              "rho": dists.Uniform(a=-0.99, b=0.99),
                              "sigma": dists.Gamma(a=2.0, b=4.0),
                              "phi": dists.Uniform(a=-0.99, b=0.99)})
    fk = ssp.SMC2(ssm_cls=ssms.StochVolLeverage, prior=prior, data=y,
                  init_Nx=8, len_chain=3, ar_to_increase_Nx=ar, device="cpu")
    return SMC(fk=fk, N=64, seed=4, ESSrmin=0.9)


def _smc2_schedule(pf):
    """Step ``pf`` to its end: the resample-moves, and the inner steps and
    particle-steps its forward steps, replays and exchanges make, from its
    resample-moves, its exchanges and its Nx after each step."""
    fk, P = pf.fk, pf.fk.len_chain - 1
    moves = steps = parts = 0
    while True:
        n_exch = len(fk.exchanges)
        try:
            next(pf)
        except StopIteration:
            return moves, steps, parts
        t, B, Nx = pf.t - 1, pf.X.N, pf.X.xs.shape[1]
        moves += bool(pf.rs_flag)
        replays = P * t * bool(pf.rs_flag) + sum(
            e[0] for e in fk.exchanges[n_exch:])
        steps += 1 + replays
        parts += (1 + replays) * B * Nx


@pytest.fixture
def one_thread():
    """A small SMC² run is many small tensor ops: on one thread each, where
    a thread per core makes every op wait on the others beside other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_smc2_counts_inner_steps_replays_and_exchanges(one_thread):
    """``smc2.inner_steps`` is T plus the length of every replay, those of
    the moves and of the exchanges; ``smc2.inner_particle_steps`` the sum
    of B·Nx over them."""
    tracing.reset()
    pf = _smc2()
    moves, steps, parts = _smc2_schedule(pf)
    seen = tracing.counts()
    assert pf.fk.exchanges and seen["smc2.exchanges"] == len(
        pf.fk.exchanges)
    assert seen["smc2.inner_steps"] == steps
    assert seen["smc2.inner_particle_steps"] == parts
    assert seen["smc2.replays"] == (pf.fk.len_chain - 1) * moves + len(
        pf.fk.exchanges)


def test_smc2_marks_replays_the_model_and_exchanges(tmp_path, one_thread):
    """Under a profiler the move's replays are ``particles.smc2.replay``
    spans inside a step, each holding its inner steps and their calls into
    the model; an exchange's replay lies inside ``particles.smc2.exchange``."""
    pf = _smc2()
    _, ops = _profiled(tmp_path, lambda: _steps(pf))
    steps = _named(ops, "particles.step")
    replays = _named(ops, "particles.smc2.replay")
    inner = _named(ops, "particles.smc2.inner")
    model = _named(ops, "particles.model")
    exchanges = _named(ops, "particles.smc2.exchange")
    assert replays and exchanges and inner and model
    assert all(_inside(r, steps) for r in replays + exchanges)
    for r in replays:
        held = _within(inner, r)
        assert held and all(_within(model, s) for s in held)
    assert all(_within(replays, e) for e in exchanges)
    assert all(_inside(s, steps) for s in inner)
