"""The cell ``stochvol-lev.smc2.n16.t256`` on the CPU at a small size: its
files are found by name, its judgement passes the sound program and fails
its bfloat16 control and each fault planted here, and its driver and
readers run on a program that records no SMC² spans or counters.

The faults, planted by ``monkeypatch`` (``faults.py`` registers none for
this driver; the same functions plant them at the cell's size on a card):

- ``rows_permuted``: row b of the inner filters runs θ_{π(b)}, π a shift
  by one row.  Its acceptance rate falls to 0.04-0.07 and the exchange
  step would double Nx at every move (100 to 12,800 by t = 11 at Ntheta
  = 1024 on the CPU), so this fault leaves the exchange step out;
- ``stale_replay``: the move's target keeps the old ``loglik`` (and inner
  filter) for the new θ;
- ``no_leverage``: phi dropped from the observation law;
- ``inner_half``: the likelihood increment taken over every other inner
  particle;
- ``multinomial``: multinomial resampling at the θ level where the mix
  says systematic;
- ``prior_narrow``: the prior's draws scaled by 0.8 (only ``prior_z``
  sees it; on the CPU it runs at :data:`FAULT_SIZE`'s Ntheta, where the
  shift stands out of the draws' noise as at the cell's size);
- ``stale_lpost``: the move's target replays the new θ's filter but
  takes its ``lpost`` from the old ``loglik``.  Its acceptance falls
  under the exchange's threshold, and at the cell's size the doubled
  filters fill the card, so this fault too leaves the exchange step out.
"""

import itertools
import math
import time

import pytest
import torch
from smcbench_helpers import find, run_small

from smcbench.lib import guard, program
from smcbench.lib.device import PEAKS
from smcbench.lib.harness import ReadContext, Setup
from smcbench.lib.trace import Spans, Tracer, parse_chrome_trace

CELL = "stochvol-lev.smc2.n16.t256"
SMALL = {"Ntheta": 1024, "T": 24, "trace_from": 4, "trace_steps": 2}
SEED = 31415926535


def _steady_clock(monkeypatch, tick=0.4):
    """A clock that advances ``tick`` s a reading: the driver reads it at the
    window's start and at each run's end, so that a 1 s window holds three
    runs (two checked resample-moves) however fast the machine is."""
    reading = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: tick * next(reading))


def _run(monkeypatch, **kw):
    _steady_clock(monkeypatch)
    return run_small(CELL, seed=SEED, seconds=1.0, params=SMALL, **kw)


def _failed(rows):
    return [name for name, value, limit in rows
            if value is None or not math.isfinite(value) or value > limit]


def test_cell_finds_its_files_and_imports_no_jax():
    cell = find(CELL)
    assert cell.config["name"] == "stochvol-lev" and cell.chips == 1
    assert cell.traffic["driver"] == "smc2_runs"
    for mod in (cell.driver, cell.model, cell.reference):
        assert mod is not None
    names = {m["name"] for m in cell.per_layer}
    assert {"replay_device_share", "smc2_step_mfu",
            "model_device_share"} <= names
    assert not guard.forbidden_modules()


@pytest.fixture(scope="module")
def sound():
    with pytest.MonkeyPatch.context() as mp:
        return _run(mp)


def test_sound_program_is_correct(sound):
    line, rows, info = sound
    assert line["correct"], rows
    assert info["runs"] == 3 and len(info["checked"]) == 4
    assert set(line["checks"]) == set(find(CELL).traffic["limits"])
    assert line["metrics"]["particle_steps_per_s"]["value"] > 0


def test_bfloat16_control_fails(monkeypatch):
    def engine(cell, inputs, device):
        return cell.reference.control_engine(cell.config, inputs, device)

    line, rows, _ = _run(monkeypatch, engine=engine)
    assert not line["correct"] and _failed(rows), rows


def _rows_permuted(monkeypatch):
    from particles_tpu_torch import inner_pf
    from particles_tpu_torch import smc_samplers as ssp

    orig = inner_pf.InnerPF.__init__

    def permuted(self, fk_cls, ssm_cls, data, theta, Nx, *args, **kwargs):
        theta = {k: torch.roll(v, 1, 0)
                 for k, v in theta.items()}
        orig(self, fk_cls, ssm_cls, data, theta, Nx, *args, **kwargs)

    monkeypatch.setattr(inner_pf.InnerPF, "__init__", permuted)
    monkeypatch.setattr(ssp.SMC2, "maybe_exchange", lambda self, smc: None)
    return {}


def _stale_replay(monkeypatch):
    from particles_tpu_torch import smc_samplers as ssp

    def stale(self, xx, gen=None):
        return xx.replace(lpost=self.fk.prior.logpdf(xx.theta) + xx.loglik)

    monkeypatch.setattr(ssp._ReplayTarget, "__call__", stale)
    return {}


def _no_leverage(monkeypatch):
    from particles_tpu_torch import state_space_models as ssms

    monkeypatch.setattr(ssms.StochVolLeverage, "PY", ssms.StochVol.PY)
    return {}


def _inner_half(monkeypatch):
    from particles_tpu_torch import inner_pf

    orig = inner_pf._rows

    def half(lw):
        W, ESS, _ = orig(lw)
        return W, ESS, orig(lw[:, ::2])[2]

    monkeypatch.setattr(inner_pf, "_rows", half)
    return {}


def _multinomial(monkeypatch):
    return {"resampling": "multinomial"}


def _prior_narrow(monkeypatch):
    from particles_tpu_torch import distributions as dists

    orig = dists.StructDist.rvs

    def narrow(self, gen, size=1):
        return {k: 0.8 * v for k, v in orig(self, gen, size).items()}

    monkeypatch.setattr(dists.StructDist, "rvs", narrow)
    return {}


def _stale_lpost(monkeypatch):
    from particles_tpu_torch import smc_samplers as ssp

    orig = ssp._ReplayTarget.__call__

    def stale(self, xx, gen=None):
        out = orig(self, xx, gen)
        return out.replace(lpost=self.fk.prior.logpdf(xx.theta) + xx.loglik)

    monkeypatch.setattr(ssp._ReplayTarget, "__call__", stale)
    monkeypatch.setattr(ssp.SMC2, "maybe_exchange", lambda self, smc: None)
    return {}


FAULTS = {"rows_permuted": _rows_permuted, "stale_replay": _stale_replay,
          "no_leverage": _no_leverage, "inner_half": _inner_half,
          "multinomial": _multinomial, "prior_narrow": _prior_narrow,
          "stale_lpost": _stale_lpost}
# the CPU size of a fault that only the prior's moments see: its z grows
# as sqrt(Ntheta), 13 at 1024 and about 100 at the cell's 2^16
FAULT_SIZE = {"prior_narrow": {"Ntheta": 4096, "T": 12}}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_fails(monkeypatch, fault):
    params = dict(SMALL, **FAULT_SIZE.get(fault, {}),
                  **FAULTS[fault](monkeypatch))
    _steady_clock(monkeypatch)
    line, rows, _ = run_small(CELL, seed=SEED, seconds=1.0, params=params)
    assert not line["correct"] and _failed(rows), rows


def _without_smc2_tracing(monkeypatch):
    """The program as it was before it counted and marked SMC²'s work: no
    ``smc2.*`` counter and no ``particles.smc2.*`` span."""
    from particles_tpu_torch import tracing

    count, span = tracing.count, tracing.span
    monkeypatch.setattr(tracing, "count", lambda name, n=1: None if
                        name.startswith("smc2.") else count(name, n))
    monkeypatch.setattr(tracing, "span", lambda name, **v: tracing.OFF if
                        name.startswith("smc2.") else span(name, **v))


def _traced_window():
    """The cell's driver over one traced window on the CPU: (its record,
    the trace, the readers' context)."""
    cell = find(CELL)
    mix = dict(cell.traffic["params"], **SMALL)
    dev = torch.device("cpu")
    state = cell.driver.setup(Setup(
        cell=cell, params=mix, inputs=cell.model.make_inputs(
            cell.config, mix, SEED), seed=SEED, device=dev,
        spans=Spans(torch, True)))
    tracer = Tracer(torch, dev)
    rec = cell.driver.window(state, 0.5, tracer)
    data = tracer.read()
    return rec, data, ReadContext(trace=data, work=rec.work, peaks=PEAKS)


def test_traced_window_counts_the_inner_work_and_marks_replays():
    """The stretch starts at a resample-move and holds its replays: the
    work counts their inner steps and particle-steps, and the program's
    replay spans are in the trace (the CPU trace has no device time, so
    the device shares read nothing here)."""
    rec, data, _ = _traced_window()
    w = rec.work
    assert w["kind"] == "smc2" and w["steps"] == SMALL["trace_steps"]
    assert w["rs_steps"] >= 1 and w["Nx"] == 100
    assert w["inner_steps"] > w["steps"]
    assert w["inner_particle_steps"] == w["inner_steps"] * SMALL[
        "Ntheta"] * w["Nx"]
    # θ (4 fields), loglik, lpost and the inner filter's xs and lws
    assert w["row_bytes"] == 4 * (4 + 2 + 2 * w["Nx"])
    replays = program.spans(data, "smc2.replay")
    assert len(replays) == 3 * w["rs_steps"]
    assert program.spans(data, "model")


def test_window_rate_counts_the_inner_particle_steps_it_ran():
    """The rate's count, taken from each run's schedule, equals the
    program's own counter over the window: forward steps, the moves'
    replays and, with the exchange forced after every resample-move, the
    exchanges' replays at the doubled Nx."""
    from particles_tpu_torch import tracing

    cell = find(CELL)
    mix = dict(cell.traffic["params"], Ntheta=128, T=12)
    state = cell.driver.setup(Setup(
        cell=cell, params=mix, inputs=cell.model.make_inputs(
            cell.config, mix, SEED), seed=SEED, device=torch.device("cpu"),
        spans=Spans(torch, False)))
    state.fk.ar_to_increase_Nx = 1.01
    before = tracing.counts().get("smc2.inner_particle_steps", 0)
    rec = cell.driver.window(state, 0.0, None)
    counted = tracing.counts()["smc2.inner_particle_steps"] - before
    assert rec.info["runs"] == 1 and state.fk.exchanges
    assert rec.info["inner_particle_steps"] == counted
    assert rec.e2e["particle_steps_per_s"] == pytest.approx(
        counted / rec.info["window_s"])


def test_driver_and_readers_run_without_smc2_tracing(monkeypatch):
    _without_smc2_tracing(monkeypatch)
    rec, data, ctx = _traced_window()
    assert rec.work["inner_steps"] == rec.work["inner_particle_steps"] == 0
    assert not program.spans(data, "smc2.replay")
    cell = find(CELL)
    for name in ("replay_device_share", "smc2_step_mfu"):
        assert cell.metric_reader(name).read(ctx) is None


def _event(name, ts, dur, cat, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


def test_replay_share_and_mfu_read_a_trace():
    """A kernel launched inside ``particles.smc2.replay`` counts to the
    replay share; the step's share of the peak is its bytes over the
    window."""
    data = parse_chrome_trace([
        _event("smcbench.window", 0, 1000, "user_annotation"),
        _event("particles.smc2.replay", 10, 300, "cpu_op"),
        _event("cudaLaunchKernel", 20, 5, "cuda_runtime", corr=1),
        _event("cudaLaunchKernel", 400, 5, "cuda_runtime", corr=2),
        _event("k_inner", 100, 300, "kernel", corr=1),
        _event("k_theta", 500, 100, "kernel", corr=2)])
    work = {"kind": "smc2", "Ntheta": 8, "steps": 2, "rs_steps": 1,
            "inner_steps": 3, "inner_particle_steps": 2400, "row_bytes": 8}
    ctx = ReadContext(trace=data, work=work, peaks=PEAKS)
    cell = find(CELL)
    assert cell.metric_reader("replay_device_share").read(
        ctx) == pytest.approx(75.0)
    need = 16 * 2400 + 2 * 8 * 8
    assert cell.metric_reader("smc2_step_mfu").read(ctx) == pytest.approx(
        100 * need / PEAKS["hbm_bytes_per_s"] / 1e-3)


def test_readers_give_none_where_nothing_was_counted():
    cell = find(CELL)

    class Empty:
        host_ops, device, launches = [], [], {}
        busy_s, window_s, t0, t1 = 1.0, 2.0, 0.0, 2e6

    work = {"kind": "smc2", "Ntheta": 8, "steps": 2, "rs_steps": 1,
            "inner_steps": 0, "inner_particle_steps": 0, "row_bytes": 8}
    ctx = ReadContext(trace=Empty(), work=work, peaks=PEAKS)
    for name in ("replay_device_share", "smc2_step_mfu"):
        assert cell.metric_reader(name).read(ctx) is None
    assert program.device_share(Empty(), "smc2.replay") is None


def test_reference_agrees_where_a_filter_vanished():
    """A θ row whose every inner weight vanished has loglik and lpost -inf
    in the program and the reference alike: that row agrees (0), where an
    infinity on one side only, or a value off, is an error."""
    ref = find(CELL).reference
    inf = float("inf")
    prog = torch.tensor([-inf, -1.5, 2.0])
    want = torch.tensor([-inf, -1.5, 2.0], dtype=torch.float64)
    assert ref._rel(prog, want) == 0.0
    assert ref._rel(prog, torch.tensor([0.0, -1.5, 2.0],
                                       dtype=torch.float64)) == inf
    assert ref._rel(prog, want + torch.tensor([0.0, 0.0, 3.0],
                                              dtype=torch.float64)) == 0.5


def test_reference_takes_either_decision_at_the_ess_threshold():
    """A row whose inner ESS before is the threshold itself (50 of 100 in
    float64) may have resampled or not in float32: the increment nearer
    the program's counts.  Away from the threshold the decision is the
    reference's own, and a program's increment of the other decision is
    an error."""
    ref = find(CELL).reference
    lw_at = torch.cat([torch.zeros(50), torch.full((50,), -math.inf)])
    lw_far = torch.ones(100)
    before = torch.stack([lw_at, lw_far]).double()
    after = torch.stack([torch.linspace(-1.0, 0.0, 100)] * 2).double()
    lm_after = ref.row_log_mean(after)
    prog = lm_after                       # both rows as if resampled
    inc = ref.increment_as_decided(before, after, 0.5, prog)
    assert float(ref.row_ess(before)[0]) == 50.0
    assert float(inc[0]) == pytest.approx(float(lm_after[0]))
    assert float(inc[1]) == pytest.approx(float(lm_after[1]) - 1.0)


def test_reference_prior_takes_the_float32_ends():
    ref = find(CELL).reference
    th = {"mu": torch.tensor([-1.0, -1.0]), "rho": torch.tensor([-0.99, 0.99]),
          "sigma": torch.tensor([0.3, 0.3]),
          "phi": torch.tensor([0.99, -0.991])}
    lp = ref.log_prior(th)
    assert math.isfinite(float(lp[0])) and float(lp[1]) == -math.inf
