"""Whole SMC² runs back to back: the throughput of a posterior over θ
whose likelihood each θ-particle estimates with a particle filter of its
own.

Each run is a new ``SMC(fk=..., N=Ntheta)`` of the model file's ``SMC2``,
seeded from ``--seed`` and the run's index, stepped to the end of its
``T`` observations.  The rate counts inner particle-steps: Ntheta·Nx for
each inner step of every θ-particle's filter, forward (step 0's start
too), in a resample-move's replays and in an exchange's replay, so that
a run with one resample-move more counts the work it did (the moves'
replays take most of the device time, and their number moves with the
seed).  They are counted from the run's schedule
(:func:`inner_particle_steps`), the same on a program without the
``smc2`` counters.  The window counts every step of every run it holds
and ends at the end of the first run that finishes after ``seconds``, so
that no run is cut; its clock stops after the device finishes.  Set-up warms one run up to and
including its first resample-move.

The reference follows the program from its own state on a few steps: the
driver keeps, as references (no copy in the window), the particle system
before the step and after it, and at a resample-move the θ-particles the
resampling picked, which the move starts from (the move is wrapped to keep
them).  It keeps step 0 and the last step of the window's first run, and
in the second and third runs the first resample-move at or after a step
drawn from the seed in [1, T - 1] (a run with none there gives its last
resample-move, so that every window of three runs checks a resample).

The traced stretch: ``trace_steps`` steps from the first resample-move at
or after step ``trace_from`` of the first run (read ahead from the θ
weights' ESS, one host read a step from ``trace_from`` on in a traced run
only); a traced window stays open until the stretch is traced.  ``work``
gives the per-layer readers the stretch's steps, resample-moves, inner
steps and inner particle-steps (the deltas of the program's counters
``smc2.inner_steps`` and ``smc2.inner_particle_steps``: 0 in a program
without them, and the readers then return None) and the bytes of one
θ-particle's row.

A control's engine (``reference/<config>.py``'s ``control_engine``) is
the inner filters' factory ``engine(theta, Nx)`` put in the place of the
program's ``SMC2._inner``: the program's outer loop runs over the
reference's own filters.

Mix parameters: ``Ntheta``, ``T``, ``ESSrmin``, ``resampling`` (the θ
level), ``trace_from`` and ``trace_steps``.
"""

from __future__ import annotations

import time

import numpy as np

from smcbench.lib.harness import Record, State, rng, run_seed, sync


class KeepStart:
    """The program's move, keeping a reference to the θ-particles each
    call starts from (the resampled system of a resample-move)."""

    def __init__(self, move):
        self.move = move
        self.start = None

    @property
    def nsteps(self):
        return self.move.nsteps

    def calibrate(self, W, x):
        return self.move.calibrate(W, x)

    def __call__(self, gen, x, target, draws=None):
        self.start = x
        return self.move(gen, x, target, draws=draws)


class PortSMC2Run:
    """One run of the program's SMC²."""

    def __init__(self, fk, Ntheta, seed, params, device):
        from particles_tpu_torch import SMC

        self.fk = fk
        self.pf = SMC(fk=fk, N=Ntheta, seed=seed,
                      resampling=params["resampling"],
                      ESSrmin=params["ESSrmin"])

    @property
    def t(self):
        return self.pf.t

    def state(self):
        """What the reference reads of the system after the last step."""
        pf = self.pf
        rs = bool(pf.rs_flag)
        return {"X": pf.X, "lw": pf.wgts.lw, "loglt": pf.loglt, "rs": rs,
                "start": self.fk.move.start if rs else None}

    def will_resample(self):
        """Whether the next step resamples: the step's own decision, read
        ahead from the θ weights (a host read)."""
        pf = self.pf
        return pf.t > 0 and bool(pf.wgts.ESS < pf.N * pf.ESSrmin)

    def step(self):
        """One step: its inner particle-steps, 0 once the run is done (no
        step taken)."""
        pf, t, ex = self.pf, self.pf.t, len(self.fk.exchanges)
        try:
            next(pf)
        except StopIteration:
            return 0
        return inner_particle_steps(self.fk, pf, t, ex)

    def finish(self):
        """The log-evidence after each step, a device tensor, with no host
        read; the run can then be dropped."""
        import torch

        return torch.stack([v.reshape(()) for v in self.pf.summaries.logLts])


def inner_particle_steps(fk, pf, t, n_exchanges):
    """The inner particle-steps of step ``t``, just taken by ``pf``: rows
    times Nx for each inner step.  One forward step (at t = 0 the filters'
    start); at t >= 1 also the exchange's replay over 0..t-1 at the
    doubled Nx, where one came first (``fk.exchanges`` past
    ``n_exchanges``), and at a resample-move the move's ``nsteps``
    replays over 0..t-1."""
    rows, Nx = pf.X.xs.shape[:2]
    steps = 1
    if t > 0:
        steps += t * len(fk.exchanges[n_exchanges:])
        if pf.rs_flag:
            steps += t * fk.move.nsteps
    return int(rows) * int(Nx) * steps


def _counters():
    from particles_tpu_torch import tracing

    c = tracing.counts()
    return (c.get("smc2.inner_steps", 0),
            c.get("smc2.inner_particle_steps", 0))


def row_bytes(X):
    """The bytes of one θ-particle's row: every per-particle leaf."""
    leaves, _ = X._leaves()
    return sum(a.element_size() * (a.numel() // a.shape[0]) for a in leaves)


def setup(s):
    p = s.params
    fk = s.cell.model.make_fk(s.cell.config, p, s.inputs, s.device, s.spans)
    fk.move = KeepStart(fk.move)
    if s.engine is not None:
        fk._inner = s.engine
    warm = PortSMC2Run(fk, p["Ntheta"], run_seed(s.seed, 0), p, s.device)
    while warm.step() and not (warm.t > 1 and warm.pf.rs_flag):
        pass
    warm.finish()
    return State(fk=fk, make=PortSMC2Run, params=p, seed=s.seed,
                 device=s.device, spans=s.spans, config=s.cell.config)


def check_steps(seed, T, runs=(1, 2)):
    """{run: t} of the steps from which ``runs`` keep their first
    resample-move, each drawn from [1, T - 1]."""
    ks = rng(seed, 2).integers(1, T, size=len(runs))
    return {r: int(k) for r, k in zip(runs, ks)}


def window(state, seconds, tracer):
    import torch

    p, spans = state.params, state.spans
    T, Ntheta = p["T"], p["Ntheta"]
    owed = check_steps(state.seed, T)    # run -> the step it keeps from
    finished, checks, pending = [], [], None
    steps = inner = traced = traced_rs = 0
    tracing, work = False, {}
    run = None
    sync(torch, state.device)
    t0 = time.perf_counter()
    while True:
        if run is None:
            with spans("new_run"):
                run = state.make(state.fk, Ntheta,
                                 run_seed(state.seed, 1, len(finished)), p,
                                 state.device)
        r, t = len(finished), run.t
        keeps = r == 0 or r in owed
        before = run.state() if keeps and t > 0 else None
        if (tracer is not None and not tracing and not traced and r == 0
                and t >= p["trace_from"] and run.will_resample()):
            sync(torch, state.device)
            t_trace = time.perf_counter()
            c0 = _counters()
            tracer.start()
            tracing = True
        with spans("step"):
            stepped = run.step()
        inner += stepped
        if not stepped:
            with spans("new_run"):
                finished.append(run.finish())
                run = None
            if (not tracing and (tracer is None or traced)
                    and time.perf_counter() - t0 >= seconds):
                break
            continue
        steps += 1
        if keeps:
            kept = {"run": r, "t": t, "before": before,
                    "after": run.state()}
            if r == 0:
                if t == 0 or run.t == T:
                    checks.append(kept)
            elif kept["after"]["rs"] and t >= owed[r]:
                checks.append(kept)
                del owed[r]
                pending = None
            elif kept["after"]["rs"]:
                pending = kept
            elif run.t == T:
                # no resample-move at or after the drawn step: the run's
                # last one
                checks.append(pending or kept)
                del owed[r]
                pending = None
        if tracing:
            traced += 1
            traced_rs += bool(run.pf.rs_flag)
            if traced == p["trace_steps"]:
                tracer.stop()
                c1 = _counters()
                work = {"Nx": int(run.pf.X.xs.shape[1]),
                        "row_bytes": row_bytes(run.pf.X),
                        "inner_steps": c1[0] - c0[0],
                        "inner_particle_steps": c1[1] - c0[1]}
                t0 += time.perf_counter() - t_trace
                tracing = False
    sync(torch, state.device)
    elapsed = time.perf_counter() - t0
    failed = sum(int(np.sum(~np.isfinite(v.double().cpu().numpy())))
                 for v in finished)
    return Record(
        e2e={"particle_steps_per_s": inner / elapsed},
        attempted=steps, failed=failed,
        info={"steps": steps, "inner_particle_steps": inner,
              "runs": len(finished), "window_s": elapsed,
              "checked": [(c["run"], c["t"]) for c in checks]},
        outputs={"Ntheta": Ntheta, "T": T, "checks": checks,
                 "seed": state.seed},
        work={"kind": "smc2", "Ntheta": Ntheta, "steps": traced,
              "rs_steps": traced_rs, **work})
