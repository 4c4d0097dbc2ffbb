"""Whole SMC-sampler runs back to back: the throughput of a posterior and
its evidence.

Each run is a new ``SMC(fk=..., N=M)`` (the model file's sampler, here
waste-free adaptive tempering: N0 = M·P particles), seeded from
``--seed`` and the run's index, stepped until the sampler is done.  A
step counts N0 particle-steps, step 0 too; the window counts every
completed step and stops its clock after the device finishes.

The reference follows the program step by step from its own state: the
driver keeps, for a few steps, the particle system before the step and
after it (references only, no copy in the window): step 0 of the
window's first run (the start) and that run's last step, where the
exponent reaches 1; then one step each of the second and third runs,
drawn from the seed over the whole length of the first run (a run that
ends before its drawn step gives its last one).  Where the window closes
inside a run that still owes a step, its last completed step is kept.

Mix parameters: ``M``, ``len_chain``, ``ESSrmin``, ``resampling``,
``trace_from`` and ``trace_steps`` (the traced stretch: from step
``trace_from`` of the first run that reaches it; a traced window stays
open until the stretch is traced).
"""

from __future__ import annotations

import time
import numpy as np

from smcbench.lib.harness import Record, State, rng, run_seed, sync


class PortSamplerRun:
    """One run of the program's sampler."""

    def __init__(self, fk, M, seed, params, device):
        from particles_tpu_torch import SMC

        self.pf = SMC(fk=fk, N=M, seed=seed, resampling=params["resampling"],
                      ESSrmin=params["ESSrmin"])

    @property
    def t(self):
        return self.pf.t

    def state(self):
        """What the reference reads of the system after the last step."""
        pf = self.pf
        return {"X": pf.X, "lw": pf.wgts.lw, "loglt": pf.loglt,
                "exponent": pf.X.shared["exponent"],
                "acc_rate": pf.X.shared.get("acc_rate")}

    def step(self):
        """One step; False once the sampler is done (no step taken)."""
        try:
            next(self.pf)
        except StopIteration:
            return False
        return True

    def finish(self):
        """The log-evidence after each step, a device tensor, with no host
        read; the run can then be dropped."""
        import torch

        return torch.stack([v.reshape(()) for v in self.pf.summaries.logLts])


def setup(s):
    p = s.params
    fk = s.cell.model.make_fk(s.cell.config, p, s.inputs, s.device, s.spans)
    make = PortSamplerRun if s.engine is None else s.engine
    warm = make(fk, p["M"], run_seed(s.seed, 0), p, s.device)
    warm.step()      # step 0: the prior's draws, the likelihood over N0
    warm.step()      # a resample-move step: every shape of the window
    warm.finish()
    return State(fk=fk, make=make, params=p, seed=s.seed, device=s.device,
                 spans=s.spans, config=s.cell.config)


def check_steps(seed, last_step, runs=(1, 2)):
    """{run: step} of the steps the reference follows in ``runs``, each
    drawn from ``[1, last_step]``, the first run's last step."""
    ks = rng(seed, 2).integers(1, last_step + 1, size=len(runs))
    return {r: int(k) for r, k in zip(runs, ks)}


def window(state, seconds, tracer):
    import torch

    p, spans = state.params, state.spans
    owed = {0: None}      # run -> the step it owes (None: its last)
    finished, run, done = [], None, True
    checks, pending = [], None
    steps = particle_steps = traced = traced_rs = 0
    tracing = False
    N0 = None
    sync(torch, state.device)
    t0 = time.perf_counter()
    while True:
        if done:
            with spans("new_run"):
                if run is not None:
                    finished.append(run.finish())
                run = state.make(state.fk, p["M"], run_seed(state.seed, 1,
                                                            len(finished)),
                                 p, state.device)
            done = False
        r, t = len(finished), run.t
        before = run.state() if r in owed and t > 0 else None
        if tracer is not None and not tracing and traced == 0 \
                and t == p["trace_from"]:
            sync(torch, state.device)
            t_trace = time.perf_counter()
            tracer.start()
            tracing = True
        with spans("step"):
            done = not run.step()
        if done:
            # the run's last step was the one before: the first run's
            # length sets where the later runs' steps are drawn
            if r in owed:
                if pending is not None:
                    checks.append(pending)
                del owed[r]
            if r == 0:
                owed.update(check_steps(state.seed, max(t - 1, 1)))
            pending = None
        else:
            steps += 1
            N0 = run.pf.X.N
            particle_steps += N0
            if r in owed:
                kept = {"run": r, "t": t, "before": before,
                        "after": run.state()}
                if t == 0 and r == 0:
                    checks.append(kept)
                elif owed[r] == t:
                    checks.append(kept)
                    del owed[r]
                else:
                    pending = kept
            if tracing:
                traced += 1
                traced_rs += t > 0
                if traced == p["trace_steps"]:
                    tracer.stop()
                    t0 += time.perf_counter() - t_trace
                    tracing = False
        if not tracing and (tracer is None or traced) \
                and time.perf_counter() - t0 >= seconds:
            break
    sync(torch, state.device)
    elapsed = time.perf_counter() - t0
    if pending is not None:
        checks.append(pending)
    pending = None
    if run.t > 0:
        finished.append(run.finish())
    del run
    failed = sum(int(np.sum(~np.isfinite(v.double().cpu().numpy())))
                 for v in finished)
    M, P = p["M"], p["len_chain"]
    return Record(
        e2e={"particle_steps_per_s": particle_steps / elapsed},
        attempted=steps, failed=failed,
        info={"steps": steps, "runs": len(finished), "window_s": elapsed,
              "checked": [(c["run"], c["t"]) for c in checks]},
        outputs={"M": M, "P": P, "checks": checks, "seed": state.seed},
        work={"kind": "sampler", "M": M, "P": P, "N0": N0,
              "d": state.config["d"], "n": state.config["n"],
              "steps": traced, "rs_steps": traced_rs})
