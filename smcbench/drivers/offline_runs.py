"""Whole filter runs back to back: the throughput of a long filter.

Each run is a new ``SMC`` (``SQMC`` where the mix sets ``qmc``) of ``N``
particles over the mix's ``T`` observations, seeded from ``--seed`` and
the run's index, with the ``Moments`` collector, as a user who wants the
filtered means and the log-likelihood runs it.  The window counts every
completed step, of the runs it finished and of the one it cut, and stops
its clock after the device finishes.  The reference then judges every
step's filtered mean and every run's log-likelihood.

Mix parameters: ``N``, ``T``, ``resampling``, ``ESSrmin``, ``qmc``,
``warm_steps`` (steps of a run in set-up), ``trace_from`` and
``trace_steps`` (the traced stretch, counted in the window's steps; a
traced window stays open until the stretch is traced).
"""

from __future__ import annotations

import time
import numpy as np

from smcbench.lib.harness import Record, State, run_seed, sync


class PortRun:
    """One run of the program's filter."""

    def __init__(self, fk, N, seed, params, device):
        from particles_tpu_torch import SMC, collectors

        self.pf = SMC(fk=fk, N=N, seed=seed,
                      resampling=params["resampling"],
                      ESSrmin=params["ESSrmin"], qmc=params["qmc"],
                      collect=[collectors.Moments()])

    @property
    def t(self):
        return self.pf.t

    @property
    def rs_flag(self):
        return bool(self.pf.rs_flag)

    def step(self):
        next(self.pf)

    def read(self):
        """(this step's filtered mean, its log-likelihood increment) on the
        host: one read."""
        import torch

        mean = self.pf.summaries.moments[-1]["mean"]
        return torch.stack((mean.reshape(()),
                            self.pf.loglt.reshape(()))).tolist()

    def finish(self):
        """(filtered means (t,), log-likelihood after the last step) as
        device tensors, with no host read; the run can then be dropped."""
        import torch

        moments = self.pf.summaries.moments
        if not moments:
            return torch.zeros(0), torch.zeros(())
        return (torch.stack([m["mean"].reshape(()) for m in moments]),
                self.pf.logLt)


def to_host(finished):
    """[{"means": float64 (t,), "logLt": float}] of :meth:`finish`'s
    tensors, read once the window has closed."""
    return [{"means": m.double().cpu().numpy(), "logLt": float(ll)}
            for m, ll in finished]


def setup(s):
    p = s.params
    fk = s.cell.model.make_fk(s.cell.config, p, s.inputs, s.device, s.spans)
    make = PortRun if s.engine is None else s.engine
    warm = make(fk, p["N"], run_seed(s.seed, 0), p, s.device)
    for _ in range(p["warm_steps"]):
        warm.step()
    warm.finish()
    return State(fk=fk, make=make, params=p, seed=s.seed, device=s.device,
                 spans=s.spans, config=s.cell.config)


def window(state, seconds, tracer):
    import torch

    p, spans = state.params, state.spans
    N, T = p["N"], p["T"]
    finished, run = [], None
    steps = traced = traced_rs = 0
    tracing = False
    sync(torch, state.device)
    t0 = time.perf_counter()
    while True:
        if run is None or run.t >= T:
            with spans("new_run"):
                if run is not None:
                    finished.append(run.finish())
                run = state.make(state.fk, N, run_seed(state.seed, 1,
                                                       len(finished)),
                                 p, state.device)
        if tracer is not None and not tracing and traced == 0 \
                and steps == p["trace_from"]:
            sync(torch, state.device)
            t_trace = time.perf_counter()
            tracer.start()
            tracing = True
        with spans("step"):
            run.step()
        steps += 1
        if tracing:
            traced += 1
            traced_rs += run.rs_flag
            if traced == p["trace_steps"]:
                tracer.stop()
                t0 += time.perf_counter() - t_trace
                tracing = False
        if not tracing and (tracer is None or traced) \
                and time.perf_counter() - t0 >= seconds:
            break
    sync(torch, state.device)
    elapsed = time.perf_counter() - t0
    finished.append(run.finish())
    del run
    outs = to_host(finished)
    failed = sum(int(np.sum(~np.isfinite(o["means"]))) for o in outs)
    return Record(
        e2e={"particle_steps_per_s": steps * N / elapsed},
        attempted=steps, failed=failed,
        info={"steps": steps, "runs": len(finished), "window_s": elapsed},
        outputs={"N": N, "runs": outs},
        work={"kind": "sqmc" if p["qmc"] else "filter", "N": N,
              "steps": traced, "rs_steps": traced_rs})
