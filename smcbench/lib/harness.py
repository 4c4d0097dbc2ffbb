"""One run of one cell: inputs from the seed, the driver's set-up and
window, the reference's judgement, and the result.

``run.py`` calls :func:`run_cell` on the card; the tests call it on the
CPU at small sizes (``params`` overrides the mix's), and the controls
(``controls.py``) with the reference's control in the program's place.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np

from smcbench.lib import result
from smcbench.lib.device import PEAKS, device_record
from smcbench.lib.trace import Spans, Tracer


def run_seed(seed, *stream):
    """A seed for ``torch.Generator.manual_seed`` (below 2^63) from the
    run's ``--seed`` (any whole number) and a stream of small integers."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *stream])
    hi, lo = ss.generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def rng(seed, *stream):
    """A NumPy generator from the run's ``--seed`` and a stream."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), *stream]))


@dataclass
class Setup:
    """What a driver's ``setup`` gets.  ``engine``: None runs the program;
    a control's factory of runs ``engine(fk, N, seed, params, device)``
    runs in its place."""

    cell: object
    params: dict
    inputs: dict
    seed: int
    device: object
    spans: Spans
    engine: object = None


@dataclass
class Record:
    """What a driver's ``window`` returns: the end-to-end values it
    measured, the answers due in the window and how many failed, the
    outputs the reference judges, the work inside the traced stretch
    (steps, resampling steps, shapes) for the per-layer readers, and what
    the window held (``info``: steps, runs, seconds), which ``run.py``
    prints on standard error."""

    e2e: dict
    attempted: int
    failed: int
    outputs: dict
    work: dict = field(default_factory=dict)
    info: dict = field(default_factory=dict)


@dataclass
class State:
    """What a driver's ``setup`` hands its ``window``: the program's model,
    the factory of runs, and the run's settings."""

    fk: object
    make: object
    params: dict
    seed: int
    device: object
    spans: Spans
    config: dict


@dataclass
class ReadContext:
    """What a per-layer reader gets: the trace, the work in it, the
    peaks."""

    trace: object
    work: dict
    peaks: dict


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(torch, cell, seed, seconds, trace, device, t_start,
             params=None, engine=None):
    """One run: ``(result line, [(name, value, limit), ...], info)``.
    ``engine(cell, inputs, device)``, where given, returns the factory of
    runs that replaces the program's (or None: the program runs)."""
    mix = dict(cell.traffic["params"])
    mix.update(params or {})
    spans = Spans(torch, trace)
    inputs = cell.model.make_inputs(cell.config, mix, seed)
    make = None if engine is None else engine(cell, inputs, device)
    state = cell.driver.setup(Setup(cell=cell, params=mix, inputs=inputs,
                                    seed=seed, device=device, spans=spans,
                                    engine=make))
    sync(torch, device)
    setup_s = time.time() - t_start
    # memory_peak_bytes is the window's: set-up's peak does not count
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(torch, device) if trace else None
    rec = cell.driver.window(state, seconds, tracer)
    dev = device_record(torch, device, cell.chips)
    # the program's state goes before the reference runs; what the
    # reference judges is in rec.outputs
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.reference.judge(cell.config, mix, inputs, rec.outputs,
                                  device)
    ok, rows = result.judge(checks, cell.traffic["limits"])
    correct = ok and rec.failed == 0 and rec.attempted > 0
    breakdown = None
    metrics = {}
    if not trace:
        values = dict(rec.e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    else:
        data = tracer.read()
        ctx = ReadContext(trace=data, work=rec.work, peaks=PEAKS)
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        dev["busy_s"] = data.busy_s
        dev["window_s"] = data.window_s
        breakdown = data.breakdown()
    line = result.result_line(correct, rec.attempted, rec.failed, metrics,
                              dev, rows, breakdown)
    return line, rows, dict(rec.info, setup_s=setup_s)
