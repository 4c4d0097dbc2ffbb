"""The program's own spans in a traced window: the ranges
``particles.<name>`` that ``particles_tpu_torch.tracing`` records while a
profiler runs (``particles.step``, ``particles.sync.<site>``,
``particles.model``, ``particles.weights``,
``particles.sampler.epn_search``).

The program records them as function ranges, so the trace lists them
with the host's operators (``TraceData.host_ops``, (ts, te, name)), on
the clock of the device's operations.  A program that records none (an
older checkout) gives no span, and every reader that needs one returns
None.
"""

from __future__ import annotations

import bisect

PREFIX = "particles."


def spans(trace, name):
    """(ts, te) of the program's spans ``particles.<name>`` in the window,
    by start; a ``name`` ending in ``.`` takes every span under it
    (``"sync."``: every host read)."""
    full = PREFIX + name
    if full.endswith("."):
        return sorted((a, b) for a, b, n in trace.host_ops
                      if n.startswith(full))
    return sorted((a, b) for a, b, n in trace.host_ops if n == full)


class Cover:
    """The union of (a, b) intervals, asked whether it holds a time."""

    def __init__(self, intervals):
        self.merged = []
        for a, b in sorted(intervals):
            if self.merged and a <= self.merged[-1][1]:
                self.merged[-1][1] = max(self.merged[-1][1], b)
            else:
                self.merged.append([a, b])
        self.starts = [a for a, _ in self.merged]

    def __bool__(self):
        return bool(self.merged)

    def __contains__(self, p):
        i = bisect.bisect_right(self.starts, p) - 1
        return i >= 0 and p <= self.merged[i][1]


def device_share(trace, name):
    """The device time of the operations launched while the host was
    inside a span ``particles.<name>``, over the window's busy device
    time, in %; None where the program recorded no such span or the
    device did nothing."""
    inside = Cover(spans(trace, name))
    busy = trace.busy_s
    if not inside or busy <= 0:
        return None
    total = 0.0
    for _, _, dur, corr in trace.device:
        ts = trace.launches.get(corr)
        if ts is not None and ts in inside:
            total += dur
    return 100.0 * total * 1e-6 / busy


def idle_gaps(trace):
    """(opens, closes) of each gap between the device's busy intervals
    inside the window, the window's ends included."""
    gaps, prev = [], trace.t0
    for a, b in trace.busy_intervals() + [[trace.t1, trace.t1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    return gaps
