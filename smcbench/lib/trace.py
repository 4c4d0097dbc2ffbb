"""The traced window: one ``torch.profiler`` window a process over a
steady stretch, read from its chrome trace.

The benchmark's own files mark what the host does with
``record_function`` ranges named ``smcbench.<what>`` (:class:`Spans`);
the window itself is the range ``smcbench.window``.  From the trace come
the device's busy time (the union of its kernels, copies and fills inside
the window), the idle gaps between them labelled by what the host was
doing, and each kernel's device time and launch time, which the
per-layer readers of ``metrics/`` take.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "smcbench."


class Spans:
    """``spans("step")`` is a ``record_function`` range ``smcbench.step``
    when tracing, and nothing otherwise, so untraced runs pay nothing."""

    def __init__(self, torch, on):
        self.torch = torch
        self.on = on

    def __call__(self, name):
        if not self.on:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(PREFIX + name)


def short_name(name, width=100):
    """A kernel's name without its argument list, at most ``width``
    characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    if cut > 0:
        name = name[:cut]
    return name[:width]


@dataclass
class TraceData:
    """What the readers see of one traced window; times in microseconds
    on the trace's clock."""

    t0: float
    t1: float
    device: list = field(default_factory=list)   # (name, ts, dur, corr)
    launches: dict = field(default_factory=dict)  # corr -> host ts
    ranges: list = field(default_factory=list)   # (name, ts, te)
    host_ops: list = field(default_factory=list)  # (ts, te, name), sorted

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self):
        """The union of the device's operations inside the window."""
        spans = sorted((max(ts, self.t0), min(ts + dur, self.t1))
                       for _, ts, dur, _ in self.device)
        merged = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernels(self):
        return [e for e in self.device if not e[0].startswith("Memcpy")
                and not e[0].startswith("Memset")]

    def matching(self, pattern):
        """(device seconds, count) of the device operations whose name
        matches the regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [e for e in self.device if rx.search(e[0])]
        return sum(e[2] for e in hits) * 1e-6, len(hits)

    def device_s_under(self, range_name):
        """Device seconds of the operations launched while the host was
        inside a range ``smcbench.<range_name>``."""
        spans = sorted((ts, te) for n, ts, te in self.ranges
                       if n == PREFIX + range_name)
        starts = [s for s, _ in spans]
        total = 0.0
        for _, _, dur, corr in self.device:
            ts = self.launches.get(corr)
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                total += dur
        return total * 1e-6

    def _innermost(self, items, starts, p, depth=400):
        i = bisect.bisect_right(starts, p) - 1
        best = None
        while i >= 0 and depth > 0:
            ts, te, name = items[i]
            if te >= p:
                best = name
                break
            i -= 1
            depth -= 1
        return best

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing then (the innermost benchmark
        range and the innermost host operation at the gap's middle), each
        a list of at most ``top`` [name, seconds]."""
        by_op = {}
        for name, _, dur, _ in self.device:
            k = short_name(name)
            by_op[k] = by_op.get(k, 0.0) + dur * 1e-6
        ranges = sorted((ts, te, n[len(PREFIX):]) for n, ts, te
                        in self.ranges if n != PREFIX + "window")
        rstarts = [r[0] for r in ranges]
        ostarts = [o[0] for o in self.host_ops]
        gaps, prev = {}, self.t0
        for a, b in self.busy_intervals() + [[self.t1, self.t1]]:
            if a > prev:
                mid = 0.5 * (a + prev)
                where = self._innermost(ranges, rstarts, mid) or "outside"
                op = self._innermost(self.host_ops, ostarts, mid) or "python"
                key = f"{where} > {op}"[:100]
                gaps[key] = gaps.get(key, 0.0) + (a - prev) * 1e-6
            prev = max(prev, b)

        def head(d):
            return [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:top]]

        return {"device_ops": head(by_op), "idle_gaps": head(gaps)}


def parse_chrome_trace(events):
    """:class:`TraceData` of a chrome trace's ``traceEvents``; the window
    is the range ``smcbench.window``."""
    window = [e for e in events if e.get("name") == PREFIX + "window"
              and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError("smcbench: the trace holds no smcbench.window range")
    t0 = float(window[0]["ts"])
    t1 = t0 + float(window[0]["dur"])
    data = TraceData(t0=t0, t1=t1)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            if ts + dur > t0 and ts < t1:
                data.device.append((e["name"], ts, dur,
                                    args.get("correlation")))
        elif cat in LAUNCH_CATS:
            if "correlation" in args:
                data.launches[args["correlation"]] = ts
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            data.ranges.append((e["name"], ts, ts + dur))
        elif cat == "cpu_op" and ts + dur > t0 and ts < t1:
            data.host_ops.append((ts, ts + dur, e["name"]))
    data.host_ops.sort()
    return data


class Tracer:
    """One profiler window: :meth:`start`, then :meth:`stop`, which waits
    for the device and ends the window, and once the measured window has
    closed :meth:`read`, which writes the chrome trace to a temporary file
    under ``TMPDIR``, reads it into :class:`TraceData` and removes it.
    Starting the profiler and processing its events take seconds: a
    driver leaves the whole traced stretch out of its window, so that a
    traced run steps as far as an untraced one and reaches the steps its
    reference keeps."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"
        self._prof = self._range = None
        self.data = None

    def start(self):
        prof = self.torch.profiler
        acts = [prof.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(prof.ProfilerActivity.CUDA)
        self._prof = prof.profile(activities=acts)
        self._prof.__enter__()
        self._range = prof.record_function(PREFIX + "window")
        self._range.__enter__()

    def stop(self):
        if self.cuda:
            self.torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def read(self):
        fd, path = tempfile.mkstemp(suffix=".json", prefix="smcbench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.data = parse_chrome_trace(events)
        return self.data
