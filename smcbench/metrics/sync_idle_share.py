"""sync_idle_share: the share of the traced window in which the card sat
idle because of a host read, in %: each idle gap between the device's
busy intervals that opens while the host is inside a span
``particles.sync.<site>``, counted for its whole length, over the
window's length.  At most ``device_idle_share``.  Moves
``particle_steps_per_s``."""

from smcbench.lib.program import Cover, idle_gaps, spans


def read(ctx):
    trace = ctx.trace
    inside = Cover(spans(trace, "sync."))
    window = trace.t1 - trace.t0
    if not inside or window <= 0 or trace.busy_s <= 0:
        return None
    idle = sum(b - a for a, b in idle_gaps(trace) if a in inside)
    return 100.0 * idle / window
