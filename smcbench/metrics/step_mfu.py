"""step_mfu: the whole step's share of the card's peak, in %: the least
time a step could take, the larger of its needed bytes over the peak
bandwidth and its needed float32 operations over the peak rate, counted
from the cell's shapes, over the measured time of a step in the traced
window.  Moves ``particle_steps_per_s``.

Needed work a step, whatever implements it:

- a filter step (bootstrap or SQMC) of N float32 particles: read the
  particles, write the new ones and their log-weights, read the weights
  once for the resampling: 16 N bytes; its operations are a few a
  particle and never bound it;
- a waste-free sampler step (N0 = M P particles of d float32 coordinates
  and three float32 fields, n data rows): read the system once and write
  the new one, 2 N0 (4 d + 12) bytes; the likelihood of each of the
  (P - 1) M new chain states, 2 d n operations each.
"""


def bound_s(work, peaks):
    """The least seconds a step could take, or None for a kind this file
    does not know."""
    bw, f32 = peaks["hbm_bytes_per_s"], peaks["f32_flops_per_s"]
    kind = work.get("kind")
    if kind in ("filter", "sqmc"):
        return 16 * work["N"] / bw
    if kind == "sampler":
        M, P, N0, d, n = (work[k] for k in ("M", "P", "N0", "d", "n"))
        return max(2 * N0 * (4 * d + 12) / bw, 2 * (P - 1) * M * d * n / f32)
    return None


def read(ctx):
    steps = ctx.work.get("steps", 0)
    bound = bound_s(ctx.work, ctx.peaks)
    if steps <= 0 or bound is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * bound / (ctx.trace.window_s / steps)
