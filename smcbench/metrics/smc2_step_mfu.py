"""smc2_step_mfu: the whole SMC² step's share of the card's peak, in %: the
least time the traced stretch could take, its needed bytes over the peak
bandwidth, over the stretch's measured time.  Moves
``particle_steps_per_s``.

Needed work, whatever implements it:

- each inner particle-step (a θ-particle's filter advancing one particle
  one step, forward or in a replay; the program's counter
  ``smc2.inner_particle_steps``): read the particle, write the new one and
  its log-weight, read the weights once for the resampling, 16 bytes, as
  ``step_mfu`` counts a filter step; its operations are a few a particle
  and never bound it;
- each resample-move: read the picked θ-particles' rows (θ, the inner
  filter's states and log-weights, loglik, lpost) and write them, 2
  Ntheta ``row_bytes``.

A program that does not count inner particle-steps gives None.
"""


def bound_s(work, peaks):
    """The least seconds the stretch could take, or None."""
    if work.get("kind") != "smc2" or work.get("inner_particle_steps", 0) <= 0:
        return None
    need = (16 * work["inner_particle_steps"]
            + 2 * work["rs_steps"] * work["Ntheta"] * work["row_bytes"])
    return need / peaks["hbm_bytes_per_s"]


def read(ctx):
    bound = bound_s(ctx.work, ctx.peaks)
    if bound is None or ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * bound / ctx.trace.window_s
