"""replay_device_share: the share of the traced window's busy device time
spent in the operations launched inside SMC²'s replays (the program's span
``particles.smc2.replay``: every θ-particle's filter run afresh over the
observations so far, for each chain step of a resample-move's target and
for the exchange step), in %.  Moves ``particle_steps_per_s``."""

from smcbench.lib.program import device_share


def read(ctx):
    return device_share(ctx.trace, "smc2.replay")
