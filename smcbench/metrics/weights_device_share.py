"""weights_device_share: the share of the traced window's busy device
time spent in the operations launched inside ``resampling.Weights`` (the
program's span ``particles.weights``: max, exp, sums, normalised
weights, ESS, log-mean), in %.  Moves ``particle_steps_per_s``."""

from smcbench.lib.program import device_share


def read(ctx):
    return device_share(ctx.trace, "weights")
