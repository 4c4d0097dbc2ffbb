"""model_device_share: the share of the traced window's busy device time
spent in the operations launched inside the program's calls into the
model (the span ``particles.model``: a filter's draws and log-potentials,
a sampler's prior and log-likelihood), in %.  Moves
``particle_steps_per_s``."""

from smcbench.lib.program import device_share


def read(ctx):
    return device_share(ctx.trace, "model")
