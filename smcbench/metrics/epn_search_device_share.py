"""epn_search_device_share: the share of the traced window's busy device
time spent in the operations launched inside adaptive tempering's search
for the next exponent (the program's span
``particles.sampler.epn_search``: the bisection's ESS evaluations over
every particle), in %.  Moves ``particle_steps_per_s``."""

from smcbench.lib.program import device_share


def read(ctx):
    return device_share(ctx.trace, "sampler.epn_search")
