"""device_idle_share: the share of the traced window in which no kernel,
copy or fill ran on the card, in % (the union of the device's operations
against the window's length).  Moves ``particle_steps_per_s``."""


def read(ctx):
    window = ctx.trace.window_s
    busy = ctx.trace.busy_s
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
