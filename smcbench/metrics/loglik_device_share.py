"""loglik_device_share: the share of the traced window's device time spent
in the kernels launched inside the model's log-likelihood (the range
``smcbench.loglik`` that the benchmark's model file puts around
``StaticModel.loglik``), in %.  Moves ``particle_steps_per_s``."""


def read(ctx):
    busy = ctx.trace.busy_s
    under = ctx.trace.device_s_under("loglik")
    if busy <= 0 or under <= 0:
        return None
    return 100.0 * under / busy
