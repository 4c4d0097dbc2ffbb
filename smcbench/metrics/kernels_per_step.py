"""kernels_per_step: the CUDA kernels of the traced window over the steps
in it (``core._step``, ``core._step_qmc`` or ``smc_samplers.sampler_next``
with what the drivers add around them).  Moves ``particle_steps_per_s``."""


def read(ctx):
    steps = ctx.work.get("steps", 0)
    kernels = ctx.trace.kernels()
    if steps <= 0 or not kernels:
        return None
    return len(kernels) / steps
