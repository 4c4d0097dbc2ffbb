"""rs_z_roofline: the systematic z-form's share of its roofline (B1,
``ops.systematic_z_fused``), in %: the bytes the work needs, from the
cell's shapes, over the peak bandwidth, against the device time of the
kernel this file names.  Moves ``particle_steps_per_s``.

The work of one resampling step: read the N normalised float32 weights,
write the N int32 cumulative counts z: 8 N bytes, with N the particles
carried (N0 for a sampler)."""

KERNELS = r"k_fixed_point<[^>]*ZOut"


def bytes_per_step(work):
    kind = work.get("kind")
    if kind == "filter":
        return 8 * work["N"]
    if kind == "sampler":
        return 8 * work["N0"]
    return None


def read(ctx):
    calls = ctx.work.get("rs_steps", 0)
    per = bytes_per_step(ctx.work)
    seconds, n = ctx.trace.matching(KERNELS)
    if calls <= 0 or per is None or n == 0 or seconds <= 0:
        return None
    return 100.0 * calls * per / ctx.peaks["hbm_bytes_per_s"] / seconds
