"""rs_serve_roofline: the resampling move's share of its roofline (B2,
``ops.repeat_cols`` by z), in %: the bytes the work needs, from the
cell's shapes, over the peak bandwidth, against the device time of the
kernel this file names.  Moves ``particle_steps_per_s``.

The work of one resampling step: read z (int32, one a particle carried),
read each of the M picked rows and write it: a filter of N float32
particles, M = N: 12 N bytes; a sampler of N0 particles of d float32
coordinates and three float32 fields picking M: 4 N0 + 2 M (4 d + 12)
bytes."""

KERNELS = r"k_merge_serve"


def bytes_per_step(work):
    kind = work.get("kind")
    if kind == "filter":
        return 12 * work["N"]
    if kind == "sampler":
        return 4 * work["N0"] + 2 * work["M"] * (4 * work["d"] + 12)
    return None


def read(ctx):
    calls = ctx.work.get("rs_steps", 0)
    per = bytes_per_step(ctx.work)
    seconds, n = ctx.trace.matching(KERNELS)
    if calls <= 0 or per is None or n == 0 or seconds <= 0:
        return None
    return 100.0 * calls * per / ctx.peaks["hbm_bytes_per_s"] / seconds
