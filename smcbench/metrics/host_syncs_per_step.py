"""host_syncs_per_step: the program's host reads of device values a step
in the traced window: the spans ``particles.sync.<site>`` that start
inside a span ``particles.step``, over the ``particles.step`` spans (each
a call of ``next`` on the program's ``SMC``).  Every read stalls the host
until the card has run all it was given.  Moves
``particle_steps_per_s``."""

from smcbench.lib.program import Cover, spans


def read(ctx):
    steps = spans(ctx.trace, "step")
    if not steps:
        return None
    inside = Cover(steps)
    reads = sum(1 for a, _ in spans(ctx.trace, "sync.") if a in inside)
    return reads / len(steps)
