"""Multi-rank execution: the particle-sharded filter on ``torch.distributed``
(counterpart of ``particles_tpu.parallel``).

``run_shardmap_smc`` runs the engine on every rank of a process group,
each on its slice of the particles; the systematic, stratified and
multinomial ring resamplers redistribute them; ``sharded_backward_mcmc``
runs FFBS-MCMC over a history sharded the same way.  ``launch.spawn``
starts the ranks, ``comm`` holds the collectives.  The GSPMD entry points
of the JAX package (``make_mesh``, ``particle_constrain``,
``run_sharded_smc``, ``run_sharded_multismc``) are not ported (ROADMAP
A.11b).
"""

_EXPORTS = ("ring_systematic_resample", "ring_stratified_resample",
            "ring_multinomial_resample", "run_shardmap_smc",
            "sharded_backward_mcmc")

__all__ = list(_EXPORTS)


def __getattr__(name):
    # lazy: resampling imports parallel.comm, and distributed imports the
    # engine, so an eager import here would be a cycle
    if name in _EXPORTS:
        from particles_tpu_torch.parallel import distributed

        return getattr(distributed, name)
    raise AttributeError(
        f"module 'particles_tpu_torch.parallel' has no attribute {name!r}")
