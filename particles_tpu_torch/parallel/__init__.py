"""Multi-rank execution: the particle-sharded engine on ``torch.distributed``
(counterpart of ``particles_tpu.parallel``).

``run_shardmap_smc`` runs the engine (filters, SQMC, the SMC samplers) on
every rank of a process group, each on its slice of the particles; the
systematic, stratified and multinomial ring resamplers redistribute them;
``sharded_backward_mcmc`` runs FFBS-MCMC over a history sharded the same
way.  The mesh entry points of the JAX package (``make_mesh``,
``particle_constrain``, ``run_sharded_smc``, ``run_sharded_multismc``)
work on a ``torch.distributed.device_mesh.DeviceMesh``
(:mod:`particles_tpu_torch.parallel.sharded`).  ``launch.spawn`` starts
the ranks, ``comm`` holds the collectives.
"""

_EXPORTS = {
    "ring_systematic_resample": "distributed",
    "ring_stratified_resample": "distributed",
    "ring_multinomial_resample": "distributed",
    "run_shardmap_smc": "distributed",
    "sharded_backward_mcmc": "distributed",
    "make_mesh": "sharded",
    "particle_constrain": "sharded",
    "run_sharded_smc": "sharded",
    "run_sharded_multismc": "sharded",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    # lazy: resampling imports parallel.comm, and distributed imports the
    # engine, so an eager import here would be a cycle
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(
            f"particles_tpu_torch.parallel.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(
        f"module 'particles_tpu_torch.parallel' has no attribute {name!r}")
