"""particles-tpu, PyTorch port: Sequential Monte Carlo on an NVIDIA H100.

The port of ``particles_tpu`` (JAX, TPU) to PyTorch and hand-written CUDA
kernels, with the same module names and public surface, slice by slice
(ROADMAP.md).  This package imports ``torch`` and never ``jax``.

Ported so far: the particle filters — bootstrap, guided and auxiliary —
with every resampling scheme (``SMC``, ``multiSMC``, ``FeynmanKac``),
SQMC (``SQMC``, ``SMC(qmc=True)``) with its point sets (``rqmc``) and
the Hilbert sort (``hilbert``), the model DSL and zoo of
``state_space_models``, every law of ``distributions``, ``kalman`` and
``hmm`` (the exact oracles), the weight numerics and resampling
registries, the particle history and off-line smoothers (``smoothing``,
QMC FFBS included), the collectors with the on-line smoothers,
``variance_estimators``, the experiment helpers of ``utils``, the SMC
samplers (``smc_samplers``: IBIS, fixed and adaptive tempering,
waste-free or not, and SMC²) with ``variance_mcmc`` and ``datasets``,
PMCMC (``mcmc``: random-walk Metropolis, PMMH with batched chains,
conditional SMC and Particle Gibbs) over a batched inner filter
(``inner_pf``), checkpoint and resume (``SMC.save_state``,
``SMC.load_state``), nested sampling (``nested``: vanilla NS and NS-SMC),
Bayesian variable selection by SMC on binary spaces (``binary_smc``), the
particle-sharded filter on ``torch.distributed`` (``parallel``:
``run_shardmap_smc``, the systematic, stratified and multinomial rings,
sharded FFBS-MCMC; ``distctx``, the ambient context), and the six kernels
of ``ops``.  Entry points run on the current CUDA card
unless given ``device="cpu"`` or CPU tensors.  ``tracing`` marks a step's
work for ``torch.profiler`` (``particles.*`` ranges) and counts launches,
collectives and host reads.
"""

__version__ = "0.1.0"

_CORE_EXPORTS = ("SMC", "SQMC", "FeynmanKac", "multiSMC")

_SUBMODULES = (
    "binary_smc",
    "collectors",
    "convert",
    "core",
    "datasets",
    "distctx",
    "distributions",
    "hilbert",
    "hmm",
    "inner_pf",
    "kalman",
    "mcmc",
    "nested",
    "ops",
    "parallel",
    "resampling",
    "rqmc",
    "smc_samplers",
    "smoothing",
    "state_space_models",
    "tracing",
    "utils",
    "variance_estimators",
    "variance_mcmc",
)


def __getattr__(name):
    # Lazy, as in particles_tpu: keeps submodule imports cheap and free of
    # cycles while the package is partially loaded.
    if name in _CORE_EXPORTS:
        from particles_tpu_torch import core

        return getattr(core, name)
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"particles_tpu_torch.{name}")
    raise AttributeError(
        f"module 'particles_tpu_torch' has no attribute {name!r}")
