"""The PyTorch port's public surface against the JAX package's.

``REFERENCE_SURFACE`` (``tests/test_api_surface.py``) lists every public
name of the JAX package by module, ``DIST_SURFACE`` the names of its
distributed path (``distctx`` and ``parallel``) and ``NATIVE_SURFACE``
those of its C++ host helpers (``native``), which that list leaves out.
Each name is ``PORTED`` (it must exist in the same module of
``particles_tpu_torch``) or ``MISSING`` (it must not exist yet, labelled
by ROADMAP item).  No module of the port imports JAX or the JAX package.
"""

import ast
import importlib
from pathlib import Path

import pytest

from test_api_surface import REFERENCE_SURFACE

DIST_SURFACE = {
    "particles_tpu.distctx": ["DistCtx", "dist_context", "local_context",
                              "current"],
    "particles_tpu.parallel": [
        "make_mesh", "particle_constrain", "run_sharded_smc",
        "run_sharded_multismc", "ring_systematic_resample",
        "run_shardmap_smc", "sharded_backward_mcmc"],
}
NATIVE_SURFACE = {
    "particles_tpu.native": ["AVAILABLE", "inverse_cdf", "systematic_counts",
                             "ssp_counts", "hilbert_index"],
}
SURFACE = {**REFERENCE_SURFACE, **DIST_SURFACE, **NATIVE_SURFACE}

PORTED = {
    "particles_tpu": ["SMC", "SQMC", "FeynmanKac", "multiSMC"],
    "particles_tpu.binary_smc": [
        "Bernoulli", "NestedLogistic", "BinaryMetropolis",
        "chol_and_friends", "VariableSelection", "BayesianVS",
        "BayesianVS_gprior", "all_binary_words",
    ],
    "particles_tpu.collectors": [
        "Collector", "Moments", "Fixed_lag_smooth", "Online_smooth_naive",
        "Online_smooth_ON2", "Paris",
    ],
    "particles_tpu.distctx": ["DistCtx", "dist_context", "local_context",
                              "current"],
    "particles_tpu.datasets": [
        "GBP_vs_USD_9798", "Nutria", "Neuro", "Pima", "Eeg", "Sonar",
        "Boston", "Concrete", "Liver",
    ],
    "particles_tpu.distributions": [
        "ProbDist", "LocScaleDist", "Normal", "MvNormal", "Logistic",
        "Laplace", "Beta", "Gamma", "InvGamma", "LogNormal", "Uniform",
        "Student", "FlatNormal", "Dirac", "TruncNormal", "DiscreteDist",
        "Poisson", "Binomial", "Geometric", "NegativeBinomial",
        "Categorical", "DiscreteUniform", "TransformedDist", "LinearD",
        "LogD", "LogitD", "Mixture", "MixMissing", "Dirichlet",
        "VaryingCovNormal", "IndepProd", "IID", "Cond", "StructDist",
    ],
    "particles_tpu.hilbert": ["hilbert_sort", "Hilbert_to_int", "invlogit"],
    "particles_tpu.hmm": ["HMM", "GaussianHMM", "BaumWelch"],
    "particles_tpu.kalman": [
        "MeanAndCov", "predict_step", "filter_step", "smoother_step",
        "MVLinearGauss", "MVLinearGauss_Guarniero_etal", "LinearGauss",
        "Kalman",
    ],
    "particles_tpu.resampling": [
        "Weights", "exp_and_normalise", "essl", "log_sum_exp",
        "wmean_and_var", "resampling", "multinomial", "residual",
        "stratified", "systematic", "ssp", "killing", "idiotic",
        "inverse_cdf", "uniform_spacings", "MultinomialQueue", "wquantiles",
    ],
    "particles_tpu.rqmc": ["sobol", "halton", "latin", "safe_generate"],
    "particles_tpu.mcmc": [
        "MCMC", "VanishCovTracker", "GenericRWHM", "BasicRWHM", "PMMH",
        "CSMC", "GenericGibbs", "ParticleGibbs",
    ],
    "particles_tpu.native": NATIVE_SURFACE["particles_tpu.native"],
    "particles_tpu.parallel": ["ring_systematic_resample",
                               "run_shardmap_smc", "sharded_backward_mcmc",
                               "make_mesh", "particle_constrain",
                               "run_sharded_smc", "run_sharded_multismc"],
    "particles_tpu.nested": [
        "NestedParticles", "NestedSampling", "Nested_RWmoves",
        "NestedSamplingSMC", "MeanCovTracker", "unif_minus_one",
    ],
    "particles_tpu.smc_samplers": REFERENCE_SURFACE[
        "particles_tpu.smc_samplers"],
    "particles_tpu.smoothing": [
        "ParticleHistory", "PartialParticleHistory",
        "RollingParticleHistory", "generate_hist_obj", "smoothing_worker",
    ],
    "particles_tpu.state_space_models": [
        "StateSpaceModel", "Bootstrap", "GuidedPF", "APFMixin",
        "AuxiliaryPF", "AuxiliaryBootstrap", "StochVol", "StochVolLeverage",
        "Gordon_etal", "BearingsOnly", "DiscreteCox", "MVStochVol",
        "ThetaLogistic",
    ],
    "particles_tpu.utils": ["timer", "multiplexer", "add_to_dict",
                            "cartesian_lists", "distribute_work", "worker",
                            "seeder"],
    "particles_tpu.variance_estimators": ["Var", "Var_logLt",
                                          "Lag_based_var"],
    "particles_tpu.variance_mcmc": [
        "MCMC_variance", "AutoCovarianceCalculator",
        "autocovariance_fft_single", "default_collector",
    ],
}

# every name is ported
MISSING = {}


def _port_module(name):
    """The port's module of the JAX module ``name``, or None."""
    try:
        return importlib.import_module(
            name.replace("particles_tpu", "particles_tpu_torch", 1))
    except ModuleNotFoundError:
        return None


@pytest.mark.parametrize("module_name", sorted(SURFACE))
def test_lists_split_the_reference_surface(module_name):
    ported = PORTED.get(module_name, [])
    missing = MISSING.get(module_name, [])
    assert not set(ported) & set(missing)
    assert sorted(ported + missing) == sorted(SURFACE[module_name])


@pytest.mark.parametrize("module_name",
                         sorted({**DIST_SURFACE, **NATIVE_SURFACE}))
def test_dist_surface_is_the_jax_packages(module_name):
    """``DIST_SURFACE`` and ``NATIVE_SURFACE`` hold every public name of
    the JAX package's distributed modules and of its host helpers."""
    mod = importlib.import_module(module_name)
    names = getattr(mod, "__all__", None) or [
        n for n, v in vars(mod).items()
        if not n.startswith("_") and callable(v)]
    assert sorted(names) == sorted(SURFACE[module_name])


@pytest.mark.parametrize("module_name", sorted(PORTED))
def test_ported_names_exist(module_name):
    mod = _port_module(module_name)
    assert mod is not None, module_name
    absent = [n for n in PORTED[module_name] if not hasattr(mod, n)]
    assert not absent, f"{module_name}: {absent}"


@pytest.mark.parametrize("module_name", sorted(MISSING))
def test_missing_names_are_not_there_yet(module_name):
    """A name that the port gains moves to ``PORTED``."""
    mod = _port_module(module_name)
    present = ([] if mod is None else
               [n for n in MISSING[module_name] if hasattr(mod, n)])
    assert not present, f"{module_name}: move {present} to PORTED"


_ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(_ROOT)) for p in [
        *(_ROOT / "particles_tpu_torch").rglob("*.py"),
        _ROOT / "chip_smoke.py"]))
def test_no_port_module_imports_jax(path):
    """The port, and the script that drives it on the card, import
    neither JAX nor the JAX package."""
    tree = ast.parse((_ROOT / path).read_text())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.append(node.module)
    bad = [m for m in imported
           if m.split(".")[0] in ("jax", "jaxlib", "particles_tpu")]
    assert not bad, bad
