"""The PyTorch port's public surface against the JAX package's.

``REFERENCE_SURFACE`` (``tests/test_api_surface.py``) lists every public
name of the JAX package by module.  Every name is ``PORTED``: it must
exist in the same module of ``particles_tpu_torch``.
"""

import importlib

import pytest

from test_api_surface import REFERENCE_SURFACE

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


def _port_module(name):
    """The port's module of the JAX module ``name``, or None."""
    try:
        return importlib.import_module(
            name.replace("particles_tpu", "particles_tpu_torch", 1))
    except ModuleNotFoundError:
        return None


@pytest.mark.parametrize("module_name", sorted(REFERENCE_SURFACE))
def test_lists_split_the_reference_surface(module_name):
    assert sorted(PORTED.get(module_name, [])) == sorted(
        REFERENCE_SURFACE[module_name])


@pytest.mark.parametrize("module_name", sorted(PORTED))
def test_ported_names_exist(module_name):
    mod = _port_module(module_name)
    assert mod is not None, module_name
    absent = [n for n in PORTED[module_name] if not hasattr(mod, n)]
    assert not absent, f"{module_name}: {absent}"
