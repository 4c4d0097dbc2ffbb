"""The port's ``variance_mcmc`` against the JAX package's, on the same
numpy arrays.  Both are numpy on the host, so every public function is
held to equality; the port's also takes tensors (copied to the host)."""

import numpy as np
import pytest
import torch

import particles_tpu.variance_mcmc as jvm
from particles_tpu_torch import variance_mcmc as vm


def _chains(seed, P=64, M=12, rho=0.8):
    """M AR(1) chains of length P, as a (P, M) array."""
    rng = np.random.default_rng(seed)
    X = np.empty((P, M))
    X[0] = rng.normal(size=M)
    for p in range(1, P):
        X[p] = rho * X[p - 1] + np.sqrt(1 - rho ** 2) * rng.normal(size=M)
    return X


@pytest.mark.parametrize("method", ["naive", "init_seq", "th"])
@pytest.mark.parametrize("seed", [0, 1])
def test_mcmc_variance_equals_jax(method, seed):
    X = _chains(seed)
    assert vm.MCMC_variance(X, method) == jvm.MCMC_variance(X, method)
    W = np.random.default_rng(seed).dirichlet(np.ones(X.shape[1]))
    assert (vm.MCMC_variance_weighted(X, W, method)
            == jvm.MCMC_variance_weighted(X, W, method))
    with pytest.raises(ValueError):
        vm.MCMC_variance(X, "nonsense")


@pytest.mark.parametrize("name", ["MCMC_variance_naive", "MCMC_init_seq",
                                  "MCMC_Tukey_Hanning",
                                  "autocovariance_fft_multiple",
                                  "gelman_rubin", "ess"])
def test_public_functions_equal_jax(name):
    for X in (_chains(2), _chains(3, P=7, M=3, rho=-0.5),
              np.ones((10, 4))):
        got, want = getattr(vm, name)(X), getattr(jvm, name)(X)
        np.testing.assert_array_equal(got, want)


def test_autocovariances_and_collectors_equal_jax():
    x = _chains(4, P=200, M=1)[:, 0]
    np.testing.assert_array_equal(vm.autocovariance_fft_single(x),
                                  jvm.autocovariance_fft_single(x))
    np.testing.assert_array_equal(
        vm.autocovariance_fft_single(x, mu=0.1, bias=False),
        jvm.autocovariance_fft_single(x, mu=0.1, bias=False))
    X = _chains(5)
    for order in (0, 1, 5):
        assert vm.autocovariance(X, order) == jvm.autocovariance(X, order)
    assert (vm.autocovariance(X, 3, bias=False)
            == jvm.autocovariance(X, 3, bias=False))
    ls = [np.arange(3), np.arange(2)]
    np.testing.assert_array_equal(vm.default_collector(ls),
                                  jvm.default_collector(ls))
    ac, jac = vm.AutoCovarianceCalculator(X), jvm.AutoCovarianceCalculator(X)
    assert len(ac) == len(jac) == X.shape[0]
    assert [ac[k] for k in range(5)] == [jac[k] for k in range(5)]
    with pytest.raises(IndexError):
        ac[X.shape[0]]


def test_chain_diagnostics_and_tensors():
    rng = np.random.default_rng(6)
    theta = {"a": _chains(7, P=100, M=3), "b": rng.normal(size=(100, 3, 2))}
    assert (vm.chain_diagnostics(theta, nchains=3, discard=10)
            == jvm.chain_diagnostics(theta, nchains=3, discard=10))
    single = {"a": _chains(8, P=100, M=1)[:, 0]}
    assert vm.chain_diagnostics(single) == jvm.chain_diagnostics(single)
    with pytest.raises(ValueError):
        vm.chain_diagnostics(theta, nchains=4)
    assert np.isnan(vm.gelman_rubin(np.ones((3, 2))))
    # a tensor argument is read on the host
    X = _chains(9)
    assert (vm.MCMC_variance(torch.from_numpy(X), "init_seq")
            == jvm.MCMC_variance(X, "init_seq"))
    assert vm.ess(torch.from_numpy(X)) == jvm.ess(X)
