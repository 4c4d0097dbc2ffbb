"""The scalar linear Gaussian model: its data made from the seed, and the
program's bootstrap filter of it.

The data is simulated by the benchmark's own NumPy code, so that the
program and the reference read the same float32 array."""

from __future__ import annotations

import math

import numpy as np

from smcbench.lib.harness import rng


def simulate(config, T, seed):
    """y (float32) of length ``T`` from the seed: x_0 ~ N(0, sigma0^2)
    with the stationary sigma0 = sigmaX / sqrt(1 - rho^2), x_t = rho
    x_{t-1} + sigmaX eps_t, y_t = x_t + sigmaY eta_t."""
    g = rng(seed, 1)
    eps = g.standard_normal(T)
    eta = g.standard_normal(T)
    rho, sx = config["rho"], config["sigmaX"]
    x = np.empty(T)
    x[0] = sx / math.sqrt(1.0 - rho ** 2) * eps[0]
    for t in range(1, T):
        x[t] = rho * x[t - 1] + sx * eps[t]
    return (x + config["sigmaY"] * eta).astype(np.float32)


def make_inputs(config, params, seed):
    """The observations the mix runs over: ``T`` of them."""
    return {"y": simulate(config, params["T"], seed)}


def make_fk(config, params, inputs, device, spans):
    """``ssms.Bootstrap(ssm=kalman.LinearGauss(...), data=y)`` on
    ``device``."""
    import torch

    from particles_tpu_torch import kalman
    from particles_tpu_torch import state_space_models as ssms

    ssm = kalman.LinearGauss(rho=config["rho"], sigmaX=config["sigmaX"],
                             sigmaY=config["sigmaY"])
    return ssms.Bootstrap(ssm=ssm, data=torch.as_tensor(inputs["y"],
                                                         device=device))
