"""Stochastic volatility with leverage on GBP/USD 1997-98: the returns read
from the raw file, and the program's SMC² of the model.

The returns are 100 diff(log) of the file's daily rates (two header rows
skipped, column 3, the copyright line a comment), as
``datasets.GBP_vs_USD_9798`` reads them; the float32 array is handed to
the program and to the reference alike.  The prior is the book's: mu ~
N(-1, 2^2), rho ~ U(-0.99, 0.99), sigma ~ Gamma(2, rate 4), phi ~
U(-0.99, 0.99)."""

from __future__ import annotations

import numpy as np

from smcbench.lib.spec import ROOT


def prepare(config, root=ROOT):
    """The (n,) float32 returns of the raw file."""
    path = root / config["data_file"]
    raw = np.loadtxt(str(path), skiprows=2, usecols=(3,), comments="(C)")
    y = (100.0 * np.diff(np.log(raw))).astype(np.float32)
    if y.shape != (config["n_returns"],):
        raise ValueError(f"smcbench: {path} gives {y.shape[0]} returns, the "
                         f"configuration states {config['n_returns']}")
    return y


def make_inputs(config, params, seed):
    return {"y": prepare(config)}


def make_fk(config, params, inputs, device, spans):
    """``SMC2`` of ``StochVolLeverage`` on the mix's first ``T`` returns,
    on ``device``."""
    import torch

    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import smc_samplers as ssp
    from particles_tpu_torch import state_space_models as ssms

    prior = dists.StructDist({
        "mu": dists.Normal(loc=-1.0, scale=2.0),
        "rho": dists.Uniform(a=-0.99, b=0.99),
        "sigma": dists.Gamma(a=2.0, b=4.0),
        "phi": dists.Uniform(a=-0.99, b=0.99)})
    y = torch.as_tensor(inputs["y"][:params["T"]], device=device)
    return ssp.SMC2(ssm_cls=ssms.StochVolLeverage, prior=prior, data=y,
                    init_Nx=config["init_Nx"], len_chain=config["len_chain"],
                    ar_to_increase_Nx=config["ar_to_increase_Nx"],
                    smc_options={"resampling": config["inner_resampling"],
                                 "ESSrmin": config["inner_ESSrmin"]})
