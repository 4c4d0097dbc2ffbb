"""Bayesian logistic regression on UCI Sonar: the data prepared from the
raw file, and the program's waste-free adaptive tempering sampler of it.

The predictors are rescaled to mean 0 and sd 0.5, an intercept is added,
and each row is multiplied by its response in {-1, +1} (the sign-flip), as
``datasets.BinaryRegDataset`` does; the (208, 61) float32 array is handed
to the program and to the reference alike.  The prior is one vector field
``beta`` ~ N(0, 5^2 I)."""

from __future__ import annotations

import numpy as np

from smcbench.lib.spec import ROOT


def prepare(config, root=ROOT):
    """The (n, d) float32 rows y_i x_i of the raw file."""
    path = root / config["data_file"]
    raw = np.loadtxt(str(path), delimiter=",",
                     converters={60: lambda s: 1.0 if s.strip() in
                                 ("R", b"R") else 0.0})
    y = np.where(raw[:, -1] == raw[:, -1].max(), 1.0, -1.0)
    preds = raw[:, :-1]
    scaled = (config["predictor_scale"] * (preds - preds.mean(0))
              / preds.std(0))
    X = np.concatenate([np.ones((raw.shape[0], 1)), scaled], 1)
    data = (X * y[:, None]).astype(np.float32)
    if data.shape != (config["n"], config["d"]):
        raise ValueError(f"smcbench: {path} gives {data.shape}, the "
                         f"configuration states {(config['n'], config['d'])}")
    return data


def make_inputs(config, params, seed):
    return {"data": prepare(config)}


def make_fk(config, params, inputs, device, spans):
    """``AdaptiveTempering(model, len_chain=P)`` of the logistic model on
    ``device``; its likelihood runs inside the range ``smcbench.loglik``
    when traced."""
    import torch

    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import smc_samplers as ssp

    class SonarLogit(ssp.StaticModel):
        def logpyt(self, theta, t):
            return -torch.nn.functional.softplus(
                -(theta["beta"] @ self.data[t]))

        def loglik(self, theta, t=None):
            with spans("loglik"):
                return super().loglik(theta, t)

    d = config["d"]
    prior = dists.StructDist({"beta": dists.MvNormal(
        loc=torch.zeros(d, device=device), scale=config["prior_scale"])})
    model = SonarLogit(data=torch.as_tensor(inputs["data"], device=device),
                       prior=prior)
    return ssp.AdaptiveTempering(model=model, len_chain=params["len_chain"],
                                 ESSrmin=params["ESSrmin"])
