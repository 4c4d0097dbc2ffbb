"""Linear-Gaussian state-space models and exact Kalman filtering/smoothing
(PyTorch port of ``particles_tpu/kalman.py``).

The low-level steps (``predict_step``, ``filter_step``,
``filter_step_asarray``, ``smoother_step``), the models ``MVLinearGauss``,
``MVLinearGauss_Guarniero_etal`` and ``LinearGauss`` with their optimal
proposals and auxiliary functions (``proposal0``, ``proposal``,
``logeta``), and the :class:`Kalman` filter and smoother, whose
recursions are Python loops here.  Kalman is the exact oracle for the
particle filters' output, the guided and auxiliary ones included.

:class:`Kalman` computes in the floating dtype of its data (float32 for
other input), on the data's device, and casts the model's matrices to it:
pass float64 data for a float64 oracle.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

import particles_tpu_torch.distributions as dists
from particles_tpu_torch import state_space_models as ssms

__all__ = [
    "MeanAndCov",
    "predict_step",
    "filter_step",
    "filter_step_asarray",
    "smoother_step",
    "MVLinearGauss",
    "MVLinearGauss_Guarniero_etal",
    "LinearGauss",
    "Kalman",
]


class MeanAndCov(NamedTuple):
    mean: torch.Tensor
    cov: torch.Tensor


def dotdotinv(a, b, c):
    """a @ b @ inv(c) for symmetric positive c, via a solve."""
    return torch.linalg.solve(c, (a @ b).T).T


def predict_step(F, covX, filt):
    """Predictive step: N(F m, F P F' + covX).  ``filt.mean`` may be (dx,)
    or (N, dx) — N predictions at once."""
    return MeanAndCov(mean=filt.mean @ F.T, cov=F @ filt.cov @ F.T + covX)


def filter_step(G, covY, pred, yt):
    """Filtering step and the log-density of Y_t given Y_{0:t-1}."""
    data_pred_mean = pred.mean @ G.T
    data_pred_cov = G @ pred.cov @ G.T + covY
    if covY.shape[0] == 1:
        yt1 = yt[..., 0] if yt.ndim >= 1 else yt
        logpyt = dists.Normal(loc=data_pred_mean[..., 0],
                              scale=torch.sqrt(data_pred_cov[0, 0])
                              ).logpdf(yt1)
    else:
        logpyt = dists.MvNormal(loc=data_pred_mean,
                                cov=data_pred_cov).logpdf(yt)
    residual = yt - data_pred_mean
    gain = dotdotinv(pred.cov, G.T, data_pred_cov)
    filt_mean = pred.mean + residual @ gain.T
    filt_cov = pred.cov - gain @ G @ pred.cov
    return MeanAndCov(mean=filt_mean, cov=filt_cov), logpyt


def filter_step_asarray(G, covY, pred, yt):
    """Filtering step for N predictive means at once: ``pred.mean`` is
    (N,) or (N, dx)."""
    pm = pred.mean[:, None] if pred.mean.ndim == 1 else pred.mean
    filt, logpyt = filter_step(G, covY, MeanAndCov(mean=pm, cov=pred.cov), yt)
    if pred.mean.ndim == 1:
        filt = MeanAndCov(mean=filt.mean[:, 0], cov=filt.cov)
    return filt, logpyt


def smoother_step(F, filt, next_pred, next_smth):
    """Rauch-Tung-Striebel backward smoothing step."""
    J = dotdotinv(filt.cov, F.T, next_pred.cov)
    smth_cov = filt.cov + J @ (next_smth.cov - next_pred.cov) @ J.T
    smth_mean = filt.mean + (next_smth.mean - next_pred.mean) @ J.T
    return MeanAndCov(mean=smth_mean, cov=smth_cov)


def _f32_matrix(v, device=None):
    return torch.atleast_2d(torch.as_tensor(v, dtype=torch.float32,
                                            device=device))


class MVLinearGauss(ssms.StateSpaceModel):
    r"""Multivariate linear Gaussian model:
    X_0 ~ N(mu0, cov0), X_t = F X_{t-1} + U_t, U_t ~ N(0, covX),
    Y_t = G X_t + V_t, V_t ~ N(0, covY).  Matrices are float32 tensors."""

    def __init__(self, F=None, G=None, covX=None, covY=None, mu0=None,
                 cov0=None, device=None):
        self.covX = _f32_matrix(covX, device)
        self.covY = _f32_matrix(covY, device)
        dev = self.covX.device
        dx, dy = self.covX.shape[0], self.covY.shape[0]
        self.mu0 = (torch.zeros(dx, device=dev) if mu0 is None
                    else torch.as_tensor(mu0, dtype=torch.float32, device=dev))
        self.cov0 = self.covX if cov0 is None else _f32_matrix(cov0, dev)
        self.F = torch.eye(dx, device=dev) if F is None else _f32_matrix(F, dev)
        self.G = (torch.eye(dy, dx, device=dev) if G is None
                  else _f32_matrix(G, dev))

    @property
    def dx(self):
        return self.covX.shape[0]

    @property
    def dy(self):
        return self.covY.shape[0]

    def PX0(self):
        return dists.MvNormal(loc=self.mu0, cov=self.cov0)

    def PX(self, t, xp):
        return dists.MvNormal(loc=xp @ self.F.T, cov=self.covX)

    def PY(self, t, xp, x):
        return dists.MvNormal(loc=x @ self.G.T, cov=self.covY)

    def proposal(self, t, xp, data):
        """The locally optimal proposal, by one filter step for the N
        particles at once."""
        pred = MeanAndCov(mean=xp @ self.F.T, cov=self.covX)
        f, _ = filter_step_asarray(self.G, self.covY, pred, data[t])
        return dists.MvNormal(loc=f.mean, cov=f.cov)

    def proposal0(self, data):
        f, _ = filter_step(self.G, self.covY,
                           MeanAndCov(mean=self.mu0, cov=self.cov0), data[0])
        return dists.MvNormal(loc=f.mean, cov=f.cov)

    def logeta(self, t, x, data):
        """The optimal auxiliary function, log p(y_{t+1} | x_t)."""
        pred = MeanAndCov(mean=x @ self.F.T, cov=self.covX)
        _, logpyt = filter_step_asarray(self.G, self.covY, pred, data[t + 1])
        return logpyt


class MVLinearGauss_Guarniero_etal(MVLinearGauss):
    r"""The Guarniero et al. (2016) benchmark: F[i,j] = alpha^(1+|i-j|),
    all covariances identity."""

    def __init__(self, alpha=0.4, dx=2, device=None):
        i = torch.arange(dx, dtype=torch.float32)
        F = alpha ** (1.0 + (i[:, None] - i[None, :]).abs())
        eye = torch.eye(dx)
        MVLinearGauss.__init__(self, F=F, G=eye, covX=eye, covY=eye,
                               device=device)


class LinearGauss(ssms.StateSpaceModel):
    r"""Univariate linear Gaussian model:
    X_0 ~ N(0, sigma0^2), X_t | X_{t-1} ~ N(rho X_{t-1}, sigmaX^2),
    Y_t | X_t ~ N(X_t, sigmaY^2).  ``sigma0=None`` means the stationary
    std sigmaX / sqrt(1 - rho^2).

    The Kalman matrices (``F``, ``G``, ``covX``, ``covY``, ``mu0``,
    ``cov0``) are built in float64 from the parameters, so that
    :class:`Kalman` on float64 data is a float64 oracle; on float32 data
    it rounds them to float32, as the JAX package does.
    """

    default_params = {"sigmaY": 0.2, "rho": 0.9, "sigmaX": 1.0, "sigma0": None}

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self.sigma0 is None:
            self.sigma0 = self.sigmaX / (1.0 - self.rho ** 2) ** 0.5

    @staticmethod
    def _m(v):
        return torch.as_tensor(v, dtype=torch.float64).reshape(1, 1)

    @property
    def F(self):
        return self._m(self.rho)

    @property
    def G(self):
        return self._m(1.0)

    @property
    def covX(self):
        return self._m(self.sigmaX ** 2)

    @property
    def covY(self):
        return self._m(self.sigmaY ** 2)

    @property
    def mu0(self):
        return torch.zeros(1, dtype=torch.float64)

    @property
    def cov0(self):
        return self._m(self.sigma0 ** 2)

    def PX0(self):
        return dists.Normal(scale=self.sigma0)

    def PX(self, t, xp):
        return dists.Normal(loc=self.rho * xp, scale=self.sigmaX)

    def PY(self, t, xp, x):
        return dists.Normal(loc=x, scale=self.sigmaY)

    def proposal0(self, data):
        """The law of X_0 given y_0 (the optimal proposal)."""
        sig2post = 1.0 / (1.0 / self.sigma0 ** 2 + 1.0 / self.sigmaY ** 2)
        mupost = sig2post * (data[0] / self.sigmaY ** 2)
        return dists.Normal(loc=mupost, scale=sig2post ** 0.5)

    def proposal(self, t, xp, data):
        """The law of X_t given X_{t-1} = xp and y_t (the optimal
        proposal)."""
        sig2post = 1.0 / (1.0 / self.sigmaX ** 2 + 1.0 / self.sigmaY ** 2)
        mupost = sig2post * (self.rho * xp / self.sigmaX ** 2
                             + data[t] / self.sigmaY ** 2)
        return dists.Normal(loc=mupost, scale=sig2post ** 0.5)

    def logeta(self, t, x, data):
        """The optimal auxiliary function, log p(y_{t+1} | x_t)."""
        law = dists.Normal(loc=self.rho * x,
                           scale=(self.sigmaX ** 2 + self.sigmaY ** 2) ** 0.5)
        return law.logpdf(data[t + 1])

    def upper_bound_log_pt(self, t):
        """log sup_x p(x_t | x_{t-1})."""
        return -0.5 * math.log(2.0 * math.pi) - math.log(float(self.sigmaX))


class Kalman:
    """Exact Kalman filter/smoother: ``filter()``, ``smoother()``,
    attributes ``pred``/``filt``/``smth`` (MeanAndCov of stacked (T, ...)
    tensors), ``logpyt`` and ``logLt``."""

    def __init__(self, ssm=None, data=None):
        self.ssm = ssm
        data = torch.as_tensor(data)
        if not data.is_floating_point():
            data = data.to(torch.float32)
        self.data = data[:, None] if data.ndim == 1 else data
        self.pred = None
        self.filt = None
        self.logpyt = None
        self.smth = None

    def _mat(self, v):
        return torch.as_tensor(v).to(dtype=self.data.dtype,
                                     device=self.data.device)

    def filter(self):
        """Forward recursion over all T observations."""
        ssm, data = self.ssm, self.data
        F, G = self._mat(ssm.F), self._mat(ssm.G)
        covX, covY = self._mat(ssm.covX), self._mat(ssm.covY)
        pred = MeanAndCov(mean=torch.atleast_1d(self._mat(ssm.mu0)),
                          cov=self._mat(ssm.cov0))
        preds, filts, logpyts = [], [], []
        for t in range(data.shape[0]):
            if t > 0:
                pred = predict_step(F, covX, filts[-1])
            filt, logpyt = filter_step(G, covY, pred, data[t])
            preds.append(pred)
            filts.append(filt)
            logpyts.append(logpyt)
        self.pred = MeanAndCov(mean=torch.stack([p.mean for p in preds]),
                               cov=torch.stack([p.cov for p in preds]))
        self.filt = MeanAndCov(mean=torch.stack([f.mean for f in filts]),
                               cov=torch.stack([f.cov for f in filts]))
        self.logpyt = torch.stack(logpyts)

    @property
    def logLt(self):
        """Exact log-likelihood log p(y_{0:T-1})."""
        if self.logpyt is None:
            self.filter()
        return self.logpyt.sum()

    def smoother(self):
        """Backward RTS recursion (runs the filter first if needed)."""
        if self.filt is None:
            self.filter()
        F = self._mat(self.ssm.F)
        T = self.data.shape[0]
        smth = MeanAndCov(mean=self.filt.mean[-1], cov=self.filt.cov[-1])
        smths = [smth]
        for t in range(T - 2, -1, -1):
            smth = smoother_step(
                F, MeanAndCov(mean=self.filt.mean[t], cov=self.filt.cov[t]),
                MeanAndCov(mean=self.pred.mean[t + 1],
                           cov=self.pred.cov[t + 1]),
                smth)
            smths.append(smth)
        smths.reverse()
        self.smth = MeanAndCov(mean=torch.stack([s.mean for s in smths]),
                               cov=torch.stack([s.cov for s in smths]))
