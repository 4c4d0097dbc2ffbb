"""State-space models and their Feynman-Kac adapters (PyTorch port).

Counterpart of ``particles_tpu/state_space_models.py``: the model-as-class
DSL — subclass :class:`StateSpaceModel` and define ``PX0``/``PX``/``PY``
returning :mod:`particles_tpu_torch.distributions` objects, and optionally
``proposal0``/``proposal``/``logeta`` for the guided and auxiliary
filters — the adapters ``Bootstrap``, ``GuidedPF``, ``AuxiliaryPF`` and
``AuxiliaryBootstrap``, and the model zoo (``StochVol`` to
``ThetaLogistic``).

The engine calls the models with ``t`` a Python int, so a model that
branches on "t == 0" tests ``isinstance(t, int) and t == 0`` as in the JAX
package.  Parameters are Python floats or tensors on the run's device
(``convert.ssm_from_params`` builds either from numpy).
"""

from __future__ import annotations

import math

import torch

import particles_tpu_torch.distributions as dists
from particles_tpu_torch.core import FeynmanKac
from particles_tpu_torch.utils import KwParams, resolve_device

__all__ = [
    "StateSpaceModel",
    "Bootstrap",
    "GuidedPF",
    "APFMixin",
    "AuxiliaryPF",
    "AuxiliaryBootstrap",
    "StochVol",
    "StochVolLeverage",
    "Gordon_etal",
    "BearingsOnly",
    "DiscreteCox",
    "MVStochVol",
    "ThetaLogistic",
]


class StateSpaceModel(KwParams):
    """Base class for state-space models::

        class LinearGauss(StateSpaceModel):
            default_params = {'rho': 0.9, 'sigmaX': 1., 'sigmaY': .1}
            def PX0(self):
                return dists.Normal(scale=self.sigmaX)
            def PX(self, t, xp):
                return dists.Normal(loc=self.rho * xp, scale=self.sigmaX)
            def PY(self, t, xp, x):
                return dists.Normal(loc=x, scale=self.sigmaY)

    ``default_params`` merge with the constructor's keywords and become
    attributes (Python floats or 0-d tensors).
    """

    def _error_msg(self, method):
        return (f"method {method} not implemented in class "
                f"{self.__class__.__name__}")

    def PX0(self):
        """Law of X_0."""
        raise NotImplementedError(self._error_msg("PX0"))

    def PX(self, t, xp):
        """Law of X_t given X_{t-1} = xp."""
        raise NotImplementedError(self._error_msg("PX"))

    def PY(self, t, xp, x):
        """Law of Y_t given X_t = x (and possibly X_{t-1} = xp)."""
        raise NotImplementedError(self._error_msg("PY"))

    def proposal0(self, data):
        """Proposal law of X_0 for the guided filters."""
        raise NotImplementedError(self._error_msg("proposal0"))

    def proposal(self, t, xp, data):
        """Proposal law of X_t given X_{t-1} = xp for the guided filters."""
        raise NotImplementedError(self._error_msg("proposal"))

    def upper_bound_log_pt(self, t):
        """An upper bound of log p(x_t | x_{t-1}), for the rejection
        smoothers (``backward_sampling_reject``, ``Paris``)."""
        raise NotImplementedError(self._error_msg("upper_bound_log_pt"))

    def add_func(self, t, xp, x):
        """The additive function psi_t(x_{t-1}, x_t) of the on-line
        smoothers (called with ``xp=None`` at t=0)."""
        raise NotImplementedError(self._error_msg("add_func"))

    def simulate_given_x(self, gen, x):
        """Observations given a state trajectory (stacked (T, ...))."""
        T = x.shape[0]
        ys = [self.PY(0, None, x[0:1]).rvs(gen, size=1)]
        for t in range(1, T):
            ys.append(self.PY(t, x[t - 1:t], x[t:t + 1]).rvs(gen, size=1))
        return torch.cat(ys, 0)

    def simulate(self, gen, T):
        """Simulate states and observations up to time T-1: stacked
        ``x`` (T, ...) and ``y`` (T, ...), on the generator's device."""
        xs = [self.PX0().rvs(gen, size=1)]
        for t in range(1, T):
            xs.append(self.PX(t, xs[-1]).rvs(gen, size=1))
        x = torch.cat(xs, 0)
        return x, self.simulate_given_x(gen, x)


class Bootstrap(FeynmanKac):
    """Bootstrap Feynman-Kac formalism of a state-space model: particles
    move by the model's transition and are weighted by the likelihood of
    the data.

    ``data`` that is not a tensor (a numpy array, a list) becomes a
    float32 tensor on ``device``, by default the current CUDA card (with
    no card, pass ``device="cpu"``); a tensor keeps its device."""

    def __init__(self, ssm=None, data=None, device=None):
        self.ssm = ssm
        if data is not None and not isinstance(data, torch.Tensor):
            data = torch.as_tensor(data, dtype=torch.float32,
                                   device=resolve_device(device))
        self.data = data

    @property
    def T(self):
        return 0 if self.data is None else self.data.shape[0]

    @property
    def du(self):
        return self.ssm.PX0().dim

    def M0(self, gen, N):
        return self.ssm.PX0().rvs(gen, size=N)

    def M(self, gen, t, xp):
        return self.ssm.PX(t, xp).rvs(gen, size=xp.shape[0])

    def logG(self, t, xp, x):
        return self.ssm.PY(t, xp, x).logpdf(self.data[t])

    def Gamma0(self, u):
        return self.ssm.PX0().ppf(u)

    def Gamma(self, t, xp, u):
        return self.ssm.PX(t, xp).ppf(u)

    def logpt(self, t, xp, x):
        """Log-pdf of X_t | X_{t-1} = xp."""
        return self.ssm.PX(t, xp).logpdf(x)

    def upper_bound_trans(self, t):
        return self.ssm.upper_bound_log_pt(t)

    def add_func(self, t, xp, x):
        return self.ssm.add_func(t, xp, x)


class GuidedPF(Bootstrap):
    """Guided particle filter: particles move by the model's proposal
    kernels (``proposal0``, ``proposal``) and are weighted by the
    likelihood times the ratio of the transition to the proposal."""

    def M0(self, gen, N):
        return self.ssm.proposal0(self.data).rvs(gen, size=N)

    def M(self, gen, t, xp):
        return self.ssm.proposal(t, xp, self.data).rvs(gen, size=xp.shape[0])

    def logG(self, t, xp, x):
        if isinstance(t, int) and t == 0:
            return (self.ssm.PX0().logpdf(x)
                    + self.ssm.PY(0, xp, x).logpdf(self.data[0])
                    - self.ssm.proposal0(self.data).logpdf(x))
        return (self.ssm.PX(t, xp).logpdf(x)
                + self.ssm.PY(t, xp, x).logpdf(self.data[t])
                - self.ssm.proposal(t, xp, self.data).logpdf(x))

    def Gamma0(self, u):
        return self.ssm.proposal0(self.data).ppf(u)

    def Gamma(self, t, xp, u):
        return self.ssm.proposal(t, xp, self.data).ppf(u)


class APFMixin:
    """The auxiliary function of an auxiliary particle filter: the model's
    ``logeta(t, x, data)``, a guess of log p(y_{t+1} | x_t).  A mixin goes
    first in the bases, so that no default of the other base hides it."""

    def logeta(self, t, x):
        return self.ssm.logeta(t, x, self.data)


class AuxiliaryPF(APFMixin, GuidedPF):
    """Auxiliary particle filter: guided proposals, resampling on the
    auxiliary weights."""


class AuxiliaryBootstrap(APFMixin, Bootstrap):
    """Auxiliary particle filter with the bootstrap (transition) proposal."""


# ---------------------------------------------------------------------------
# the model zoo
# ---------------------------------------------------------------------------

def _exp(v):
    return torch.exp(v) if isinstance(v, torch.Tensor) else math.exp(v)


def _cos(v):
    return torch.cos(v) if isinstance(v, torch.Tensor) else math.cos(v)


class StochVol(StateSpaceModel):
    r"""Univariate stochastic volatility model (Pitt & Shephard 1999):
    X_0 ~ N(mu, sigma^2 / (1 - rho^2)), X_t = mu + rho (X_{t-1} - mu) +
    sigma U_t, Y_t | X_t ~ N(0, e^{X_t}).  Its proposals and ``logeta``
    are Pitt and Shephard's, from a second-order expansion of the
    likelihood about E[X_t | X_{t-1}]."""

    default_params = {"mu": -1.02, "rho": 0.9702, "sigma": 0.178}

    def sig0(self):
        return self.sigma / (1.0 - self.rho ** 2) ** 0.5

    def PX0(self):
        return dists.Normal(loc=self.mu, scale=self.sig0())

    def EXt(self, xp):
        return (1.0 - self.rho) * self.mu + self.rho * xp

    def PX(self, t, xp):
        return dists.Normal(loc=self.EXt(xp), scale=self.sigma)

    def PY(self, t, xp, x):
        return dists.Normal(loc=0.0, scale=torch.exp(0.5 * x))

    def _xhat(self, xst, sig, yt):
        return xst + 0.5 * sig ** 2 * (yt ** 2 * _exp(-xst) - 1.0)

    def proposal0(self, data):
        return dists.Normal(loc=self._xhat(0.0, self.sig0(), data[0]),
                            scale=self.sig0())

    def proposal(self, t, xp, data):
        return dists.Normal(loc=self._xhat(self.EXt(xp), self.sigma, data[t]),
                            scale=self.sigma)

    def logeta(self, t, x, data):
        xst = self.EXt(x)
        xstmmu = xst - self.mu
        xhatmmu = self._xhat(xst, self.sigma, data[t + 1]) - self.mu
        return (0.5 / self.sigma ** 2 * (xhatmmu ** 2 - xstmmu ** 2)
                - 0.5 * data[t + 1] ** 2 * torch.exp(-xst) * (1.0 + xstmmu))


class StochVolLeverage(StochVol):
    r"""Stochastic volatility with leverage: the state and observation
    noises have correlation phi."""

    default_params = {"mu": -1.02, "rho": 0.9702, "sigma": 0.178, "phi": 0.0}

    def PY(self, t, xp, x):
        if isinstance(t, int) and t == 0:
            u = (x - self.mu) / self.sig0()
        else:
            u = (x - self.EXt(xp)) / self.sigma
        std_x = torch.exp(0.5 * x)
        return dists.Normal(loc=std_x * self.phi * u,
                            scale=std_x * (1.0 - self.phi ** 2) ** 0.5)


class Gordon_etal(StateSpaceModel):
    r"""The nonlinear toy model of Gordon et al. (1993)."""

    default_params = {"a": 0.05, "b": 0.5, "c": 25.0, "d": 8.0, "e": 1.2,
                      "sigmaX": 3.162278}   # sqrt(10)

    def PX0(self):
        return dists.Normal(scale=2.0)

    def PX(self, t, xp):
        return dists.Normal(
            loc=(self.b * xp + self.c * xp / (1.0 + xp ** 2)
                 + self.d * _cos(self.e * (t - 1.0))),
            scale=self.sigmaX)

    def PY(self, t, xp, x):
        return dists.Normal(loc=self.a * x ** 2)


class BearingsOnly(StateSpaceModel):
    """Bearings-only tracking: (N, 4) states, position and velocity."""

    default_params = {"sigmaX": 2.0e-4, "sigmaY": 1e-3,
                      "x0": (3e-3, -3e-3, 1.0, 1.0)}

    def PX0(self):
        return dists.IndepProd(
            dists.Normal(loc=self.x0[0], scale=self.sigmaX),
            dists.Normal(loc=self.x0[1], scale=self.sigmaX),
            dists.Dirac(loc=self.x0[2]),
            dists.Dirac(loc=self.x0[3]))

    def PX(self, t, xp):
        return dists.IndepProd(
            dists.Normal(loc=xp[:, 0], scale=self.sigmaX),
            dists.Normal(loc=xp[:, 1], scale=self.sigmaX),
            dists.Dirac(loc=xp[:, 0] + xp[:, 2]),
            dists.Dirac(loc=xp[:, 1] + xp[:, 3]))

    def PY(self, t, xp, x):
        angle = torch.atan(x[:, 3] / x[:, 2])
        angle = angle + torch.where(x[:, 2] < 0.0, math.pi, 0.0)
        return dists.Normal(loc=angle, scale=self.sigmaY)


class DiscreteCox(StateSpaceModel):
    r"""Discrete Cox (log-Gaussian Poisson) model: a Gaussian AR(1) state
    and Y_t | X_t ~ Poisson(e^{X_t})."""

    default_params = {"mu": 0.0, "sigma": 1.0, "phi": 0.95}

    def PX0(self):
        return dists.Normal(loc=self.mu,
                            scale=self.sigma / (1.0 - self.phi ** 2) ** 0.5)

    def PX(self, t, xp):
        return dists.Normal(loc=self.mu + self.phi * (xp - self.mu),
                            scale=self.sigma)

    def PY(self, t, xp, x):
        return dists.Poisson(rate=torch.exp(x))


class MVStochVol(StateSpaceModel):
    """Multivariate stochastic volatility: a VAR(1) log-volatility ``F``
    about ``mu`` with noise ``covX``, observations with correlation
    ``corY`` (tensors, (d,) and (d, d))."""

    default_params = {"mu": 0.0, "covX": None, "corY": None, "F": None}

    def _mu(self):
        return torch.as_tensor(self.mu, dtype=self.F.dtype,
                               device=self.F.device).expand(self.F.shape[0])

    def offset(self):
        mu = self._mu()
        return mu - mu @ self.F.T

    def PX0(self):
        return dists.MvNormal(loc=self._mu(), cov=self.covX)

    def PX(self, t, xp):
        return dists.MvNormal(loc=xp @ self.F.T + self.offset(),
                              cov=self.covX)

    def PY(self, t, xp, x):
        return dists.MvNormal(scale=torch.exp(0.5 * x), cov=self.corY)


class ThetaLogistic(StateSpaceModel):
    r"""Theta-Logistic population model (Peters et al. 2010), with the
    proposals of the conjugate Gaussian update."""

    default_params = {"tau0": 0.15, "tau1": 0.12, "tau2": 0.1,
                      "sigmaX": 0.47, "sigmaY": 0.39}

    def PX0(self):
        return dists.Normal(loc=0.0, scale=1.0)

    def PX(self, t, xp):
        return dists.Normal(
            loc=xp + self.tau0 - self.tau1 * torch.exp(self.tau2 * xp),
            scale=self.sigmaX)

    def PY(self, t, xp, x):
        return dists.Normal(loc=x, scale=self.sigmaY)

    def proposal0(self, data):
        return self.PX0().posterior(data[0:1], sigma=self.sigmaY)

    def proposal(self, t, xp, data):
        return self.PX(t, xp).posterior(data[t][None], sigma=self.sigmaY)
