"""State-space models and the bootstrap filter (PyTorch port, first slice).

Counterpart of ``particles_tpu/state_space_models.py``: the model-as-class
DSL — subclass :class:`StateSpaceModel` and define ``PX0``/``PX``/``PY``
returning :mod:`particles_tpu_torch.distributions` objects — and the
``Bootstrap`` Feynman-Kac adapter.  ``GuidedPF``, the auxiliary filters and
the model zoo are ROADMAP A.5.
"""

from __future__ import annotations

import torch

from particles_tpu_torch.core import FeynmanKac
from particles_tpu_torch.utils import KwParams, resolve_device

__all__ = ["StateSpaceModel", "Bootstrap"]


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
