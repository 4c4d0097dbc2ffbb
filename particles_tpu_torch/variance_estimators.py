"""Single-run variance estimators from the genealogy (PyTorch port).

Counterpart of ``particles_tpu/variance_estimators.py``: the Chan & Lai
(2013) / Lee & Whiteley (2018) estimators through the eve variables
(``var_estimate``, the eve indices as collector state) and the lag-based
estimates of Olsson & Douc (2019).  The sum over the eve variables'
branches is ``index_add_``.
"""

from __future__ import annotations

import torch

from particles_tpu_torch import collectors as col
from particles_tpu_torch import smoothing

__all__ = ["var_estimate", "Var", "Var_logLt", "Lag_based_var", "VarColMixin"]


def _sum_over_branches(w_phi, B):
    """sum_n (sum_{m: B[m] = n} w_phi[m])^2, along the particle axis."""
    s = torch.zeros_like(w_phi).index_add_(0, B, w_phi)
    return (s * s).sum(0)


def var_estimate(W, phi_x, B):
    """Genealogy-based variance estimate of the weighted mean of ``phi_x``
    ((N,) or (N, d)) with eve variables ``B``.  It is 0 where the genealogy
    has coalesced (B constant), as a masked select: no host read."""
    phi_x = torch.as_tensor(phi_x)
    Wc = W[:, None] if phi_x.ndim == 2 else W
    w_phi = Wc * (phi_x - (Wc * phi_x).sum(0))
    out = _sum_over_branches(w_phi, B)
    collapsed = (B == B[0]).all()
    return torch.where(collapsed, torch.zeros_like(out), out)


class VarColMixin:
    """Eve variables as collector state: ``B = arange(N)`` at t=0, then
    ``B = B[A_t]``."""

    stateful = True

    def init(self, view):
        B = torch.arange(view.N, device=view.wgts.W.device)
        return B, self._fetch(view, B)

    def step(self, view, B):
        B = B.index_select(0, view.A)
        return B, self._fetch(view, B)


class Var(VarColMixin, col.Collector):
    """Variance estimates of the weighted mean of ``phi`` (default: the
    identity)."""

    summary_name = "var"
    signature = {"phi": None}

    def test_func(self, x):
        return x if self.phi is None else self.phi(x)

    def _fetch(self, view, B):
        return var_estimate(view.wgts.W, self.test_func(view.X), B)


class Var_logLt(VarColMixin, col.Collector):
    """Variance estimate of the logLt estimator."""

    summary_name = "var_logLt"

    def _fetch(self, view, B):
        return _sum_over_branches(view.wgts.W, B)


class Lag_based_var(col.Collector):
    """Lag-based variance estimates over a window of the last ``lag``
    ancestor vectors: at each t a (lag + 1,) tensor whose element i is the
    estimate based on lag i."""

    summary_name = "lag_based_var"
    signature = {"phi": None, "lag": 5}
    stateful = True

    def test_func(self, x):
        return x if self.phi is None else self.phi(x)

    def _estimates(self, view, Abuf):
        last = torch.arange(view.N, device=view.wgts.W.device)
        phi_x = self.test_func(view.X)
        ests = [var_estimate(view.wgts.W, phi_x, B)
                for B in smoothing._genealogy(Abuf, last)]
        return torch.stack(ests[::-1])

    def init(self, view):
        ar = torch.arange(view.N, device=view.wgts.W.device)
        Abuf = (ar,) * self.lag
        return Abuf, self._estimates(view, Abuf)

    def step(self, view, Abuf):
        Abuf = (Abuf[1:] + (view.A,)) if self.lag else ()
        return Abuf, self._estimates(view, Abuf)
