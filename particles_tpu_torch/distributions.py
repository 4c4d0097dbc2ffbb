"""Probability distributions (PyTorch port, first slice).

Counterpart of ``particles_tpu/distributions.py``: the ``ProbDist``
protocol (``rvs``, ``logpdf``, ``ppf``, ``dim``, ``dtype``),
``LocScaleDist``, ``Normal`` and ``MvNormal``.  The rest of the zoo is
ROADMAP A.5.

``rvs(gen, size=None)`` takes a ``torch.Generator`` where the JAX package
takes a key, and draws on the generator's device.  Parameters may be
Python floats or tensors; an (N,) parameter makes the distribution an
array of N distributions, as in the JAX package.  Draws are float32
unless a parameter is a tensor of another floating dtype.
"""

from __future__ import annotations

import math

import torch

__all__ = ["ProbDist", "LocScaleDist", "Normal", "MvNormal"]

HALFLOG2PI = 0.5 * math.log(2.0 * math.pi)


def _float_dtype(*params):
    dt = None
    for p in params:
        if isinstance(p, torch.Tensor) and p.is_floating_point():
            dt = p.dtype if dt is None else torch.promote_types(dt, p.dtype)
    return torch.float32 if dt is None else dt


def _param_size(*params):
    """Leading dimension implied by broadcasting the parameters (or None)."""
    shape = torch.broadcast_shapes(
        *(p.shape for p in params if isinstance(p, torch.Tensor)))
    return shape[0] if len(shape) else None


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


class ProbDist:
    """Base class for probability distributions: ``logpdf(x)``,
    ``rvs(gen, size=None)`` and optionally ``ppf(u)``, plus ``dim`` and
    ``dtype``."""

    dim = 1
    dtype = "float32"

    def shape(self, size):
        if size is None:
            return None
        return (size,) if self.dim == 1 else (size, self.dim)

    def _draw_shape(self, size, *params):
        if size is None:
            size = _param_size(*params)
        if size is None:
            return ()
        return self.shape(size)

    def logpdf(self, x):
        raise NotImplementedError

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def rvs(self, gen, size=None):
        raise NotImplementedError

    def ppf(self, u):
        raise NotImplementedError


class LocScaleDist(ProbDist):
    """Base class for location-scale families."""

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = loc
        self.scale = scale


class Normal(LocScaleDist):
    """N(loc, scale^2)."""

    def rvs(self, gen, size=None):
        shape = self._draw_shape(size, self.loc, self.scale)
        z = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=_float_dtype(self.loc, self.scale))
        return self.loc + self.scale * z

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - _log(self.scale) - HALFLOG2PI

    def ppf(self, u):
        return self.loc + self.scale * torch.special.ndtri(u)


class MvNormal(ProbDist):
    """Multivariate normal N(loc, diag(scale) @ cov @ diag(scale)).

    ``loc``/``scale`` may be (d,) or (N, d); ``cov`` is a fixed (d, d)
    matrix whose Cholesky factor is computed once, at construction.
    """

    def __init__(self, loc=0.0, scale=1.0, cov=None):
        if cov is None:
            loc = torch.as_tensor(loc)
            if loc.ndim == 0:
                raise ValueError(
                    "MvNormal: cannot infer the dimension — pass a (d,) or "
                    "(N, d) loc, or an explicit (d, d) cov")
            cov = torch.eye(loc.shape[-1], dtype=_float_dtype(loc),
                            device=loc.device)
        self.cov = torch.as_tensor(cov)
        self.loc = torch.as_tensor(loc, dtype=self.cov.dtype,
                                   device=self.cov.device)
        self.scale = scale
        self.L = torch.linalg.cholesky(self.cov)

    @property
    def dim(self):
        return self.cov.shape[-1]

    def logpdf(self, x):
        halflogdetcor = torch.log(torch.diagonal(self.L)).sum()
        scale = torch.as_tensor(self.scale, dtype=self.L.dtype,
                                device=self.L.device)
        xc = (x - self.loc) / scale
        was_1d = xc.ndim == 1
        z = torch.linalg.solve_triangular(self.L, torch.atleast_2d(xc).T,
                                          upper=False)
        if scale.ndim == 0:
            logdet = self.dim * torch.log(scale)
        else:
            logdet = torch.log(scale).sum(-1)
        out = (-0.5 * (z * z).sum(0) - (logdet + halflogdetcor)
               - self.dim * HALFLOG2PI)
        return out[0] if was_1d else out

    def rvs(self, gen, size=None):
        if size is None:
            sh = torch.broadcast_shapes(
                self.loc.shape, torch.as_tensor(self.scale).shape)
            size = 1 if len(sh) <= 1 else sh[0]
        z = torch.randn((size, self.dim), generator=gen, device=gen.device,
                        dtype=self.L.dtype)
        return self.loc + self.scale * (z @ self.L.T)
