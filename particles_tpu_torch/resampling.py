"""Log-space weight numerics and resampling (PyTorch port, first slice).

Counterpart of ``particles_tpu/resampling.py``: the numerics
(``exp_and_normalise``, ``essl``, ``log_sum_exp``, ``log_sum_exp_ab``,
``log_mean_exp``, ``wmean_and_var``), the :class:`Weights` container, and
the scheme registries selected by name.  Of the schemes only
``systematic`` is ported; the others raise ``NotImplementedError``
(ROADMAP A.4).

Randomness is an explicit ``torch.Generator`` where the JAX package takes
a key: ``resampling(scheme, gen, W, M)``.
"""

from __future__ import annotations

import torch

from particles_tpu_torch.ops import ancestors_by_z, systematic_z_fused

__all__ = [
    "Weights",
    "exp_and_normalise",
    "essl",
    "log_sum_exp",
    "log_sum_exp_ab",
    "log_mean_exp",
    "wmean_and_var",
    "resampling",
    "resampling_z",
    "rs_funcs",
    "rs_z_funcs",
    "systematic",
    "systematic_z",
]

# schemes of the JAX package that this slice does not port yet
_UNPORTED_SCHEMES = ("multinomial", "residual", "stratified", "ssp",
                     "killing", "idiotic")


# ---------------------------------------------------------------------------
# log-space numerics
# ---------------------------------------------------------------------------

def exp_and_normalise(lw):
    """Exponentiate then normalise log-weights, robustly."""
    w = torch.exp(lw - lw.max())
    return w / w.sum()


def essl(lw):
    """ESS (effective sample size) of log-weights."""
    W = exp_and_normalise(lw)
    return 1.0 / (W * W).sum()


def log_sum_exp(v):
    """log(sum(exp(v))), numerically stable."""
    m = v.max()
    return m + torch.log(torch.exp(v - m).sum())


def log_sum_exp_ab(la, lb):
    """log(exp(la) + exp(lb)), elementwise."""
    la, lb = torch.as_tensor(la), torch.as_tensor(lb)
    big = torch.maximum(la, lb)
    small = torch.minimum(la, lb)
    return big + torch.log1p(torch.exp(small - big))


def log_mean_exp(v, W=None, lw=None):
    """log of the (possibly weighted) average of exp(v).

    Pass ``lw`` (unnormalised log-weights) instead of ``W`` when available:
    a normalised f32 ``W`` has already lost every particle whose weight
    underflowed (lw spread > ~88).  The weighted forms are stabilised by
    ``max(v + log w)``, not ``max(v)``: in f32 the max-v particle can carry
    almost no weight, and then every term underflows.
    """
    if W is None and lw is None:
        m = v.max()
        return m + torch.log(torch.exp(v - m).sum() / v.shape[0])
    s = v + (torch.log(W) if lw is None else lw)
    m = s.max()
    out = m + torch.log(torch.exp(s - m).sum())
    if lw is None:
        return out
    return out - log_sum_exp(lw)


def wmean_and_var(W, x):
    """Weighted mean and variance along the particle axis (axis 0):
    ``{'mean': m, 'var': v}``."""
    Wc = W.reshape((-1,) + (1,) * (x.ndim - 1))
    m = (Wc * x).sum(0)
    m2 = (Wc * x * x).sum(0)
    return {"mean": m, "var": m2 - m * m}


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

class Weights:
    """N log-weights and what derives from them: normalised weights ``W``,
    effective sample size ``ESS`` and ``log_mean``, the log of the average
    unnormalised weight.  NaN log-weights count as -inf.  ``Weights()``
    (no argument) stands for equal weights.
    """

    __slots__ = ("lw", "W", "ESS", "log_mean")

    def __init__(self, lw=None):
        self.lw = lw
        if lw is None:
            self.W = self.ESS = self.log_mean = None
            return
        lw = torch.nan_to_num(lw, nan=-torch.inf, posinf=torch.inf,
                              neginf=-torch.inf)
        self.lw = lw
        m = lw.max()
        w = torch.exp(lw - m)
        s = w.sum()
        self.log_mean = m + torch.log(s / lw.shape[0])
        self.W = w / s
        self.ESS = 1.0 / (self.W * self.W).sum()

    @property
    def N(self):
        return 0 if self.lw is None else self.lw.shape[0]

    def add(self, delta):
        """New Weights with lw incremented by ``delta``."""
        if self.lw is None:
            return Weights(lw=delta)
        return Weights(lw=self.lw + delta)


# ---------------------------------------------------------------------------
# scheme registries
# ---------------------------------------------------------------------------

def _unported(scheme):
    if scheme in _UNPORTED_SCHEMES:
        return NotImplementedError(
            f"resampling scheme {scheme!r} is not ported to particles_tpu_torch "
            "yet (ROADMAP A.4); 'systematic' is")
    return ValueError(f"{scheme} is not a valid resampling scheme")


def systematic_z(gen, W, M=None):
    """Systematic z-form: ``z_i = #{j: (j + u)/M <= cs_i}``, computed by
    the fixed-point kernel (:func:`particles_tpu_torch.ops.
    systematic_z_fused`); one uniform ``u`` drawn from ``gen``."""
    M = W.shape[0] if M is None else M
    u = torch.rand((), generator=gen, device=W.device, dtype=torch.float32)
    return systematic_z_fused(W, u, M)


def systematic(gen, W, M=None):
    """Systematic resampling: (M,) sorted ancestor indices (int64)."""
    M = W.shape[0] if M is None else M
    return ancestors_by_z(systematic_z(gen, W, M), M)


rs_funcs = {"systematic": systematic}
rs_z_funcs = {"systematic": systematic_z}


def resampling(scheme, gen, W, M=None):
    """Ancestor indices of scheme ``scheme`` (by name)."""
    if scheme not in rs_funcs:
        raise _unported(scheme)
    return rs_funcs[scheme](gen, W, M)


def resampling_z(scheme, gen, W, M=None):
    """z-form of a sorted-ancestor scheme: (N,) int32 nondecreasing with
    ``z[-1] == M``; the move is ``Y[j] = X[#{k: z_k <= j}]``."""
    if scheme not in rs_z_funcs:
        raise _unported(scheme)
    return rs_z_funcs[scheme](gen, W, M)
