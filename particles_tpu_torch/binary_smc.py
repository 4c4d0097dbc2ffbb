"""SMC on binary spaces {0,1}^d: Bayesian variable selection (PyTorch port).

Counterpart of ``particles_tpu/binary_smc.py``: the nested-logistic
proposal (:class:`NestedLogistic`), its independent-Metropolis move
(:class:`BinaryMetropolis`) and the variable-selection likelihoods
(:class:`BIC`, :class:`BayesianVS`, :class:`BayesianVS_gprior`) built on
:func:`chol_and_friends`.

How this port runs them:

* **One batched Cholesky a block of particles.**  The marginal likelihood
  of every particle is the Cholesky of its (p, p) Gram matrix with the
  excluded rows and columns replaced by the identity
  (``torch.linalg.cholesky_ex``, no host read), in blocks of
  ``CHOL_CHUNK`` elements, so that N0 = 30,000 particles at p = 103 never
  hold more than a few (block, p, p) temporaries.
* **The proposal's fit is one batch of d Newton solves.**  The masked
  ridge-IRLS of the JAX package (8 Newton steps, vmapped over the d rows)
  is one (d, d + 1, d + 1) ``solve_ex`` a step; each row's masked Gram
  matrix is the full weighted Gram matrix times the row's mask, built in
  blocks of rows of ``FIT_CHUNK`` elements.
* **The proposal draws column by column.**  Column i of a draw depends
  only on columns < i, so round i computes that column alone (one
  matrix-vector product), where the JAX package recomputes all d
  probabilities in each of its d rounds: the same function, d times
  less work.
* **Every move is a function of its draws**: :meth:`BinaryMetropolis.draws`
  then :meth:`BinaryMetropolis.step_with`, in the JAX package's split
  order (the proposal's (N, d) uniforms, then the N accept uniforms).

The state is a bool (N, p) leaf ``gamma``: the resampling move serves it
through B2 as 1-byte elements.  Entry points put numpy data on the current
CUDA card unless given ``device="cpu"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from particles_tpu_torch import distributions as dists
from particles_tpu_torch import smc_samplers as ssps
from particles_tpu_torch.utils import resolve_device

__all__ = [
    "all_binary_words",
    "Bernoulli",
    "log_no_warn",
    "corr_bin",
    "NestedLogistic",
    "BinaryMetropolis",
    "chol_and_friends",
    "VariableSelection",
    "BIC",
    "BayesianVS",
    "BayesianVS_gprior",
]

# elements of one (block, p, p) tensor of chol_and_friends (128 MiB of
# float32), and of one (rows, N, d) block of the fit's Gram matrices
CHOL_CHUNK = 2 ** 25
FIT_CHUNK = 2 ** 25


def all_binary_words(p, device=None):
    """(2^p, p) bool tensor of all binary words, word k the bits of k
    (reference binary_smc.py:54-60), on ``device`` (by default the
    current CUDA card)."""
    ns = torch.arange(2 ** p, device=resolve_device(device))
    bits = torch.arange(p, device=ns.device)
    return ((ns[:, None] >> bits) & 1).bool()


def log_no_warn(x):
    """log(x) with x clipped below at 1e-30: a tensor for a tensor, a
    float for a number."""
    if isinstance(x, torch.Tensor):
        return torch.log(x.clamp(min=1e-30))
    return math.log(max(float(x), 1e-30))


class Bernoulli(dists.ProbDist):
    """Bernoulli law over booleans (reference binary_smc.py:67-80).  With a
    number ``p`` its ``logpdf`` is elementwise, so ``IID(Bernoulli(p), k)``
    takes (N, k) values in one call."""

    dtype = "bool"

    def __init__(self, p):
        self.p = p

    @property
    def elementwise(self):
        return not isinstance(self.p, torch.Tensor) or self.p.ndim == 0

    def rvs(self, gen, size=None):
        if size is None:
            size = (self.p.shape[0] if isinstance(self.p, torch.Tensor)
                    and self.p.ndim >= 1 else 1)
        return torch.rand(size, generator=gen, device=gen.device) < self.p

    def logpdf(self, x):
        return torch.where(x, log_no_warn(self.p), log_no_warn(1.0 - self.p))


def corr_bin(pi, pj, pij):
    """Correlation of two binary variables from their means and the mean
    of their product (0 where either is constant)."""
    varij = pi * (1.0 - pi) * pj * (1.0 - pj)
    return torch.where(varij > 0, (pij - pi * pj) / torch.sqrt(varij + 1e-30),
                       0.0)


class NestedLogistic(dists.DiscreteDist):
    """Nested logistic proposal (reference binary_smc.py:83-143): component
    i is Bernoulli(coeffs[i, i]) if "edgy" (probability near 0 or 1), else
    logistic in the components before it.

    ``coeffs`` is a (d, d) float32 tensor, lower triangular (the diagonal
    the intercept, or the raw probability of an edgy component); ``edgy``
    a (d,) bool tensor.
    """

    dtype = "bool"

    def __init__(self, coeffs, edgy):
        self.coeffs = coeffs
        self.edgy = edgy
        self.dim = edgy.shape[0]
        self._lower = torch.tril(coeffs, -1)
        self._diag = torch.diagonal(coeffs)

    def _probs(self, x):
        """(N, d) conditional probabilities of each component given the
        components of ``x`` before it."""
        lin = x.float() @ self._lower.T + self._diag
        return torch.where(self.edgy, self._diag, torch.sigmoid(lin))

    def rvs_with(self, u):
        """The draw given its (N, d) uniforms: column i is 1 where ``u[:, i]``
        is below its probability given columns < i, computed alone in two
        kernels: a matrix-vector product gives the logit ``lin``, and
        ``logit(u) < lin`` is ``u < sigmoid(lin)`` (the two differ only
        where u and the probability round to each other).  An edgy
        component's row of ``coeffs`` is zero below the diagonal, and its
        test ``u < coeffs[i, i]`` is made beforehand for all columns at
        once: its threshold becomes -inf (draw 1) or +inf (draw 0)."""
        thresh = torch.where(
            self.edgy, torch.where(u < self._diag, -torch.inf, torch.inf),
            torch.logit(u)).T.contiguous()
        out = torch.zeros_like(thresh)      # (d, N): a column is a row
        for i in range(self.dim):
            torch.gt(torch.addmv(self._diag[i], out.T, self._lower[i]),
                     thresh[i], out=out[i])
        return out.T.contiguous().bool()

    def rvs(self, gen, size=1):
        u = torch.rand((size, self.dim), generator=gen, device=gen.device)
        return self.rvs_with(u)

    def logpdf(self, x):
        probs = self._probs(x)
        lp = torch.where(x, log_no_warn(probs), log_no_warn(1.0 - probs))
        return lp.sum(1)

    @classmethod
    def fit(cls, W, x, probs_thresh=0.02, corr_thresh=0.075, newton_steps=8,
            ridge=1e-3):
        """Fit to the weighted cloud (``W`` (N,), ``x`` (N, d) bool) by the
        JAX package's masked ridge-IRLS: component i regresses on the
        components before it whose correlation with it passes
        ``corr_thresh`` (none for an edgy one), ``newton_steps`` Newton
        steps from the logit of its mean, all d rows one batch."""
        xf = x.float()
        N, d = xf.shape
        Wc = W[:, None]
        ph = (Wc * xf).sum(0)
        edgy = (ph < probs_thresh) | (ph > 1.0 - probs_thresh)
        pij = xf.T @ (Wc * xf)                 # E[x_i x_j]
        corr = corr_bin(ph[:, None], ph[None, :], pij)
        tri = torch.ones((d, d), dtype=torch.bool, device=xf.device).tril(-1)
        pred_mask = (tri & (corr.abs() > corr_thresh) & ~edgy[:, None]
                     & ~edgy[None, :])
        mask = pred_mask.float()               # row i: component i's mask
        eye = torch.eye(d, dtype=xf.dtype, device=xf.device)
        logit_ph = torch.logit(ph.clamp(1e-6, 1.0 - 1e-6))
        beta = torch.zeros((d, d), dtype=xf.dtype, device=xf.device)
        b = logit_ph
        rows = max(1, FIT_CHUNK // max(N * d, 1))
        Hfull = torch.empty((d, d + 1, d + 1), dtype=xf.dtype,
                            device=xf.device)
        for _ in range(newton_steps):
            # row i's masked features are xf * mask[i]: every product
            # below is the full one times the mask, exactly
            p = torch.sigmoid(xf @ (beta * mask).T + b)        # (N, d)
            wts = Wc * p * (1.0 - p) + 1e-8
            r = Wc * (xf - p)
            g_beta = mask * (r.T @ xf) - ridge * beta
            g_b = r.sum(0)
            for s in range(0, d, rows):
                Xw = wts.T[s:s + rows, :, None] * xf          # (c, N, d)
                Hfull[s:s + rows, :d, :d] = Xw.transpose(1, 2) @ xf
            Hb = mask * (wts.T @ xf)
            Hfull[:, :d, :d] *= mask[:, :, None] * mask[:, None, :]
            Hfull[:, :d, :d] += ridge * eye
            Hfull[:, :d, d] = Hb
            Hfull[:, d, :d] = Hb
            Hfull[:, d, d] = wts.sum(0) + 1e-8
            gfull = torch.cat([g_beta, g_b[:, None]], 1)
            step = torch.linalg.solve_ex(Hfull, gfull)[0]
            beta = beta + step[:, :d]
            b = b + step[:, d]
        coeffs = beta * mask
        diag = torch.where(edgy, ph, torch.where(pred_mask.any(1), b,
                                                 logit_ph))
        return cls(coeffs + torch.diag(diag), edgy)


class BinaryMetropolis(ssps.ArrayMetropolis):
    """Independent Metropolis with a nested-logistic proposal fitted to the
    weighted cloud (reference binary_smc.py:154-163).  A step draws the
    proposal's (N, d) uniforms, then N accept uniforms (the JAX package's
    ``k1``, ``k2``), then the target's own draws if it has any."""

    def calibrate(self, W, x):
        prop = NestedLogistic.fit(W, x.theta["gamma"])
        return {"prop_coeffs": prop.coeffs, "prop_edgy": prop.edgy}

    def draws(self, gen, x, target=None):
        dev = gen.device
        u_prop = torch.rand((x.N, x.theta["gamma"].shape[1]), generator=gen,
                            device=dev)
        u_acc = torch.rand(x.N, generator=gen, device=dev)
        if hasattr(target, "draws"):
            return u_prop, u_acc, target.draws(gen, x)
        return u_prop, u_acc

    def step_with(self, x, target, u_prop, u_acc, tdraws=None, out=None):
        prop = NestedLogistic(x.shared["prop_coeffs"], x.shared["prop_edgy"])
        gamma_prop = prop.rvs_with(u_prop)
        xx = x.replace(theta={"gamma": gamma_prop})
        xprop = target(xx) if tdraws is None else target(xx, tdraws)
        delta_lp = prop.logpdf(x.theta["gamma"]) - prop.logpdf(gamma_prop)
        lp_acc = xprop.lpost - x.lpost + delta_lp
        lp_acc = torch.where(torch.isnan(lp_acc), -torch.inf, lp_acc)
        pb_acc = torch.exp(lp_acc.clamp(max=0.0))
        accept = u_acc < pb_acc
        return xprop.where(accept, x, out=out), pb_acc.mean()


def _chol_block(gamma, xtx, xty, vm2):
    gf = gamma.float()
    A = xtx[None] * gf[:, :, None]
    A *= gf[:, None, :]
    A.diagonal(dim1=1, dim2=2).add_(gf * vm2 + (1.0 - gf))
    C = torch.linalg.cholesky_ex(A)[0]
    ldet = torch.log(torch.diagonal(C, dim1=1, dim2=2)).sum(1)
    rhs = xty[None, :] * gf
    w = torch.linalg.solve_triangular(C, rhs[:, :, None], upper=False)
    return gf.sum(1), ldet, (w[:, :, 0] ** 2).sum(1)


def chol_and_friends(gamma, xtx, xty, vm2):
    """``(len_gam, ldet, wtw)`` of each particle's active submatrix
    (reference binary_smc.py:165-180): the log-determinant of the Cholesky
    factor C of ``xtx[g, g] + vm2 I`` and ``|C^-1 xty[g]|^2``.  One batched
    Cholesky of (N, p, p) matrices whose excluded rows and columns are the
    identity (they add log 1 = 0 and 0), ``CHOL_CHUNK`` elements a block."""
    N, p = gamma.shape
    step = max(1, CHOL_CHUNK // (p * p))
    if N <= step:
        return _chol_block(gamma, xtx, xty, vm2)
    parts = [_chol_block(gamma[s:s + step], xtx, xty, vm2)
             for s in range(0, N, step)]
    return tuple(torch.cat(c) for c in zip(*parts))


def _as_float_tensor(a, device):
    if isinstance(a, torch.Tensor):
        return a.float()
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


class VariableSelection(ssps.StaticModel):
    """Base class for Bayesian variable selection (reference
    binary_smc.py:183-213): the state is a vector of inclusion indicators
    gamma, the likelihood the marginal likelihood with the coefficients
    integrated out.

    ``data = (x, y)``, x (n, p) and y (n,), numpy arrays (put on ``device``,
    by default the current CUDA card) or tensors (kept where they are);
    ``theta['gamma']`` is (N, p) bool.
    """

    def __init__(self, data=None, prior=None, device=None):
        x, y = data
        if not isinstance(x, torch.Tensor):
            device = resolve_device(device)
        else:
            device = x.device
        self.x = _as_float_tensor(x, device)
        self.y = _as_float_tensor(y, device)
        self.data = (self.x, self.y)
        self.prior = prior
        # accumulated in float64, then float32: a design with interactions
        # has a Gram matrix near singular, where the order of a float32
        # sum alone can turn the full model's residual variance negative
        x64, y64 = self.x.double(), self.y.double()
        self.xtx = (x64.T @ x64).float()
        self.yty = (y64 ** 2).sum().float()
        self.xty = (x64.T @ y64).float()

    @property
    def n(self):
        return self.x.shape[0]

    @property
    def p(self):
        return self.x.shape[1]

    @property
    def T(self):
        return 1

    def complete_enum(self):
        """Every gamma of {0,1}^p and its log-posterior, by enumeration (for
        small p; the tests' oracle, reference binary_smc.py:204-207)."""
        gammas = all_binary_words(self.p, self.x.device)
        return gammas, self.logpost({"gamma": gammas})

    def chol_intermediate(self, gamma):
        return chol_and_friends(gamma, self.xtx, self.xty, self.iv2)

    def sig2_full(self):
        """The residual variance of the full model, a 0-d tensor."""
        full = torch.ones((1, self.p), dtype=torch.bool, device=self.x.device)
        _, _, btb = chol_and_friends(full, self.xtx, self.xty, 0.0)
        return (self.yty - btb[0]) / self.n

    def loglik(self, theta, t=None):
        return self._loglik_gamma(theta["gamma"])


def _log(v):
    """log of a number (a float) or of a tensor."""
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


class BIC(VariableSelection):
    """Pseudo-posterior exp(-lambda BIC(gamma)) (reference
    binary_smc.py:216-230)."""

    def __init__(self, data=None, prior=None, lamb=10.0, device=None):
        super().__init__(data=data, prior=prior, device=device)
        self.lamb = lamb
        self.iv2 = 0.0

    def _loglik_gamma(self, gamma):
        len_gam, _, wtw = self.chol_intermediate(gamma)
        return -(math.log(self.n * 1.0) * self.lamb * len_gam
                 + self.n * self.lamb * torch.log(self.yty - wtw))


class BayesianVS(VariableSelection):
    """Marginal likelihood of y = X beta + eps, sigma^2 ~ IG(nu/2,
    nu lambda/2), beta | sigma^2 ~ N(0, v2 sigma^2 I) (reference
    binary_smc.py:233-265); ``lamb`` defaults to the full model's residual
    variance and ``iv2`` = 1/v2 to lamb / 10."""

    def __init__(self, data=None, prior=None, nu=4.0, lamb=None, iv2=None,
                 device=None):
        super().__init__(data=data, prior=prior, device=device)
        self.nu = nu
        self.lamb = self.sig2_full() if lamb is None else lamb
        self.iv2 = self.lamb / 10.0 if iv2 is None else iv2

    def _loglik_gamma(self, gamma):
        len_gam, ldet, wtw = self.chol_intermediate(gamma)
        return -(-0.5 * _log(self.iv2) * len_gam + ldet
                 + 0.5 * (self.nu + self.n)
                 * torch.log(self.nu * self.lamb + self.yty - wtw))


class BayesianVS_gprior(BayesianVS):
    """The same with Zellner's g-prior beta | sigma^2 ~ N(0, g sigma^2
    (X'X)^-1) (reference binary_smc.py:268-293); ``g`` defaults to n."""

    def __init__(self, data=None, prior=None, nu=4.0, lamb=None, g=None,
                 device=None):
        VariableSelection.__init__(self, data=data, prior=prior,
                                   device=device)
        self.g = float(self.n) if g is None else g
        self.nu = nu
        self.lamb = self.sig2_full() if lamb is None else lamb
        self.iv2 = 0.0

    def _loglik_gamma(self, gamma):
        len_gam, _, wtw = self.chol_intermediate(gamma)
        gogp1 = self.g / (self.g + 1.0)
        return -(0.5 * _log(1.0 + self.g) * len_gam
                 + 0.5 * (self.n + self.nu)
                 * torch.log(self.nu * self.lamb + self.yty - gogp1 * wtw))
