"""Nested sampling: vanilla NS and the SMC variant, NS-SMC (PyTorch port).

Counterpart of ``particles_tpu/nested.py``: vanilla nested sampling with
random-walk moves inside the likelihood contour (:class:`NestedSampling`,
:class:`Nested_RWmoves`) and the Salomone et al. (2018)
:class:`NestedSamplingSMC` Feynman-Kac class.

How this port runs them:

* **Vanilla NS in chunks with no host read.**  Where the JAX package
  compiles a chunk of K contractions into one ``lax.scan``, a chunk here
  is a Python loop of K contractions that stays on the device: the
  deleted point is an ``argmin`` read by ``index_select``, the new one is
  written by ``index_copy_`` with a 0-d index tensor, and the chunk's
  draws are made up front.  The stopping rule (the evidence gained over a
  chunk below ``eps``) is the run's one host read a chunk.  ``lZ`` stays
  float32, as in the JAX package: the rule fires once float32 increments
  of ``lZ`` vanish, so the run's length depends on it.
* **A contraction is a function of its draws**: ``r``, the offset of the
  starting point m = (n + 1 + r) mod N (r uniform in [0, N - 1), the law
  of ``unif_minus_one``), and the mutation's own (``nsteps`` normals of
  (d,) and ``nsteps`` uniforms for :class:`Nested_RWmoves`), so a test
  replays the JAX package's.
* **NS-SMC runs through the sampler step** (``smc_samplers``): it always
  resamples (B1 and B2 through the waste-free move), its level is the
  (1 - ESSrmin)-quantile of the N0 log-likelihoods computed with the JAX
  package's linear interpolation on the device, and ``done``'s read of the
  level is the step's one host read.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from particles_tpu_torch import resampling as rs
from particles_tpu_torch import smc_samplers as ssps
from particles_tpu_torch import tracing
from particles_tpu_torch import utils
from particles_tpu_torch.distributions import _cholesky

__all__ = ["NestedParticles", "NestedSampling", "Nested_RWmoves",
           "NestedSamplingSMC", "MeanCovTracker", "unif_minus_one"]


class NestedParticles(ssps.ThetaParticles):
    """Nested-sampling points (reference nested.py:147-152): parameters
    plus each point's log-prior and log-likelihood."""

    def __init__(self, theta=None, lprior=None, llik=None, shared=None):
        super().__init__(theta=theta, shared=shared, lprior=lprior,
                         llik=llik)


def unif_minus_one(gen, N, m):
    """A uniform draw from {0, ..., N-1} minus {m} (reference
    nested.py:107-109): (m + 1 + r) mod N with r uniform in [0, N - 1),
    drawn on ``gen``'s device.  ``m`` is an int or an integer tensor."""
    r = torch.randint(0, N - 1, (), generator=gen, device=gen.device)
    return (m + 1 + r) % N


def xxT(x):
    return torch.outer(x, x)


class MeanCovTracker:
    """Mean, covariance and Cholesky factor of a set of points under
    ``add_point`` and ``remove_point`` (reference nested.py:117-144)."""

    def __init__(self, x):
        self.N = x.shape[0]
        self.sx = x.sum(0)
        self.sxxT = x.T @ x
        self.update_mean_cov()

    def update_mean_cov(self):
        self.mean = self.sx / self.N
        self.cov = self.sxxT / self.N - xxT(self.mean)
        self.L = _cholesky(self.cov)

    def remove_point(self, x):
        self.N -= 1
        self.sx = self.sx - x
        self.sxxT = self.sxxT - xxT(x)
        self.update_mean_cov()

    def add_point(self, x):
        self.N += 1
        self.sx = self.sx + x
        self.sxxT = self.sxxT + xxT(x)
        self.update_mean_cov()


class NestedSampling:
    """Base class for vanilla nested sampling (reference nested.py:155-230).

    A subclass defines the mutation: ``mutate_draws(gen, K, d)``, its draws
    for K contractions (each with leading dimension K), and
    ``_mutate_kernel(arr, lprior, llik, n, m, *draws)``, which replaces
    point n (a 0-d index tensor) by a point that starts from point m and
    lies above n's likelihood, in place.

    Draws come from ``generator``, else from one seeded by ``seed`` on
    ``device`` (by default the model's data's, else the current CUDA card).
    After ``run()``: ``log_weights``, ``points`` (a dict of ``llik`` and
    ``theta``, the deleted points in order) and ``lZhats`` (the
    log-evidence after each contraction).
    """

    def __init__(self, model=None, N=100, eps=1e-8, seed=0, generator=None,
                 device=None):
        if N < 2:
            raise ValueError(f"nested sampling needs N >= 2, got {N}")
        self.model = model
        self.N = N
        self.eps = eps
        if generator is None:
            data = getattr(model, "data", None)
            if device is None and isinstance(data, torch.Tensor):
                device = data.device
            generator = torch.Generator(device=utils.resolve_device(device))
            generator.manual_seed(seed)
        self.gen = generator

    def setup(self):
        th = dict(self.model.prior.rvs(self.gen, size=self.N))
        self.arr = ssps.view_2d_array(th)
        self.template = th
        self.lprior = self.model.prior.logpdf(th)
        self.llik = self.model.loglik(th)

    def mutate_draws(self, gen, K, d):
        raise NotImplementedError

    def _mutate_kernel(self, arr, lprior, llik, n, m, *draws):
        raise NotImplementedError

    def draws(self, gen, K):
        """The draws of K contractions: ``(r, *mutation draws)``."""
        d = self.arr.shape[1]
        r = torch.randint(0, self.N - 1, (K,), generator=gen,
                          device=gen.device)
        return (r,) + tuple(self.mutate_draws(gen, K, d))

    def _chunk(self, arr, lprior, llik, lZ, i0, K, draws):
        """K contractions (delete the lowest point, add the evidence it
        carries, mutate a copy of another point into its place) with no host
        read.  ``arr``, ``lprior`` and ``llik`` are updated in place; ``lZ``
        is a 0-d float32 tensor.  Returns ``(lZ, deleted log-likelihoods
        (K,), deleted points (K, d), lZ after each contraction (K,))``."""
        N, d = arr.shape
        r, *mdraws = draws
        dev = arr.device
        # float32, as the JAX package computes it
        lw0 = float(np.log(np.float32(1.0) - np.exp(np.float32(-1.0 / N))))
        i = torch.arange(i0, i0 + K, dtype=torch.float32, device=dev)
        lws = lw0 - i / N
        pll = torch.empty(K, dtype=llik.dtype, device=dev)
        pth = torch.empty((K, d), dtype=arr.dtype, device=dev)
        lZs = torch.empty(K, dtype=torch.float32, device=dev)
        for j in range(K):
            n = torch.argmin(llik)
            n1 = n.reshape(1)
            pt_ll = llik.index_select(0, n1)
            pll[j:j + 1] = pt_ll
            pth[j:j + 1] = arr.index_select(0, n1)
            lZ = torch.logaddexp(lZ, lws[j] + pt_ll[0])
            lZs[j] = lZ
            m = (n + 1 + r[j]) % N
            self._mutate_kernel(arr, lprior, llik, n, m,
                                *(v[j] for v in mdraws))
        return lZ, pll, pth, lZs

    @utils.timer
    def run(self, chunk_size=None):
        self.setup()
        K = max(self.N // 2, 10) if chunk_size is None else chunk_size
        lZ = torch.full((), -torch.inf, dtype=torch.float32,
                        device=self.arr.device)
        i0 = 0
        plls, pths, lZs_all = [], [], []
        while True:
            lZ, pll, pth, lZs = self._chunk(self.arr, self.lprior, self.llik,
                                            lZ, i0, K, self.draws(self.gen, K))
            plls.append(pll)
            pths.append(pth)
            lZs_all.append(lZs)
            i0 += K
            # stop when the evidence gained over the chunk is negligible:
            # the chunk's one host read
            if bool((lZs[-1] - lZs[0]).abs() < self.eps):
                break
            if i0 > 1000 * self.N:      # safety bound
                break
        self.lZhats = list(torch.cat(lZs_all).cpu().numpy())
        self.points = {"llik": torch.cat(plls), "theta": torch.cat(pths)}
        lw0 = np.log(1.0 - np.exp(-1.0 / self.N))
        self.log_weights = [float(lw0 - i / self.N)
                            for i in range(len(self.lZhats))]


class Nested_RWmoves(NestedSampling):
    """Nested sampling with random-walk Metropolis mutation inside the
    likelihood contour (reference nested.py:233-274): ``nsteps`` steps from
    point m with the Gaussian proposal of the cloud's covariance (point n
    left out) scaled by ``scale`` (2.38 / sqrt(d) by default)."""

    def __init__(self, model=None, N=100, eps=1e-8, nsteps=1, scale=None,
                 seed=0, generator=None, device=None):
        super().__init__(model=model, N=N, eps=eps, seed=seed,
                         generator=generator, device=device)
        self.nsteps = nsteps
        self.scale = scale

    def mutate_draws(self, gen, K, d):
        """Per contraction, ``nsteps`` standard normals of (d,) and
        ``nsteps`` uniforms."""
        z = torch.randn((K, self.nsteps, d), generator=gen, device=gen.device)
        u = torch.rand((K, self.nsteps), generator=gen, device=gen.device)
        return z, u

    def _mutate_kernel(self, arr, lprior, llik, n, m, z, u):
        N, d = arr.shape
        scale = 2.38 / math.sqrt(d) if self.scale is None else self.scale
        n1, m1 = n.reshape(1), m.reshape(1)
        lmin = llik.index_select(0, n1)
        # the cloud's covariance without the deleted point
        keep = (torch.arange(N, device=arr.device) != n)[:, None]
        cnt = N - 1
        mean = torch.where(keep, arr, 0.0).sum(0) / cnt
        xc = torch.where(keep, arr - mean, 0.0)
        cov = xc.T @ xc / cnt
        L = _cholesky(cov + 1e-10 * torch.eye(d, dtype=arr.dtype,
                                              device=arr.device))
        steps = z @ (scale * L).T                  # (nsteps, d)
        logu = torch.log(u)
        cur = arr.index_select(0, m1)
        cur_lp = lprior.index_select(0, m1)
        cur_ll = llik.index_select(0, m1)
        for i in range(self.nsteps):
            prop = cur + steps[i]
            th = ssps.theta_from_2d(prop, self.template)
            lp = self.model.prior.logpdf(th)
            ll = self.model.loglik(th)
            ok = (ll > lmin) & (logu[i] < lp - cur_lp)
            cur = torch.where(ok[:, None], prop, cur)
            cur_lp = torch.where(ok, lp, cur_lp)
            cur_ll = torch.where(ok, ll, cur_ll)
        arr.index_copy_(0, n1, cur)
        lprior.index_copy_(0, n1, cur_lp)
        llik.index_copy_(0, n1, cur_ll)


def _quantile(v, q):
    """The ``q``-quantile of the 1-d ``v`` with the JAX package's linear
    interpolation (``jnp.percentile``): ``lo (1 - w) + hi w`` in float32,
    the position and weights computed on the host from the length alone.
    (``torch.quantile`` interpolates by ``lerp``, which gives NaN where
    ``jnp.percentile`` gives -inf between -inf and a finite value.)"""
    n = v.shape[0]
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = np.float32(pos - np.float32(lo))
    w_lo = np.float32(1.0) - w_hi
    lo, hi = min(max(lo, 0), n - 1), min(max(hi, 0), n - 1)
    s = torch.sort(v).values
    return s[lo] * float(w_lo) + s[hi] * float(w_hi)


class NestedSamplingSMC(ssps.FKSMCsampler):
    """Nested sampling by SMC (Salomone et al. 2018; reference
    nested.py:281-373): at time t the target is the prior restricted to
    {L(theta) > l_t}, l_t the (1 - ESSrmin)-quantile of the current
    log-likelihoods; the evidence accumulates in ``X.shared['log_evid']``.
    Always resamples; stops once the final-time evidence correction is
    below ``eps`` (the level set to +inf), which ``done`` reads on the
    host, the step's one read.
    """

    always_resample = True

    def __init__(self, model=None, wastefree=True, len_chain=10, move=None,
                 ESSrmin=0.1, eps=0.01):
        super().__init__(model=model, wastefree=wastefree,
                         len_chain=len_chain, move=move)
        self.ESSrmin = ESSrmin
        self.eps = eps

    def time_to_resample(self, view):
        return True

    def done(self, smc):
        if smc.X is None:
            return False
        # only lt == +inf ends the run (the last level consumes the rest of
        # the prior mass); lt == -inf happens mid-run, when most particles
        # sit where the likelihood is zero
        with tracing.sync("done"):
            return bool(smc.X.shared["lt"] == torch.inf)

    def _M0(self, gen, N0):
        with tracing.span("model"):
            th = dict(self.model.prior.rvs(gen, size=N0))
            lprior = self.model.prior.logpdf(th)
            llik = self.model.loglik(th)
        x = ssps.ThetaParticles(theta=th, lprior=lprior, llik=llik,
                                lpost=lprior)
        like = lprior
        cal = self.move.calibrate(ssps._uniform_weights(N0, like), x)
        minus_inf = torch.full((), -torch.inf, dtype=torch.float32,
                               device=like.device)
        return x.with_shared(lt=minus_inf, log_evid=minus_inf.clone(),
                             acc_rate=ssps._zero(like), **cal)

    def current_target(self, lt):
        def target(xx):
            with tracing.span("model"):
                lprior = self.model.prior.logpdf(xx.theta)
                llik = self.model.loglik(xx.theta)
            lpost = torch.where(
                torch.isinf(lt) & (lt < 0), lprior,
                torch.where(llik >= lt, lprior, -torch.inf))
            return xx.replace(lprior=lprior, llik=llik, lpost=lpost)

        return target

    def move_target(self, t, x):
        return self.current_target(x.shared["lt"])

    def logG_and_update(self, t, x, gen=None):
        """The new level, the evidence it adds and the potentials: 0 above
        the level and -inf below it, or 0 everywhere once the run stops
        (reference nested.py:330-373).  The level and the evidence read
        the global log-likelihoods, one gathered (N0,) vector under
        particle sharding (``smc_samplers._gather_global``), so that they
        are the same on every rank."""
        llik = x.llik
        curr_evid = x.shared["log_evid"]
        llik_all = ssps._gather_global(llik)
        N0 = llik_all.shape[0]
        lt = _quantile(llik_all, np.float32(100.0 * (1.0 - self.ESSrmin))
                       / np.float32(100.0))
        log_shrink = float(np.float32(t) * np.log(np.float32(self.ESSrmin))
                           - np.log(np.float32(N0)))
        lZt = log_shrink + rs.log_sum_exp(
            torch.where(llik_all <= lt, llik_all, -torch.inf))
        new_evid = torch.logaddexp(curr_evid, lZt)
        lZt_final = log_shrink + rs.log_sum_exp(llik_all)
        new_evid_final = torch.logaddexp(curr_evid, lZt_final)
        stop = (new_evid - new_evid_final).abs() < self.eps
        lt = torch.where(stop, torch.inf, lt)
        new_evid = torch.where(stop, new_evid_final, new_evid)
        lw = torch.where(stop, torch.zeros_like(llik),
                         torch.where(llik > lt, 0.0, -torch.inf))
        return lw, x.with_shared(lt=lt, log_evid=new_evid)
