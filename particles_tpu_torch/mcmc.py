"""MCMC and particle MCMC: adaptive random-walk Metropolis, PMMH,
conditional SMC and (Particle) Gibbs (PyTorch port).

Counterpart of ``particles_tpu/mcmc.py``, names kept: :func:`msjd`,
:class:`MCMC`, :class:`VanishCovTracker`, :class:`GenericRWHM`,
:class:`BasicRWHM`, :class:`PMMH`, :class:`CSMC`, :class:`GenericGibbs`
and :class:`ParticleGibbs`.

How this port runs them:

* **The chains are one batch.**  :class:`GenericRWHM` runs its
  ``nchains`` chains as rows of one (nchains, dim) state, the JAX
  package's vmap.  An iteration draws the normals z, evaluates
  ``logpost`` on the proposals, draws the uniforms u, accepts by
  ``torch.where`` and updates the covariance tracker, and writes the
  state into preallocated (niter, nchains, dim) buffers: no value is read
  on the host inside the loop.  The JAX package's segments
  (``chain_chunk``) only keep compiled programs under XLA's deadlines and
  are not carried over.
* **PMMH's likelihood is the batched inner filter**
  (:class:`particles_tpu_torch.inner_pf.InnerPF`, rows = chains), masked
  to -inf by ``torch.where`` where the prior is not finite or the filter
  gave NaN (the JAX ``lax.cond``).  With ``qmc=True`` each chain's
  likelihood is an SQMC run (``core.SMC(qmc=True)``), one chain after
  another.
* **CSMC** draws its multinomial ancestors with ``resampling.multinomial``
  (B3, B5 and B2 on the card) at every step and selects them by
  ``torch.where``, so a step reads nothing on the host.
* ``logpost`` of a :class:`GenericRWHM` subclass takes a dict of
  (nchains, ...) tensors and returns (nchains,) log-densities; the Gibbs
  samplers' ``update_theta`` and ``update_states`` take the run's
  ``torch.Generator`` where the JAX package takes a key.

* **Chains across ranks.**  With ``mesh`` (a ``DeviceMesh``,
  ``parallel.make_mesh``) and ``mesh_axis``, the ``nchains`` chains split
  over that axis's process group: each rank runs its nchains / D chains
  as one batch, from its own generator (``distctx.rank_generator`` of
  ``seed`` and the rank), and at the end one all-gather gives every rank
  the whole (niter, nchains, ...) chain.  The chains are independent, so
  nothing else crosses the ranks.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from particles_tpu_torch import core
from particles_tpu_torch import distctx
from particles_tpu_torch import inner_pf
from particles_tpu_torch import resampling as rs
from particles_tpu_torch import smc_samplers as ssp
from particles_tpu_torch import smoothing
from particles_tpu_torch import state_space_models as ssms
from particles_tpu_torch import utils
from particles_tpu_torch import variance_mcmc

__all__ = [
    "msjd",
    "MCMC",
    "VanishCovTracker",
    "GenericRWHM",
    "BasicRWHM",
    "PMMH",
    "CSMC",
    "GenericGibbs",
    "ParticleGibbs",
]


def msjd(theta):
    """Mean squared jumping distance of a chain stored as a dict of
    (niter, ...) tensors."""
    s = 0.0
    for p in theta:
        s = s + (torch.diff(theta[p], dim=0) ** 2).sum()
    return s


def _device_of(data, generator, device):
    """``device`` if given, else that of a ``data`` tensor or of the
    generator, else the current CUDA card."""
    if device is None:
        if isinstance(data, torch.Tensor):
            device = data.device
        elif generator is not None:
            device = generator.device
    return utils.resolve_device(device)


def _f32_data(data, device):
    if data is None or isinstance(data, torch.Tensor):
        return data
    return torch.as_tensor(np.asarray(data), dtype=torch.float32,
                           device=device)


class MCMC:
    """MCMC base class: subclasses define ``step0`` and ``step(n)``, or
    override ``run``.  Every draw comes from ``self.gen``, a
    ``torch.Generator`` on ``self.device`` seeded by ``seed`` unless
    ``generator`` is given."""

    def __init__(self, niter=10, verbose=0, seed=0, generator=None,
                 device=None):
        self.niter = niter
        self.verbose = verbose
        self.device = utils.resolve_device(
            device if device is not None or generator is None
            else generator.device)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        self.gen = generator

    def step0(self):
        raise NotImplementedError

    def step(self, n):
        raise NotImplementedError

    def mean_sq_jump_dist(self, discard_frac=0.1):
        discard = int(self.niter * discard_frac)
        return msjd({k: v[discard:] for k, v in self.chain.theta.items()})

    def diagnostics(self, discard_frac=0.1, method="init_seq"):
        """Per-parameter split-Rhat and effective sample size of the stored
        chain(s) (``variance_mcmc.chain_diagnostics``, on the host)."""
        discard = int(self.niter * discard_frac)
        return variance_mcmc.chain_diagnostics(
            self.chain.theta, nchains=getattr(self, "nchains", 1),
            discard=discard, method=method)

    def print_progress(self, n):
        msg = f"Iteration {n}"
        if hasattr(self, "nacc") and n > 0:
            msg += f", acc. rate={self.nacc / n:.3f}"
        print(msg)

    def _iterate(self):
        for n in range(self.niter):
            if n == 0:
                self.step0()
            else:
                self.step(n)
            if self.verbose > 0 and (n * self.verbose) % self.niter == 0:
                self.print_progress(n)

    @utils.timer
    def run(self):
        self._iterate()


class _TrackerState(NamedTuple):
    t: int
    mu: Any
    Sigma: Any
    L: Any
    L0: Any


class VanishCovTracker:
    """Vanishing-adaptation running mean and covariance (reference
    mcmc.py:188-223) as a state and an update, so that it lives inside
    the chain loop.  ``update`` takes v of shape (..., dim): a batch of
    chains updates at once.  On a failed Cholesky factorisation (of a
    matrix that is not positive definite, or not finite) the initial
    factor is kept, by a mask on ``cholesky_ex``'s status: no host read."""

    def __init__(self, alpha=0.6, dim=1, mu0=None, Sigma0=None, device=None):
        self.alpha = alpha
        self.dim = dim
        f32 = dict(dtype=torch.float32, device=device)
        self.mu0 = (torch.zeros(dim, **f32) if mu0 is None
                    else torch.as_tensor(mu0, **f32))
        self.Sigma0 = (torch.eye(dim, **f32) if Sigma0 is None
                       else torch.as_tensor(Sigma0, **f32))
        # factored here, once: cholesky checks its input on the host
        self.L0 = torch.linalg.cholesky(self.Sigma0)

    def init_state(self, batch=()):
        """The state at t = 0, for a batch of chains of shape ``batch``."""
        L0 = self.L0
        d = self.dim
        return _TrackerState(
            t=0, mu=self.mu0.expand(batch + (d,)).clone(),
            Sigma=self.Sigma0.expand(batch + (d, d)).clone(),
            L=L0.expand(batch + (d, d)).clone(), L0=L0)

    def update(self, state, v):
        t = state.t + 1
        g = (t + 1.0) ** (-self.alpha)
        mu = (1.0 - g) * state.mu + g * v
        mv = v - mu
        Sigma = (1.0 - g) * state.Sigma + g * (mv[..., :, None]
                                               * mv[..., None, :])
        L, info = torch.linalg.cholesky_ex(Sigma)
        ok = (info == 0) & torch.isfinite(L).all(-1).all(-1)
        L = torch.where(ok[..., None, None], L, state.L0)
        return _TrackerState(t=t, mu=mu, Sigma=Sigma, L=L, L0=state.L0)


def _theta_template(prior, gen):
    """dict of 0-d (or (d,)) tensors giving the parameter layout, in the
    prior's order."""
    th1 = prior.rvs(gen, size=1)
    return {k: v[0] for k, v in th1.items()}


def _dict_to_vec(theta):
    """A single θ (dict of 0-d or (d,) tensors) as one vector, in the
    dict's order."""
    return torch.cat([torch.atleast_1d(torch.as_tensor(v)).reshape(-1)
                      for v in theta.values()])


def _dicts_to_vecs(theta, template):
    """A batch of θ, dict of (n, ...) tensors, as (n, dim), in TEMPLATE
    order."""
    n = next(iter(theta.values())).shape[0]
    return torch.cat([theta[k].reshape(n, -1) for k in template], 1)


def _vec_to_dict(vec, template):
    """The inverse of :func:`_dict_to_vec` for the layout of ``template``:
    the last axis of ``vec`` is split into the template's fields (leading
    axes are kept, so a batch unpacks at once)."""
    out = {}
    j = 0
    lead = vec.shape[:-1]
    for k, v in template.items():
        d = math.prod(v.shape)
        out[k] = vec[..., j:j + d].reshape(lead + tuple(v.shape))
        j += d
    return out


class GenericRWHM(MCMC):
    """Adaptive Gaussian random-walk Hastings-Metropolis
    (reference mcmc.py:226-304); subclasses define ``logpost(theta)``
    over a dict of (nchains, ...) tensors.

    With ``nchains > 1`` the chains run as one batch (overdispersed starts
    from the prior, independent adaptation and, for PMMH, independent
    inner filters), and the chain is stored as (niter, nchains, ...)
    leaves, the layout of :mod:`variance_mcmc`.  ``theta0`` gives the start:
    a dict over the prior's fields of scalars (every chain) or, with
    ``nchains > 1``, of (nchains,) arrays (one start a chain).

    ``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh``) and
    ``mesh_axis`` (one of its dimension names; None for a 1-D mesh) split
    the chains over that axis's ranks: call on every rank with the same
    arguments.  Each rank runs nchains / D chains (global chains ``[rank
    nchains / D, (rank + 1) nchains / D)``) from its own generator, made
    from ``seed`` (a ``generator`` raises ``ValueError``), and ``run()``
    ends with one all-gather, so that every rank holds the whole chain.
    ``ValueError`` when D does not divide ``nchains``.
    """

    def __init__(self, niter=10, verbose=0, theta0=None, adaptive=True,
                 scale=1.0, rw_cov=None, seed=0, generator=None, device=None,
                 nchains=1, mesh=None, mesh_axis=None):
        super().__init__(niter=niter, verbose=verbose, seed=seed,
                         generator=generator, device=device)
        self.theta0 = theta0
        self.adaptive = adaptive
        self.nchains = int(nchains)
        # this rank's chains: nloc of them from global chain off on
        self._group, self._nloc, self._off = None, self.nchains, 0
        if mesh is not None or mesh_axis is not None:
            self._shard_chains(mesh, mesh_axis, seed, generator)
        self.template = _theta_template(self.prior, self.gen)
        self.dim = int(_dict_to_vec(self.template).shape[0])
        if self.adaptive:
            self.scale = scale * 2.38 / np.sqrt(self.dim)
            self.cov_tracker = VanishCovTracker(dim=self.dim, Sigma0=rw_cov,
                                                device=self.device)
        else:
            # as the JAX package: `scale` is for the adaptive proposal only
            self.scale = 1.0
            cov = (torch.eye(self.dim) if rw_cov is None
                   else torch.as_tensor(np.asarray(rw_cov),
                                        dtype=torch.float32))
            self.fixed_L = torch.linalg.cholesky(cov).to(self.device)

    def _shard_chains(self, mesh, mesh_axis, seed, generator):
        import torch.distributed as dist

        if mesh is None:
            raise ValueError("mesh_axis given without a mesh")
        if generator is not None:
            raise ValueError("mesh: each rank draws from its own generator, "
                             "made from seed; pass seed, not generator")
        group = (mesh.get_group() if mesh_axis is None
                 else mesh.get_group(mesh_axis))
        D, d = dist.get_world_size(group), dist.get_rank(group)
        if self.nchains % D:
            raise ValueError(f"nchains={self.nchains} not divisible by mesh "
                             f"axis {mesh_axis!r} size {D}")
        self._group, self._nloc = group, self.nchains // D
        self._off = d * self._nloc
        self.gen = distctx.rank_generator(seed, d, self.device)

    def logpost(self, theta):
        raise NotImplementedError

    def _theta0(self):
        """This rank's starting points, (nchains / D, dim)."""
        nc = self._nloc
        if self.theta0 is None:
            return _dicts_to_vecs(self.prior.rvs(self.gen, size=nc),
                                  self.template)
        if set(self.theta0) != set(self.template):
            raise ValueError(
                f"theta0 keys {sorted(self.theta0)} != prior keys "
                f"{sorted(self.template)}")
        th0 = {}
        for k, tv in self.template.items():
            v = self.theta0[k]
            v = (v.to(self.device, torch.float32)
                 if isinstance(v, torch.Tensor) else
                 torch.as_tensor(np.asarray(v, dtype=np.float32),
                                 device=self.device))
            tgt = (nc,) + tuple(tv.shape)
            if v.shape == (self.nchains,) + tuple(tv.shape):
                v = v[self._off:self._off + nc]      # this rank's chains
            if v.shape == tv.shape:
                v = v.expand(tgt)            # the same start, every chain
            elif v.shape != tgt:
                raise ValueError(
                    f"theta0[{k!r}]: shape {tuple(v.shape)} is neither the "
                    f"template shape {tuple(tv.shape)} nor the per-chain "
                    f"shape {(self.nchains,) + tuple(tv.shape)}")
            th0[k] = v
        return _dicts_to_vecs(th0, self.template)

    def _tracker0(self):
        if self.adaptive:
            return self.cov_tracker.init_state((self._nloc,))
        return None

    @utils.timer
    def run(self, draws=None):
        """Run the chain(s).  ``draws``, a pair ``(z, u)`` of tensors of
        shapes (niter - 1, [nchains,] dim) and (niter - 1, [nchains]),
        replays given normals and uniforms in place of the generator's
        (a stochastic ``logpost`` still draws from it)."""
        self._chain(draws)
        self._finish()

    def _chain(self, draws=None):
        """The chain loop, on the device with no host read: fills
        ``self._thetas`` (niter, nchains / D, dim), ``self._lposts`` and
        ``self._nacc`` (this rank's chains)."""
        nc, dim, gen = self._nloc, self.dim, self.gen
        dev = self.device
        vec = self._theta0()
        lpost = self.logpost(_vec_to_dict(vec, self.template))
        trk = self._tracker0()
        thetas = torch.empty((self.niter, nc, dim), device=dev)
        lposts = torch.empty((self.niter, nc), device=dev)
        thetas[0].copy_(vec)
        lposts[0].copy_(lpost)
        nacc = torch.zeros(nc, dtype=torch.int32, device=dev)
        for n in range(1, self.niter):
            if draws is None:
                z = torch.randn((nc, dim), generator=gen, device=dev)
            else:
                z = draws[0][n - 1].reshape(nc, dim).to(dev)
            L = self.scale * trk.L if self.adaptive else self.fixed_L
            prop = vec + (L @ z[..., None])[..., 0]
            lpost_prop = self.logpost(_vec_to_dict(prop, self.template))
            if draws is None:
                u = torch.rand(nc, generator=gen, device=dev)
            else:
                u = draws[1][n - 1].reshape(nc).to(dev)
            accept = torch.log(u) < lpost_prop - lpost
            vec = torch.where(accept[:, None], prop, vec)
            lpost = torch.where(accept, lpost_prop, lpost)
            if self.adaptive:
                trk = self.cov_tracker.update(trk, vec)
            nacc += accept
            thetas[n].copy_(vec)
            lposts[n].copy_(lpost)
            if self.verbose > 0 and (n * self.verbose) % self.niter == 0:
                print(f"Iteration {n}, acc. rate="
                      f"{(nacc.double() / n).tolist()}")
        self._thetas, self._lposts, self._nacc = thetas, lposts, nacc
        self.tracker_state = trk

    def _finish(self):
        """The chain as ``self.chain`` (leaves (niter, ...) for one chain,
        (niter, nchains, ...) for several) and the accept counts
        ``self.nacc``, read on the host.  With chains across ranks, every
        rank's chains are gathered first (one all-gather each of the
        states, the log-posteriors and the counts)."""
        thetas, lposts = self._thetas, self._lposts
        if self._group is not None:
            from particles_tpu_torch.parallel import comm

            thetas, lposts = (
                comm.all_gather(a.transpose(0, 1).contiguous(),
                                self._group).transpose(0, 1)
                for a in (thetas, lposts))
            self._nacc = comm.all_gather(self._nacc, self._group)
        if self.nchains == 1:
            thetas, lposts = thetas[:, 0], lposts[:, 0]
        self.chain = ssp.ThetaParticles(
            theta=_vec_to_dict(thetas, self.template), lpost=lposts)
        counts = self._nacc.cpu().numpy()
        self.nacc = int(counts[0]) if self.nchains == 1 else counts

    @property
    def acc_rate(self):
        """Acceptance rate: a scalar for one chain, (nchains,) for several."""
        return self.nacc / (self.niter - 1)


class BasicRWHM(GenericRWHM):
    """Random-walk Metropolis for a ``smc_samplers.StaticModel`` posterior
    (reference mcmc.py:304-356).  The device defaults to the model's
    data's."""

    def __init__(self, niter=10, verbose=0, theta0=None, adaptive=True,
                 scale=1.0, rw_cov=None, model=None, seed=0, generator=None,
                 device=None, nchains=1, mesh=None, mesh_axis=None):
        if model is None:
            raise ValueError("BasicRWHM: model not provided")
        self.model = model
        self.prior = model.prior
        super().__init__(niter=niter, verbose=verbose, theta0=theta0,
                         adaptive=adaptive, scale=scale, rw_cov=rw_cov,
                         seed=seed, generator=generator,
                         device=_device_of(model.data, generator, device),
                         nchains=nchains, mesh=mesh, mesh_axis=mesh_axis)

    def logpost(self, theta):
        return self.model.logpost(theta)


class PMMH(GenericRWHM):
    """Particle marginal Metropolis-Hastings (reference mcmc.py:359-450):
    the likelihood in the Metropolis ratio is the logLt estimate of a
    particle filter at the proposed parameter, ``fk_cls(ssm=ssm_cls(
    **theta), data=data)`` with ``Nx`` particles (a bootstrap filter by
    default; a guided or auxiliary one as given).

    ``smc_cls`` (``core.SMC`` or ``core.SQMC``) and ``smc_options``
    (``qmc``, ``resampling``, ``ESSrmin``) choose the inner filter; any
    other raises ``ValueError``.  The device defaults to the data's.
    """

    def __init__(self, niter=10, verbose=0, ssm_cls=None, prior=None,
                 data=None, fk_cls=None, Nx=100, theta0=None,
                 adaptive=True, scale=1.0, rw_cov=None, seed=0,
                 generator=None, device=None, resampling="systematic",
                 ESSrmin=0.5, smc_cls=None, smc_options=None, nchains=1,
                 mesh=None, mesh_axis=None):
        self.ssm_cls = ssm_cls
        self.prior = prior
        device = _device_of(data, generator, device)
        self.data = _f32_data(data, device)
        self.fk_cls = ssms.Bootstrap if fk_cls is None else fk_cls
        self.Nx = Nx
        self.resampling = resampling
        self.ESSrmin = ESSrmin
        self.qmc = False
        if smc_cls is not None:
            if smc_cls is core.SQMC:
                self.qmc = True
            elif smc_cls is not core.SMC:
                raise ValueError(
                    f"PMMH: unsupported smc_cls {smc_cls!r} (use SMC or "
                    "SQMC)")
        if smc_options:
            opts = dict(smc_options)
            self.qmc = bool(opts.pop("qmc", self.qmc))
            self.resampling = opts.pop("resampling", self.resampling)
            self.ESSrmin = opts.pop("ESSrmin", self.ESSrmin)
            if opts:
                raise ValueError(
                    "PMMH: unsupported smc_options "
                    f"{sorted(opts)} (supported: qmc, resampling, ESSrmin)")
        super().__init__(niter=niter, verbose=verbose, theta0=theta0,
                         adaptive=adaptive, scale=scale, rw_cov=rw_cov,
                         seed=seed, generator=generator, device=device,
                         nchains=nchains, mesh=mesh, mesh_axis=mesh_axis)

    def alg_instance(self, theta, seed=0, generator=None):
        """A runnable ``core.SMC`` at one θ (a dict of scalars), with this
        sampler's inner-filter options."""
        fk = self.fk_cls(ssm=self.ssm_cls(**theta), data=self.data)
        return core.SMC(fk=fk, N=self.Nx, seed=seed, generator=generator,
                        collect="off", qmc=self.qmc,
                        resampling=self.resampling, ESSrmin=self.ESSrmin)

    def _loglik_qmc(self, theta):
        """Each row's logLt from an SQMC run, one row after another."""
        T = self.data.shape[0]
        out = []
        for b in range(next(iter(theta.values())).shape[0]):
            th = {k: v[b] for k, v in theta.items()}
            pf = self.alg_instance(th, generator=self.gen)
            for _ in range(T):
                next(pf)
            out.append(pf.logLt)
        return torch.stack(out)

    def loglik(self, theta):
        """The inner filter's log-likelihood estimate at each row of
        ``theta`` (a dict of (nchains, ...) tensors), (nchains,)."""
        if self.qmc:
            return self._loglik_qmc(theta)
        pf = inner_pf.InnerPF(self.fk_cls, self.ssm_cls, self.data, theta,
                              self.Nx, resampling=self.resampling,
                              ESSrmin=self.ESSrmin)
        return pf.loglik(self.gen, self.data.shape[0])

    def logpost(self, theta):
        """log prior + the inner filter's logLt where the prior is finite;
        -inf elsewhere and where the filter gave NaN (a θ outside the
        model's domain), with no host read."""
        lprior = self.prior.logpdf(theta)
        ll = self.loglik(theta)
        ok = torch.isfinite(lprior) & ~torch.isnan(ll)
        return torch.where(ok, lprior + ll, -torch.inf)


# ---------------------------------------------------------------------------
# conditional SMC and Particle Gibbs
# ---------------------------------------------------------------------------

def _csmc_step(fk, t, X, lw, log_mean_w, x_star_t, ESSrmin, A_res, move):
    """One conditional step (the body of the JAX ``_csmc_run``) given the
    multinomial ancestors ``A_res`` and the transition ``move(fk, t,
    xp)``: ``(X, lw, log_mean, loglt, A)``.  Particle 0 keeps ancestor 0
    and is set to ``x_star_t``."""
    N = lw.shape[0]
    wgts = rs.Weights(lw)
    rs_flag = wgts.ESS < N * ESSrmin
    A = torch.where(rs_flag, A_res, torch.arange(N, device=lw.device))
    A[0:1].zero_()
    Xp = X.index_select(0, A)
    lw_base = torch.where(rs_flag, torch.zeros_like(lw), lw)
    X_new = move(fk, t, Xp)
    X_new[0:1].copy_(x_star_t)
    lw_new = lw_base + fk.logG(t, Xp, X_new)
    w_new = rs.Weights(lw_new)
    loglt = torch.where(rs_flag, w_new.log_mean,
                        w_new.log_mean - log_mean_w)
    return X_new, lw_new, w_new.log_mean, loglt, A


class CSMC:
    """Conditional SMC (reference mcmc.py:453-475): a particle filter in
    which particle 0 is pinned to the trajectory ``xstar`` (T, ...), with
    ancestor 0 at every step; multinomial resampling, full history
    (``self.hist``, a ``smoothing.ParticleHistory``).  Each step draws its
    ancestors (B3, B5 and B2 on the card) and selects them on the device:
    no host read a step.  Tensor states only."""

    def __init__(self, fk=None, N=100, ESSrmin=0.5, xstar=None, seed=0,
                 generator=None, device=None):
        self.fk = fk
        self.N = N
        self.ESSrmin = ESSrmin
        self.device = _device_of(getattr(fk, "data", None), generator,
                                 device)
        self.xstar = (xstar.to(self.device) if isinstance(xstar, torch.Tensor)
                      else _f32_data(xstar, self.device))
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        self.gen = generator
        self.hist = None
        self.logLt = None

    @utils.timer
    def run(self):
        self._run()

    def _run(self):
        """The conditional filter, with no host read."""
        fk, gen, N, xstar = self.fk, self.gen, self.N, self.xstar
        X = fk.M0(gen, N)
        X[0:1].copy_(xstar[0:1])
        lw = fk.logG(0, None, X)
        w0 = rs.Weights(lw)
        log_mean_w = logLt = w0.log_mean
        Xs, As, lws = [X], [torch.arange(N, device=lw.device)], [lw]
        move = lambda fk, t, xp: fk.M(gen, t, xp)  # noqa: E731
        for t in range(1, int(fk.T)):
            A_res = rs.multinomial(gen, rs.Weights(lw).W, N)
            X, lw, log_mean_w, loglt, A = _csmc_step(
                fk, t, X, lw, log_mean_w, xstar[t:t + 1], self.ESSrmin,
                A_res, move)
            logLt = logLt + loglt
            Xs.append(X)
            As.append(A)
            lws.append(lw)
        self.hist = smoothing.ParticleHistory(
            fk, torch.stack(Xs), torch.stack(As), torch.stack(lws))
        self.X = X
        self.wgts = rs.Weights(lw)
        self.logLt = logLt


class GenericGibbs(MCMC):
    """Generic Gibbs sampler alternating θ- and state-updates
    (reference mcmc.py:482-531).  Subclasses define ``update_theta(gen,
    theta, x)`` and ``update_states(gen, theta, x)``; each sweep updates
    θ, then the states given the θ just drawn."""

    def __init__(self, niter=10, verbose=0, theta0=None, ssm_cls=None,
                 prior=None, data=None, store_x=False, seed=0,
                 generator=None, device=None):
        device = _device_of(data, generator, device)
        super().__init__(niter=niter, verbose=verbose, seed=seed,
                         generator=generator, device=device)
        self.ssm_cls = ssm_cls
        self.prior = prior
        self.data = _f32_data(data, self.device)
        self.theta0 = theta0
        self.store_x = store_x
        self._thetas = []
        self._xs = []

    def update_states(self, gen, theta, x):
        raise NotImplementedError

    def update_theta(self, gen, theta, x):
        raise NotImplementedError

    def step0(self):
        if self.theta0 is None:
            th0 = {k: v[0] for k, v in
                   self.prior.rvs(self.gen, size=1).items()}
        else:
            th0 = self.theta0
        self._thetas.append(th0)
        self.x = self.update_states(self.gen, th0, None)
        if self.store_x:
            self._xs.append(self.x)

    def step(self, n):
        new_theta = self.update_theta(self.gen, self._thetas[-1], self.x)
        self._thetas.append(new_theta)
        # the state update conditions on the θ just drawn (a stale θ breaks
        # the invariance of the systematic-scan Gibbs kernel)
        self.x = self.update_states(self.gen, new_theta, self.x)
        if self.store_x:
            self._xs.append(self.x)

    @utils.timer
    def run(self):
        self._iterate()
        theta_chain = {
            k: torch.stack([torch.as_tensor(th[k], device=self.device)
                            for th in self._thetas])
            for k in self._thetas[0]}
        if self.store_x:
            self.chain = ssp.ThetaParticles(theta=theta_chain,
                                            x=torch.stack(self._xs))
        else:
            self.chain = ssp.ThetaParticles(theta=theta_chain)


class ParticleGibbs(GenericGibbs):
    """Particle Gibbs (reference mcmc.py:533-619): the states are updated
    by conditional SMC (the first sweep by a plain ``SMC`` with
    ``store_history=True``), then one trajectory is drawn from the
    genealogy, or by backward sampling (``backward_step=True``,
    ``hist.backward_sampling_ON2``); θ's update is the user's.
    ``regenerate_data=True`` redraws the data given the new states, which
    makes the sampler a prior sampler (the reference's check)."""

    def __init__(self, niter=10, verbose=0, ssm_cls=None, prior=None,
                 data=None, theta0=None, Nx=100, fk_cls=None,
                 regenerate_data=False, backward_step=False, store_x=False,
                 seed=0, generator=None, device=None):
        super().__init__(niter=niter, verbose=verbose, ssm_cls=ssm_cls,
                         prior=prior, data=data, theta0=theta0,
                         store_x=store_x, seed=seed, generator=generator,
                         device=device)
        self.Nx = Nx
        self.fk_cls = ssms.Bootstrap if fk_cls is None else fk_cls
        self.regenerate_data = regenerate_data
        self.backward_step = backward_step

    def fk_mod(self, theta):
        return self.fk_cls(ssm=self.ssm_cls(**theta), data=self.data)

    def update_states(self, gen, theta, x):
        fk = self.fk_mod(theta)
        if x is None:
            cpf = core.SMC(fk=fk, N=self.Nx, store_history=True,
                           generator=gen)
        else:
            cpf = CSMC(fk=fk, N=self.Nx, xstar=x, generator=gen)
        cpf.run()
        if self.backward_step:
            new_x = cpf.hist.backward_sampling_ON2(gen, 1)[:, 0]
        else:
            new_x = cpf.hist.extract_one_trajectory(gen)
        if self.regenerate_data:
            self.data = fk.ssm.simulate_given_x(gen, new_x)
        return new_x
