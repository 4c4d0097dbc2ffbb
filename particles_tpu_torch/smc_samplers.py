"""SMC samplers for static-parameter inference: IBIS, tempering, waste-free
(PyTorch port).

Counterpart of ``particles_tpu/smc_samplers.py``: the
:class:`StaticModel` and :class:`TemperingBridge` targets, the
:class:`ThetaParticles` container, the Metropolis moves and their
sequences (:class:`MCMCSequenceWF`, waste-free, is the default), the
Feynman-Kac classes :class:`IBIS`, :class:`Tempering` (with its
path-sampling estimate), :class:`AdaptiveTempering` and :class:`SMC2`
(IBIS over θ, each θ-particle carrying a particle filter), the sampler step
(:func:`sampler_next`, which ``core.SMC`` calls for a sampler), the
sampler's history and the single-run waste-free variance estimators.

How this port runs them:

* **Eager steps with one host read.**  Where the JAX package compiles a
  step and picks the resample-move branch with ``lax.cond``, this step
  reads the decision ``ESS < N0 * ESSrmin`` once on the host (IBIS,
  ``Tempering``).  ``AdaptiveTempering`` always resamples: its one read
  is ``done``'s ``exponent >= 1``.  The calibration, the acceptance
  rates, the path sampling and the exponent's 60-round bisection
  (:func:`next_annealing_epn`) stay on the device.  An
  :class:`AdaptiveMCMCSequence` with ``adaptive=True`` reads its stopping
  test once a chain step, as the JAX ``while_loop`` does.
* **The waste-free resample through the kernels.**  X carries N0 = N·P
  particles; a resample-move step picks M = N starting points by the
  scheme's z-form over the N0 weights (B1 for ``systematic``; B3, and B5
  for ``multinomial`` and ``residual``) and serves every per-particle
  leaf — the θ fields, ``lpost``, ``lprior``, ``llik`` — by B2
  (:meth:`ThetaParticles.subset_by_z`, ``MAX_PAYLOADS`` leaves a launch).
  Only the counts-based schemes serve a sampler: ``killing`` and
  ``idiotic`` raise ``ValueError``.
* **The move keeps every chain state** in chain-position-major order,
  ``[x0, x1, ..., x_{P-1}]`` as (P·M, ...), the order :func:`var_wf` and
  :class:`Var_logLt` read: each leaf is written into a (P, M, ...)
  buffer, one slice a chain step.
* **Randomness is a function of its draws.**  Every move draws from the
  run's ``torch.Generator`` through ``draws(gen, x, target)`` and applies
  them in ``step_with``; the step takes ``draws`` to replay given normals
  and uniforms (the tests feed it the JAX package's).  A target that has
  randomness of its own (SMC²'s, which replays each proposed θ's filter)
  has a ``draws`` method, and a step passes it what that gave, so every
  chain step replays with fresh draws.
* **SMC²'s inner filters are rows** of one batched filter
  (:class:`particles_tpu_torch.inner_pf.InnerPF`, rows = θ-particles);
  the outer resample serves each θ-particle's (Nx,) states and
  log-weights as B2 payloads, beside the θ fields.  The exchange step
  (Nx doubled when the last move's acceptance rate falls below
  ``ar_to_increase_Nx``) reads that rate on the host, once a step after
  a resample-move.
* **The log-likelihood of all the data** (:meth:`StaticModel.loglik`) is
  one ``torch.func.vmap`` of ``logpyt`` over ``arange(T)``, in chunks of
  particles that bound its (T, n) intermediate.

* **Under particle sharding** (:func:`particles_tpu_torch.parallel.
  run_shardmap_smc`, an ``SMC`` on each rank's slice under a
  :mod:`particles_tpu_torch.distctx` context) the same step runs on every
  rank: a rank carries N0/D particles and serves N/D starting points
  through the ring of the scheme (the waste-free M != N0 shape change
  rides ``ring_serve``'s ``Mloc``); the prior draws, chain moves and SMC²
  inner filters draw from the rank's generator and the resampling
  uniforms from the replicated one; the weights, moments and acceptance
  rates are global (:func:`_dist_mean`), and the exponent's bisection,
  the path sampling and NS-SMC's level and evidence run on every rank
  on one gathered (N0,) vector (:func:`_gather_global`).  SMC²'s inner
  filters step under ``distctx.local_context()``, so that their (Nx,)
  reductions stay in their row.
"""

from __future__ import annotations

import contextlib
import copy
import math
from collections import deque

import numpy as np
import torch

from particles_tpu_torch import collectors as col
from particles_tpu_torch import core
from particles_tpu_torch import distctx
from particles_tpu_torch import inner_pf
from particles_tpu_torch import ops
from particles_tpu_torch import resampling as rs
from particles_tpu_torch import tracing
from particles_tpu_torch import variance_mcmc
from particles_tpu_torch.distributions import _cholesky
from particles_tpu_torch.parallel import comm
from particles_tpu_torch.utils import resolve_device
from particles_tpu_torch.variance_mcmc import _host

__all__ = [
    "SamplerHistory",
    "StaticModel",
    "TemperingBridge",
    "ThetaParticles",
    "ImportanceSampler",
    "ArrayMCMC",
    "ArrayMetropolis",
    "ArrayRandomWalk",
    "ArrayIndependentMetropolis",
    "MCMCSequence",
    "MCMCSequenceWF",
    "AdaptiveMCMCSequence",
    "FKSMCsampler",
    "IBIS",
    "Tempering",
    "AdaptiveTempering",
    "SMC2",
    "next_annealing_epn",
    "var_wf",
    "Var_phi",
    "Var_logLt",
    "view_2d_array",
    "theta_from_2d",
    "rec_to_dict",
    "all_distinct",
    "FancyList",
    "gen_concatenate",
]

# elements of the (T, n) log-likelihood block one vmap pass holds
# (128 MiB of float32): StaticModel.loglik takes the particles in chunks
# of LOGLIK_CHUNK // T
LOGLIK_CHUNK = 2 ** 25
# the exponent's bisection rounds and the path-sampling grid, as in the
# JAX package
BISECTION_ROUNDS = 60
PATH_SAMPLING_GRID = 10


# ---------------------------------------------------------------------------
# particle sharding
# ---------------------------------------------------------------------------

def _gN(n):
    """The global particle count for a rank's ``n`` (``n`` itself outside a
    :mod:`particles_tpu_torch.distctx` context)."""
    ctx = distctx.current()
    return n if ctx is None else n * ctx.D


def _dist_mean(v):
    """The mean of the (n,) ``v`` over every rank's particles (one
    all-reduce under a context): the same on every rank."""
    ctx = distctx.current()
    if ctx is None:
        return v.mean()
    (s,) = comm.psum(v.sum(), group=ctx.group)
    return s / (v.shape[0] * ctx.D)


def _gather_global(v):
    """The global (n D,) vector of the ranks' (n,) ``v``, in rank order, on
    every rank (one all-gather; the identity outside a context).  The
    exponent's bisection (~60 ESS evaluations), the path sampling and
    NS-SMC's level and evidence then run the same on every rank: a
    rank-local quantile or ``log_sum_exp`` there would be silently
    wrong."""
    ctx = distctx.current()
    return v if ctx is None else comm.all_gather(v, ctx.group)


# ---------------------------------------------------------------------------
# static models
# ---------------------------------------------------------------------------

class StaticModel:
    """Base class for static (parameter-inference) models
    (reference smc_samplers.py:216-301).

    Subclass and define ``logpyt(theta, t)``: the log-density of datapoint
    t given parameters ``theta`` (a dict of (N,) or (N, d) tensors) and
    the past data.  :meth:`loglik` calls it under ``torch.func.vmap`` with
    ``t`` a batched 0-d index tensor, so it must index ``self.data[t]``
    (or otherwise use ``t`` as a tensor) and take no Python branch on a
    tensor's value.

    ``data`` that is not a tensor becomes a tensor on ``device`` (float32
    if floating), by default the current CUDA card (with no card, pass
    ``device="cpu"``); a tensor keeps its device.
    """

    def __init__(self, data=None, prior=None, device=None):
        if data is not None and not isinstance(data, torch.Tensor):
            a = np.asarray(data)
            dtype = (torch.float32 if np.issubdtype(a.dtype, np.floating)
                     else None)
            data = torch.as_tensor(a, dtype=dtype,
                                   device=resolve_device(device))
        self.data = data
        self.prior = prior

    @property
    def T(self):
        return 0 if self.data is None else self.data.shape[0]

    def logpyt(self, theta, t):
        raise NotImplementedError("StaticModel: logpyt not implemented")

    def loglik(self, theta, t=None):
        """Log-likelihood of the data up to time ``t`` (all of it by
        default): a masked sum over ``arange(T) <= t`` of every
        ``logpyt``, so IBIS's ``logpost(t=t-1)`` and the full likelihood
        are one code path; NaN -> -inf (reference smc_samplers.py:263-284).
        """
        T = self.T
        if t is None:
            t = T - 1
        N = _n_particles(theta)
        dev = _leaf(theta).device
        ts = torch.arange(T, device=dev)
        mask = (ts <= t)[:, None]
        chunk = max(1, LOGLIK_CHUNK // max(T, 1))
        parts = []
        for s in range(0, N, chunk):
            th = theta if N <= chunk else {
                k: v[s:s + chunk] for k, v in theta.items()}
            all_l = torch.func.vmap(lambda tt, th=th: self.logpyt(th, tt))(ts)
            parts.append(torch.where(mask, all_l, 0.0).sum(0))
        lik = parts[0] if len(parts) == 1 else torch.cat(parts)
        return torch.where(torch.isnan(lik), -torch.inf, lik)

    def logpost(self, theta, t=None):
        """Posterior log-density up to datapoint t (smc_samplers.py:286-301)."""
        return self.prior.logpdf(theta) + self.loglik(theta, t)


class TemperingBridge(StaticModel):
    """Bridge distributions between a base law and a target
    (reference smc_samplers.py:304-313): define ``logtarget``."""

    def __init__(self, base_dist=None):
        self.prior = base_dist
        self.data = None

    def logtarget(self, theta):
        raise NotImplementedError

    def loglik(self, theta, t=None):
        return self.logtarget(theta) - self.prior.logpdf(theta)

    def logpost(self, theta, t=None):
        return self.logtarget(theta)


# ---------------------------------------------------------------------------
# theta-particles container
# ---------------------------------------------------------------------------

def _leaf(theta):
    return next(iter(theta.values()))


def _n_particles(theta):
    return _leaf(theta).shape[0]


def rec_to_dict(arr):
    """A single-particle theta as a plain dict (reference
    smc_samplers.py:1030-1034 converts record arrays; these thetas are
    dicts already)."""
    if isinstance(arr, dict):
        return dict(arr)
    return {k: arr[k] for k in getattr(arr, "dtype").names}


def view_2d_array(theta):
    """A dict-of-tensors theta as one (N, d) matrix, its fields' columns
    in order (counterpart of reference view_2d_array,
    smc_samplers.py:383-398, which reinterprets record arrays)."""
    cols = [v[:, None] if v.ndim == 1 else v.reshape(v.shape[0], -1)
            for v in theta.values()]
    return torch.cat(cols, 1)


def theta_from_2d(arr, template):
    """Inverse of :func:`view_2d_array` given a template dict: views of
    ``arr``'s columns."""
    out = {}
    j = 0
    for k, v in template.items():
        if v.ndim == 1:
            out[k] = arr[:, j]
            j += 1
        else:
            d = math.prod(v.shape[1:])
            out[k] = arr[:, j:j + d].reshape((arr.shape[0],) + v.shape[1:])
            j += d
    return out


def _width(theta):
    """d, the columns of :func:`view_2d_array` of ``theta``."""
    return sum(math.prod(v.shape[1:]) for v in theta.values())


def all_distinct(l, idx):
    """``[l[i] for i in idx]`` with repeated picks deep-copied, so that
    every element of the result is a distinct object (counterpart of
    reference smc_samplers.py:319-340).  A host-side helper for
    list-of-objects containers."""
    picked = set()
    out = []
    for i in idx:
        i = int(i)
        out.append(copy.deepcopy(l[i]) if i in picked else l[i])
        picked.add(i)
    return out


class FancyList:
    """List with array fancy indexing and copy-on-duplicate semantics
    (counterpart of reference smc_samplers.py:343-380): indexing with an
    integer array (numpy or tensor) resamples the list by
    :func:`all_distinct`."""

    def __init__(self, data):
        self.data = list(data) if data is not None else []

    def __iter__(self):
        return iter(self.data)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, key):
        if isinstance(key, torch.Tensor):
            key = key.cpu().numpy()
        if isinstance(key, np.ndarray):
            return type(self)(all_distinct(self.data, key))
        return self.data[key]

    def __add__(self, other):
        return type(self)(self.data + other.data)

    @classmethod
    def concatenate(cls, *ls):
        out = []
        for l in ls:
            out.extend(l.data)
        return cls(out)

    def copy(self):
        return copy.deepcopy(self)

    def copyto(self, src, where=None):
        """numpy.copyto semantics: ``self.data[n] = src.data[n]`` where
        ``where[n]`` is true."""
        for n in range(len(self.data)):
            if where[n]:
                self.data[n] = src.data[n]


def gen_concatenate(*xs):
    """Concatenate tensors, arrays or FancyLists (counterpart of reference
    smc_samplers.py:394-398)."""
    x0 = xs[0]
    if isinstance(x0, torch.Tensor):
        return torch.cat(xs)
    if isinstance(x0, np.ndarray):
        return np.concatenate(xs)
    return type(x0).concatenate(*xs)


def _flatten(fields):
    """The tensors of ``fields`` (name -> tensor or dict of tensors), in
    order, and a function that rebuilds the fields from such a list."""
    leaves, spec = [], []
    for k, v in fields.items():
        if isinstance(v, dict):
            spec.append((k, list(v)))
            leaves.extend(v.values())
        else:
            spec.append((k, None))
            leaves.append(v)

    def unflatten(new):
        out, i = {}, 0
        for k, sub in spec:
            if sub is None:
                out[k] = new[i]
                i += 1
            else:
                out[k] = dict(zip(sub, new[i:i + len(sub)]))
                i += len(sub)
        return out

    return leaves, unflatten


class ThetaParticles:
    """N particles with named parameter fields and shared state
    (reference smc_samplers.py:401-500).

    ``theta`` is a dict of (N,) / (N, d) tensors; other keyword fields
    (``lpost``, ``llik``, ...) are per-particle tensors; ``shared`` is a
    dict of state common to all particles (the tempering exponent, the
    path-sampling sum, the calibrated proposal, the acceptance rate), as
    0-d or small tensors on the device.  Every operation returns a new
    object.
    """

    def __init__(self, theta=None, shared=None, **fields):
        self.theta = theta
        self.shared = {} if shared is None else dict(shared)
        self.__dict__.update(fields)

    @property
    def N(self):
        return _n_particles(self.theta)

    def _particle_fields(self):
        return {k: v for k, v in self.__dict__.items() if k != "shared"}

    def replace(self, **fields):
        """A copy with ``fields`` replaced (``shared`` kept)."""
        new = self._particle_fields()
        new.update(fields)
        return ThetaParticles(shared=dict(self.shared), **new)

    def _leaves(self):
        return _flatten(self._particle_fields())

    def map_fields(self, f):
        """``f`` applied to every per-particle tensor (theta's included)."""
        leaves, unflatten = self._leaves()
        return ThetaParticles(shared=dict(self.shared),
                              **unflatten([f(a) for a in leaves]))

    def subset_by_z(self, z, M):
        """The resampling move by the z-form ``z`` ((N,) int32, the
        inclusive cumsum of the offspring counts): M particles, every
        per-particle tensor served by B2, ``ops.MAX_PAYLOADS`` of them a
        launch (the plain version for CPU tensors)."""
        leaves, unflatten = self._leaves()
        served, _ = ops.repeat_cols(z, M, [a.contiguous() for a in leaves])
        return ThetaParticles(shared=dict(self.shared), **unflatten(served))

    def subset_by_counts(self, counts, M):
        """The resampling move by offspring counts (sorted ancestors):
        :meth:`subset_by_z` of their cumsum."""
        return self.subset_by_z(torch.cumsum(counts, 0, dtype=torch.int32),
                                M)

    def subset(self, A):
        """The resampling move by ancestor indices (reference fancy
        indexing, smc_samplers.py:437-452; tensors alias nothing mutable,
        so no copy on a duplicate)."""
        return self.map_fields(lambda a: a.index_select(0, A))

    def where(self, mask, other, out=None):
        """Per-particle select: ``self`` where ``mask``, else ``other``.
        ``out``, a list of tensors in the order of the leaves, receives the
        result in place."""
        mine, unflatten = self._leaves()
        theirs, _ = other._leaves()
        new = []
        for i, (a, b) in enumerate(zip(mine, theirs, strict=True)):
            m = mask.reshape((-1,) + (1,) * (a.ndim - 1))
            if out is None:
                new.append(torch.where(m, a, b))
            else:
                new.append(torch.where(m, a, b, out=out[i]))
        return ThetaParticles(shared=dict(self.shared), **unflatten(new))

    @staticmethod
    def concatenate(*xs):
        """Concatenate particle systems along the particle axis
        (reference smc_samplers.py:453-460); ``shared`` from the last."""
        flat = [x._leaves() for x in xs]
        unflatten = flat[0][1]
        leaves = [torch.cat(group) for group in
                  zip(*(f[0] for f in flat), strict=True)]
        return ThetaParticles(shared=dict(xs[-1].shared),
                              **unflatten(leaves))

    def with_shared(self, **updates):
        shared = dict(self.shared)
        shared.update(updates)
        return ThetaParticles(shared=shared, **self._particle_fields())

    def copy(self):
        return ThetaParticles(shared=dict(self.shared),
                              **self._particle_fields())


# ---------------------------------------------------------------------------
# importance sampler
# ---------------------------------------------------------------------------

class ImportanceSampler:
    """Basic importance sampling with the SMC-sampler interface
    (reference smc_samplers.py:506-547)."""

    def __init__(self, model=None, proposal=None):
        self.proposal = model.prior if proposal is None else proposal
        self.model = model

    def run(self, N=100, seed=0, generator=None, device=None):
        """Draw N particles from ``generator`` (else one seeded by
        ``seed`` on ``device``, by default the model's data's, else the
        current CUDA card) and weight them: ``X``, ``wgts`` and
        ``log_norm_cst``."""
        gen = generator
        if gen is None:
            if device is None and isinstance(self.model.data, torch.Tensor):
                device = self.model.data.device
            gen = torch.Generator(device=resolve_device(device))
            gen.manual_seed(seed)
        th = self.proposal.rvs(gen, size=N)
        lpost = self.model.logpost(th)
        self.X = ThetaParticles(theta=dict(th), lpost=lpost)
        self.wgts = rs.Weights(lw=lpost - self.proposal.logpdf(th))
        self.log_norm_cst = self.wgts.log_mean


# ---------------------------------------------------------------------------
# MCMC moves
# ---------------------------------------------------------------------------

class ArrayMCMC:
    """Base class for one MCMC step applied to all particles at once
    (reference smc_samplers.py:553-592)."""

    def calibrate(self, W, x):
        """A dict of shared-state updates tuned on the weighted cloud."""
        return {}

    def draws(self, gen, x, target=None):
        """The randomness of one step, drawn from ``gen``: a tuple that
        :meth:`step_with` takes after ``x`` and ``target``.  A ``target``
        with a ``draws(gen, x)`` method of its own adds what that gives."""
        raise NotImplementedError

    def step_with(self, x, target, *draws, out=None):
        """One step of every particle given its ``draws``: ``(new_x,
        mean acceptance probability)``; ``out`` as in
        :meth:`ThetaParticles.where`."""
        raise NotImplementedError

    def step(self, gen, x, target, out=None):
        return self.step_with(x, target, *self.draws(gen, x, target),
                              out=out)


class ArrayMetropolis(ArrayMCMC):
    """Metropolis step, any proposal (reference smc_samplers.py:596-612).

    A subclass defines ``proposal(z, x, arr)`` -> (proposed (N, d)
    matrix, per-particle delta log-proposal) for the standard normals
    ``z`` ((N, d)) and the current matrix ``arr``.  A step draws ``z``,
    then N uniforms for the accept test (the JAX package's ``k1`` and
    ``k2``), then, for a target with ``draws``, the target's randomness
    (``tdraws``, passed to ``target(x, tdraws)``)."""

    def proposal(self, z, x, arr):
        raise NotImplementedError

    def draws(self, gen, x, target=None):
        shape = (x.N, _width(x.theta))
        dev = gen.device
        z = torch.randn(shape, generator=gen, device=dev)
        u = torch.rand(x.N, generator=gen, device=dev)
        if hasattr(target, "draws"):
            return z, u, target.draws(gen, x)
        return z, u

    def step_with(self, x, target, z, u, tdraws=None, out=None):
        arr = view_2d_array(x.theta)
        arr_prop, delta_lp = self.proposal(z, x, arr)
        # replace() keeps every other per-particle field, so the proposal
        # and the current system share one structure
        xx = x.replace(theta=theta_from_2d(arr_prop, x.theta))
        xprop = target(xx) if tdraws is None else target(xx, tdraws)
        lp_acc = xprop.lpost - x.lpost + delta_lp
        # a NaN log-posterior (a proposal outside the prior's support)
        # means reject
        lp_acc = torch.where(torch.isnan(lp_acc), -torch.inf, lp_acc)
        pb_acc = torch.exp(lp_acc.clamp(max=0.0))
        accept = u < pb_acc
        return xprop.where(accept, x, out=out), _dist_mean(pb_acc)


class ArrayRandomWalk(ArrayMetropolis):
    """Gaussian random-walk Metropolis with the 2.38/sqrt(d) scaling of
    the weighted covariance (reference smc_samplers.py:614-629)."""

    def calibrate(self, W, x):
        arr = view_2d_array(x.theta)
        d = arr.shape[1]
        _, cov = rs.wmean_and_cov(W, arr)
        # jitter for a positive definite covariance at startup
        eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
        L = _cholesky(cov + 1e-9 * eye)
        return {"chol_cov": (2.38 / math.sqrt(d)) * L}

    def proposal(self, z, x, arr):
        return arr + z @ x.shared["chol_cov"].T, 0.0


class ArrayIndependentMetropolis(ArrayMetropolis):
    """Independent Metropolis with a Gaussian proposal matched to the
    weighted cloud (reference smc_samplers.py:632-652)."""

    def __init__(self, scale=1.0):
        self.scale = scale

    def calibrate(self, W, x):
        arr = view_2d_array(x.theta)
        m, cov = rs.wmean_and_cov(W, arr)
        d = arr.shape[1]
        eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
        L = _cholesky(cov + 1e-9 * eye)
        return {"mean": m, "chol_cov": self.scale * L}

    def proposal(self, z, x, arr):
        mu, L = x.shared["mean"], x.shared["chol_cov"]
        # (arr - mu) L^-T as one (N, d) x (d, d) product: a triangular
        # solve with one right-hand side a particle stalls the card
        eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        zx = (arr - mu) @ Linv.T
        delta_lp = 0.5 * ((z * z).sum(1) - (zx * zx).sum(1))
        return mu + z @ L.T, delta_lp


class MCMCSequence:
    """A fixed-length sequence of MCMC steps (reference
    smc_samplers.py:655-667): ``len_chain - 1`` steps of ``mcmc``.

    Called as ``move(gen, x, target, draws=None)``; ``draws``, a list of
    one step's draws per chain step (see :meth:`ArrayMCMC.draws`),
    replays given randomness in place of ``gen``'s."""

    def __init__(self, mcmc=None, len_chain=10):
        self.mcmc = ArrayRandomWalk() if mcmc is None else mcmc
        self.nsteps = len_chain - 1

    def calibrate(self, W, x):
        return self.mcmc.calibrate(W, x)

    def _draws(self, gen, x, draws, i, target):
        if draws is None:
            return self.mcmc.draws(gen, x, target)
        return draws[i]

    def __call__(self, gen, x, target, draws=None):
        raise NotImplementedError


class MCMCSequenceWF(MCMCSequence):
    """Waste-free move: keeps ALL chain states — the M starting points and
    P - 1 steps, P·M particles (reference smc_samplers.py:669-683), in
    chain-position-major order ``[x0, x1, ..., x_{P-1}]``, the order of
    :func:`var_wf`'s (P, M) reshape.  Each leaf is a (P, M, ...) buffer;
    step i writes slice i + 1 in place, with no concatenation."""

    def __call__(self, gen, x, target, draws=None):
        leaves, unflatten = x._leaves()
        P = self.nsteps + 1
        bufs = [torch.empty((P,) + a.shape, dtype=a.dtype, device=a.device)
                for a in leaves]
        for b, a in zip(bufs, leaves):
            b[0].copy_(a)
        xc = ThetaParticles(shared=dict(x.shared),
                            **unflatten([b[0] for b in bufs]))
        accs = []
        for i in range(self.nsteps):
            xc, acc = self.mcmc.step_with(
                xc, target, *self._draws(gen, xc, draws, i, target),
                out=[b[i + 1] for b in bufs])
            accs.append(acc)
        out = ThetaParticles(shared=dict(x.shared), **unflatten(
            [b.reshape((-1,) + b.shape[2:]) for b in bufs]))
        return out.with_shared(acc_rate=_mean_of(accs, x))


def _mean_of(accs, x):
    if accs:
        return torch.stack(accs).mean()
    return torch.full((), torch.nan, device=_leaf(x.theta).device)


class AdaptiveMCMCSequence(MCMCSequence):
    """Standard move: keeps the final states only; with ``adaptive=True``
    it stops early once the cloud's mean distance from its start moves by
    less than ``delta_dist`` of itself (reference smc_samplers.py:686-711).
    That test is read on the host once a chain step (the JAX package's
    ``while_loop`` condition).  The acceptance rate is the mean over the
    steps taken."""

    def __init__(self, mcmc=None, len_chain=10, adaptive=False,
                 delta_dist=0.1):
        super().__init__(mcmc=mcmc, len_chain=len_chain)
        self.adaptive = adaptive
        self.delta_dist = delta_dist

    def __call__(self, gen, x, target, draws=None):
        accs = []
        if not self.adaptive:
            for i in range(self.nsteps):
                x, acc = self.mcmc.step_with(
                    x, target, *self._draws(gen, x, draws, i, target))
                accs.append(acc)
            return x.with_shared(acc_rate=_mean_of(accs, x))
        arr0 = view_2d_array(x.theta)
        dist = arr0.new_zeros(())
        i, go = 0, True
        while go and i < self.nsteps:
            x, acc = self.mcmc.step_with(
                x, target, *self._draws(gen, x, draws, i, target))
            accs.append(acc)
            diff = view_2d_array(x.theta) - arr0
            new_dist = _dist_mean(torch.linalg.vector_norm(diff, dim=1))
            go_t = (new_dist - dist).abs() >= self.delta_dist * dist
            dist = new_dist
            i += 1
            if i < self.nsteps:
                with tracing.sync("chain"):
                    go = bool(go_t)     # the chain step's host read
        # the REALISED acceptance rate of this move (a stale value made
        # SMC2's Nx doubling fire forever in the JAX package)
        acc_sum = torch.stack(accs).sum() if accs else dist
        return x.with_shared(acc_rate=acc_sum / max(i, 1))


# ---------------------------------------------------------------------------
# Feynman-Kac classes for SMC samplers
# ---------------------------------------------------------------------------

class FKSMCsampler(core.FeynmanKac):
    """Base Feynman-Kac class for SMC samplers (reference
    smc_samplers.py:714-769).

    With ``wastefree=True`` (the default) ``M0`` draws N·len_chain
    particles, and each resample-move step picks N starting points and
    keeps every chain state.  ``core.SMC`` runs it through
    :func:`sampler_next`.
    """

    is_sampler = True

    def __init__(self, model=None, wastefree=True, len_chain=10, move=None):
        self.model = model
        self.wastefree = wastefree
        self.len_chain = len_chain
        if move is None:
            move = (MCMCSequenceWF(len_chain=len_chain) if wastefree
                    else AdaptiveMCMCSequence(len_chain=len_chain))
        self.move = move

    @property
    def T(self):
        return self.model.T

    def N0(self, N):
        """Particles carried for the user's N."""
        return N * self.len_chain if self.wastefree else N

    def default_moments(self, W, x):
        return rs.wmean_and_var_str_array(W, x.theta)

    def summary_format(self, smc):
        """Reads the acceptance rate and the ESS on the host (two syncs,
        under ``verbose`` only)."""
        acc = smc.X.shared.get("acc_rate", None)
        extra = "" if acc is None else f", Metropolis acc. rate: {float(acc):.3f}"
        return f"t={smc.t}{extra}, ESS={float(smc.wgts.ESS):.2f}"

    def time_to_resample(self, view):
        # against the particles carried, N0 (global under sharding)
        return view.aux.ESS < _gN(view.X.N) * view.ESSrmin

    # --- the hooks of the sampler step ---

    def M0(self, gen, N):
        return self._M0(gen, self.N0(N))

    def move_target(self, t, x):
        """Target of the MCMC move at time t (reads ``x.shared``)."""
        raise NotImplementedError

    def logG_and_update(self, t, x, gen=None):
        """(log-potential increments, updated particles); ``gen`` is the
        run's generator, for a model whose update draws (SMC²)."""
        raise NotImplementedError


def _uniform_weights(N0, like):
    """Equal weights of the rank's N0 particles, normalised over the
    global count (calibrate's moments are global under sharding)."""
    return torch.full((N0,), 1.0 / _gN(N0), dtype=torch.float32,
                      device=like.device)


def _zero(like):
    return torch.zeros((), dtype=torch.float32, device=like.device)


class IBIS(FKSMCsampler):
    """Iterated batch importance sampling: the sequence of partial
    posteriors (reference smc_samplers.py:772-794)."""

    def _M0(self, gen, N0):
        with tracing.span("model"):
            th = dict(self.model.prior.rvs(gen, size=N0))
            lpost = self.model.prior.logpdf(th)
        x = ThetaParticles(theta=th, lpost=lpost)
        cal = self.move.calibrate(_uniform_weights(N0, _leaf(th)), x)
        return x.with_shared(acc_rate=_zero(_leaf(th)), **cal)

    def move_target(self, t, x):
        def target(xx):
            with tracing.span("model"):
                lpost = self.model.logpost(xx.theta, t=t - 1)
            return xx.replace(lpost=lpost)

        return target

    def logG_and_update(self, t, x, gen=None):
        with tracing.span("model"):
            lpyt = self.model.logpyt(x.theta, t)
        lpyt = torch.where(torch.isnan(lpyt), -torch.inf, lpyt)
        return lpyt, x.replace(lpost=x.lpost + lpyt)


class Tempering(FKSMCsampler):
    """Tempering SMC with fixed exponents (reference
    smc_samplers.py:797-875), with the path-sampling estimate of log Z in
    ``X.shared['path_sampling']``.  The exponents are float32 values read
    from the host."""

    def __init__(self, model=None, wastefree=True, len_chain=10, move=None,
                 exponents=None):
        super().__init__(model=model, wastefree=wastefree,
                         len_chain=len_chain, move=move)
        self.exponents = (None if exponents is None else
                          np.asarray(exponents, dtype=np.float32))

    @property
    def T(self):
        return self.exponents.shape[0]

    def _M0(self, gen, N0):
        with tracing.span("model"):
            th = dict(self.model.prior.rvs(gen, size=N0))
            lprior = self.model.prior.logpdf(th)
            llik = self.model.loglik(th)
        x = ThetaParticles(theta=th, lprior=lprior, llik=llik, lpost=lprior)
        like = _leaf(th)
        cal = self.move.calibrate(_uniform_weights(N0, like), x)
        return x.with_shared(exponent=_zero(like), path_sampling=_zero(like),
                             acc_rate=_zero(like), **cal)

    def current_target(self, epn):
        def target(xx):
            with tracing.span("model"):
                lprior = self.model.prior.logpdf(xx.theta)
                llik = self.model.loglik(xx.theta)
            lpost = lprior + torch.where(epn > 0.0, epn * llik, 0.0)
            return xx.replace(lprior=lprior, llik=llik, lpost=lpost)

        return target

    def move_target(self, t, x):
        return self.current_target(x.shared["exponent"])

    def _path_sampling_update(self, x, delta, llik_all=None):
        """Trapezoidal path-sampling increment over a 10-point grid of
        exponents in [0, delta] (reference smc_samplers.py:821-834), the
        grid's softmaxes as one (10, N0) pass.  A particle with llik =
        -inf has weight 0 and adds 0 (not 0 * -inf = NaN).  It reads the
        global log-likelihoods: ``llik_all`` when given, else gathered
        (:func:`_gather_global`)."""
        g = PATH_SAMPLING_GRID
        binwidth = delta / (g - 1)
        llik = _gather_global(x.llik) if llik_all is None else llik_all
        finite = torch.isfinite(llik)
        llik_f = torch.where(finite, llik, 0.0)
        i = torch.arange(g, dtype=torch.float32, device=llik.device)
        mult = torch.where((i == 0) | (i == g - 1), 0.5, 1.0)
        e = i * binwidth
        logits = torch.where(finite, e[:, None] * llik, -torch.inf)
        w = torch.softmax(logits, dim=1)
        inc = (mult * binwidth * (w * llik_f).sum(1)).sum()
        return x.shared["path_sampling"] + inc

    def _logG_tempering(self, x, delta, new_epn, llik_all=None):
        dl = delta * x.llik
        dl = torch.where(torch.isnan(dl), -torch.inf, dl)
        ps = self._path_sampling_update(x, delta, llik_all)
        x = x.replace(lpost=x.lpost + dl)
        return dl, x.with_shared(exponent=new_epn, path_sampling=ps)

    def logG_and_update(self, t, x, gen=None):
        epn = x.shared["exponent"]
        new_epn = epn.new_full((), float(self.exponents[t]))
        return self._logG_tempering(x, new_epn - epn, new_epn)


def next_annealing_epn(epn, alpha, lw):
    """The next tempering exponent, such that ESS((e - epn) lw) = alpha N:
    a bisection of BISECTION_ROUNDS rounds over the increment, on the
    device (the reference solves it with Brent's method on the host,
    smc_samplers.py:876-895).  ``epn`` is a 0-d tensor; NaN in ``lw``
    counts as -inf; returns 1.0 where even the full increment keeps the
    ESS at or above alpha N."""
    N = lw.shape[0]
    lw = torch.where(torch.isnan(lw), -torch.inf, lw)

    def f(delta):
        ess = torch.where(delta > 0.0, rs.essl(delta * lw), float(N))
        return ess - alpha * N

    hi = 1.0 - epn
    a, b = torch.zeros_like(hi), hi
    for _ in range(BISECTION_ROUNDS):
        m = 0.5 * (a + b)
        # f decreases in delta: move right while above the target
        go_right = f(m) > 0.0
        a, b = torch.where(go_right, m, a), torch.where(go_right, b, m)
    return torch.where(f(hi) >= 0.0, 1.0, epn + 0.5 * (a + b))


class AdaptiveTempering(Tempering):
    """Adaptive tempering: each exponent chosen so that ESS = ESSrmin·N0
    (reference smc_samplers.py:897-936).  Always resamples; ``done``
    reads ``exponent >= 1`` on the host, the step's one sync."""

    always_resample = True

    def __init__(self, model=None, wastefree=True, len_chain=10, move=None,
                 ESSrmin=0.5, max_iter=1000):
        FKSMCsampler.__init__(self, model=model, wastefree=wastefree,
                              len_chain=len_chain, move=move)
        self.ESSrmin = ESSrmin
        self.max_iter = max_iter
        self.exponents = None

    def done(self, smc):
        if smc.t >= self.max_iter:
            return True
        if smc.X is None:
            return False
        with tracing.sync("done"):
            return bool(smc.X.shared["exponent"] >= 1.0)

    def time_to_resample(self, view):
        return True

    def logG_and_update(self, t, x, gen=None):
        # one gather serves the bisection and the path sampling, the same
        # on every rank under sharding
        epn = x.shared["exponent"]
        llik_all = _gather_global(x.llik)
        with tracing.span("sampler.epn_search"):
            new_epn = next_annealing_epn(epn, self.ESSrmin, llik_all)
        return self._logG_tempering(x, new_epn - epn, new_epn, llik_all)


# ---------------------------------------------------------------------------
# SMC²
# ---------------------------------------------------------------------------

class _ReplayTarget:
    """SMC²'s move target at time t: prior(θ) times the likelihood of the
    observations 0..t-1 estimated by a fresh filter of ``Nx`` particles at
    each proposed θ (the replay, reference smc_samplers.py:1129-1143).
    Its randomness is the generator it replays from (``draws``), so that
    every chain step replays with fresh draws."""

    def __init__(self, fk, t, Nx):
        self.fk, self.t, self.Nx = fk, t, Nx

    def draws(self, gen, x):
        return gen

    def __call__(self, xx, gen=None):
        if gen is None:
            raise ValueError("SMC2's move target replays each θ's filter: "
                             "call it with a generator (its draws)")
        tracing.count("smc2.replays")
        with tracing.span("smc2.replay", t=self.t), \
                distctx.local_context():
            xs, lws, ll = self.fk._inner(xx.theta, self.Nx).replay(gen,
                                                                   self.t)
        return xx.replace(xs=xs, lws=lws, loglik=ll,
                          lpost=self.fk.prior.logpdf(xx.theta) + ll)


class SMC2(FKSMCsampler):
    """SMC² (Chopin, Jacob & Papaspiliopoulos 2013): IBIS over θ in which
    each θ-particle carries a particle filter of ``Nx`` particles for its
    likelihood (reference smc_samplers.py:1038-1167).

    The particles carry ``theta``, ``xs`` (N0, Nx[, dx]) and ``lws``
    (N0, Nx), the inner filters' states and log-weights, ``loglik``, their
    log-likelihood estimates, and ``lpost``.  Every inner filter is a row
    of one :class:`~particles_tpu_torch.inner_pf.InnerPF`: a step advances
    them all at once.  The resample serves whole inner filters (their rows)
    through B2.  The MCMC move's target replays each proposed θ's filter
    over the observations 0..t-1 (:class:`_ReplayTarget`); the exchange
    step (:meth:`maybe_exchange`) doubles Nx.

    ``fk_cls`` is ``Bootstrap`` (the default) or ``GuidedPF``; an
    auxiliary filter raises ``ValueError`` (the JAX package silently runs
    a guided filter there).  ``smc_options`` takes ``resampling`` and
    ``ESSrmin`` for the inner filters and raises on anything else.  Not
    waste-free by default, as in the JAX package; with ``wastefree=True``
    the inner filters' rows ride the move's (P, M, ...) buffers.
    """

    def __init__(self, ssm_cls=None, prior=None, data=None, init_Nx=100,
                 fk_cls=None, wastefree=False, len_chain=10, move=None,
                 ar_to_increase_Nx=-1.0, smc_options=None, device=None):
        from particles_tpu_torch import state_space_models as ssms

        super().__init__(model=StaticModel(data=data, prior=prior,
                                           device=device),
                         wastefree=wastefree, len_chain=len_chain, move=move)
        self.ssm_cls = ssm_cls
        self.prior = prior
        self.data = self.model.data
        self.init_Nx = init_Nx
        self.fk_cls = ssms.Bootstrap if fk_cls is None else fk_cls
        if getattr(self.fk_cls, "logeta", None) is not None:
            raise ValueError(
                f"SMC2: fk_cls={self.fk_cls.__name__} is an auxiliary "
                "filter, which SMC2's inner step does not run (use "
                "Bootstrap or GuidedPF)")
        self.ar_to_increase_Nx = ar_to_increase_Nx
        opts = dict(smc_options or {})
        self.inner_resampling = opts.pop("resampling", "systematic")
        self.inner_ESSrmin = float(opts.pop("ESSrmin", 0.5))
        if opts:
            raise ValueError(
                f"SMC2: unsupported smc_options {sorted(opts)} "
                "(supported: resampling, ESSrmin)")
        schemes = inner_pf.BATCHED_SCHEMES + inner_pf.ROW_LOOP_SCHEMES
        if self.inner_resampling not in schemes:
            raise ValueError(f"SMC2: smc_options resampling="
                             f"{self.inner_resampling!r}; the inner filters "
                             f"take one of {schemes}")
        self.exchanges = []          # (t, new Nx) of the run's exchanges

    @property
    def T(self):
        return self.data.shape[0]

    def _inner(self, theta, Nx):
        """The inner filters of the θ-particles ``theta`` (one a row)."""
        return inner_pf.InnerPF(self.fk_cls, self.ssm_cls, self.data, theta,
                                Nx, resampling=self.inner_resampling,
                                ESSrmin=self.inner_ESSrmin)

    def _M0(self, gen, N0):
        self.exchanges = []          # a new run
        th = dict(self.prior.rvs(gen, size=N0))
        with distctx.local_context():    # each row's reductions its own
            xs, lws, ll = self._inner(th, self.init_Nx).init(gen)
        x = ThetaParticles(theta=th, lpost=self.prior.logpdf(th) + ll,
                           xs=xs, lws=lws, loglik=ll)
        cal = self.move.calibrate(_uniform_weights(N0, ll), x)
        return x.with_shared(acc_rate=_zero(ll), **cal)

    def logG_and_update(self, t, x, gen=None):
        """Advance every inner filter one step; the potential is each
        one's likelihood increment.  At t = 0 the filters have already
        weighted y_0 (in ``_M0``): the potential is that increment, and no
        filter steps."""
        if t == 0:
            return x.loglik, x
        with distctx.local_context():
            xs, lws, loglt = self._inner(x.theta, x.xs.shape[1]).step(
                gen, t, x.xs, x.lws)
        return loglt, x.replace(xs=xs, lws=lws, loglik=x.loglik + loglt,
                                lpost=x.lpost + loglt)

    def move_target(self, t, x):
        return _ReplayTarget(self, t, x.xs.shape[1])

    # -- the exchange step (Nx doubled) -------------------------------------

    def _replay_all(self, gen, x, t, new_Nx):
        """Every θ-particle's filter run afresh with ``new_Nx`` particles
        over the observations 0..t-1: ``(xs, lws, loglik)``."""
        tracing.count("smc2.replays")
        with tracing.span("smc2.replay", t=t), distctx.local_context():
            return self._inner(x.theta, new_Nx).replay(gen, t)

    def maybe_exchange(self, smc):
        """Called by the sampler step before each step t >= 1: after a
        resample-move whose acceptance rate fell below
        ``ar_to_increase_Nx``, double Nx (reference
        smc_samplers.py:1099-1108, 1159-1163).  The new filters' likelihoods
        correct the θ log-weights by ``delta = ll_new - ll_old``; logLt
        gains the weighted mean of exp(delta), and ``log_mean_w`` is that
        of the corrected weights, so the next step's increment is measured
        against them.  The acceptance rate is read on the host.

        Under particle sharding the rate is the global mean, so every rank
        takes the same decision; each replays its own θ rows from its own
        generator, and the correction's weights are global."""
        if self.ar_to_increase_Nx <= 0.0 or smc.t == 0 or not smc.rs_flag:
            return
        acc = smc.X.shared.get("acc_rate")
        if acc is None:
            acc = 1.0
        else:
            with tracing.sync("smc2_acc"):
                acc = float(acc)        # the host read
        if acc >= self.ar_to_increase_Nx:
            return
        tracing.count("smc2.exchanges")
        with tracing.span("smc2.exchange", t=smc.t):
            carry = smc._carry
            x = carry.X
            new_Nx = 2 * x.xs.shape[1]
            ctx = distctx.current()
            xs, lws, ll_new = self._replay_all(
                smc.gen if ctx is None else ctx.gen, x, smc.t, new_Nx)
            delta = ll_new - x.loglik
            x = x.replace(xs=xs, lws=lws, loglik=ll_new,
                          lpost=x.lpost + delta)
            new_lw = carry.lw + delta
            new_wgts = rs.Weights(new_lw)
            smc._carry = carry._replace(
                X=x, lw=new_lw,
                logLt=carry.logLt + new_wgts.log_mean - carry.log_mean_w,
                log_mean_w=new_wgts.log_mean)
            smc.X, smc.wgts, smc.logLt = x, new_wgts, smc._carry.logLt
            self.exchanges.append((smc.t, new_Nx))
            if smc.verbose:
                print(f"t={smc.t}: exchange step, Nx -> {new_Nx}")


# ---------------------------------------------------------------------------
# the sampler step
# ---------------------------------------------------------------------------

def _model_gen(gen):
    """The generator of the model's and the moves' draws: ``gen``, or under
    a :mod:`particles_tpu_torch.distctx` context the rank's own."""
    ctx = distctx.current()
    return gen if ctx is None else ctx.gen


def _sampler_step0(fk, gen, N, ESSrmin=None):
    """Step t=0: ``(carry, view)``.  Under a context ``N`` is the rank's
    share of the starting points and the prior draws come from the rank's
    generator."""
    mgen = _model_gen(gen)
    X = fk.M0(mgen, N)
    G, X = fk.logG_and_update(0, X, mgen)
    wgts = rs.Weights(G)
    carry = core._Carry(X=X, lw=wgts.lw, logLt=wgts.log_mean,
                        log_mean_w=wgts.log_mean)
    view = core.StepView(fk=fk, t=0, X=X, Xp=X, A=None, wgts=wgts, aux=wgts,
                         rs_flag=False, logLt=wgts.log_mean,
                         loglt=wgts.log_mean, N=_gN(N), ESSrmin=ESSrmin,
                         gen=mgen)
    return carry, view


def _ring_subset(x, scheme, gen, W, M):
    """The resample of M starting points in all under a context: every
    per-particle leaf of ``x`` served by the ring of ``scheme`` (B2 a hop),
    its shared uniforms from ``gen``, the replicated generator."""
    from particles_tpu_torch.parallel import distributed

    if scheme not in distributed.RING_SCHEMES:
        raise NotImplementedError(
            f"resampling scheme {scheme!r} is not supported for an SMC "
            "sampler under particle sharding (rings exist for "
            f"{', '.join(distributed.RING_SCHEMES)})")
    leaves, unflatten = x._leaves()
    served = distributed.ring_resample(scheme, gen, dict(enumerate(leaves)),
                                       W, M)
    return ThetaParticles(shared=dict(x.shared),
                          **unflatten(list(served.values())))


def _sampler_step(fk, gen, carry, t, N, scheme, ESSrmin, draws=None):
    """One sampler step for t >= 1: (calibrate, resample, move) when it is
    time to resample, then reweight.  Returns ``(carry, view)``.

    X carries N0 particles (N0 = N·P waste-free, else N); the resample
    picks M = N of them by the scheme's z-form over the N0 weights, and
    the move brings them back to N0, with log-weights zero.  The decision
    is read on the host unless ``fk.always_resample``.  The
    log-likelihood increment is ``log_mean`` of the new weights after a
    move, and its difference from the carried ``log_mean`` without one.

    ``draws`` replays given randomness (for tests): ``{"rs_u": u}``, the
    systematic scheme's uniform, and ``{"move": [...]}``, the move's
    draws per chain step.

    Under a :mod:`particles_tpu_torch.distctx` context ``N`` is the rank's
    share of the starting points, N/D: the ring of ``scheme`` (another
    scheme raises ``NotImplementedError``) serves them from the rank's
    N0/D particles, with ``gen``'s shared uniforms; the move and the
    model draw from the rank's generator.
    """
    draws = {} if draws is None else draws
    ctx = distctx.current()
    mgen = _model_gen(gen)
    X, lw = carry.X, carry.lw
    N0 = X.N
    wgts = rs.Weights(lw)
    view = core.StepView(fk=fk, t=t, X=X, Xp=X, A=None, wgts=wgts, aux=wgts,
                         rs_flag=None, logLt=carry.logLt, loglt=None,
                         N=_gN(N), ESSrmin=ESSrmin, gen=mgen)
    if getattr(fk, "always_resample", False):
        rs_flag = True
    else:
        with tracing.sync("decide"):
            rs_flag = bool(fk.time_to_resample(view))   # the step's host sync
    if rs_flag:
        Xc = X.with_shared(**fk.move.calibrate(wgts.W, X))
        if ctx is not None:
            Xres = _ring_subset(Xc, scheme, gen, wgts.W, N * ctx.D)
        elif "rs_u" in draws:
            if scheme != "systematic":
                raise ValueError("draws['rs_u'] replays the systematic "
                                 "scheme's uniform only")
            Xres = Xc.subset_by_z(
                ops.systematic_z_fused(wgts.W, draws["rs_u"], N), N)
        else:
            Xres = Xc.subset_by_z(rs.resampling_z(scheme, gen, wgts.W, N), N)
        X = fk.move(mgen, Xres, fk.move_target(t, Xc),
                    draws=draws.get("move"))
        lw = torch.zeros(N0, dtype=lw.dtype, device=lw.device)
    G, X = fk.logG_and_update(t, X, mgen)
    new_wgts = rs.Weights(lw + G)
    if rs_flag:
        loglt = new_wgts.log_mean
    else:
        loglt = new_wgts.log_mean - carry.log_mean_w
    logLt = carry.logLt + loglt
    view = core.StepView(fk=fk, t=t, X=X, Xp=X, A=None, wgts=new_wgts,
                         aux=wgts, rs_flag=rs_flag, logLt=logLt, loglt=loglt,
                         N=_gN(N), ESSrmin=ESSrmin, gen=mgen)
    carry = core._Carry(X=X, lw=new_wgts.lw, logLt=logLt,
                        log_mean_w=new_wgts.log_mean)
    return carry, view


class SamplerHistory:
    """History of a sampler run: the ThetaParticles system and the Weights
    at each saved time, in plain lists (samplers have no genealogy).

    ``store_history``: ``True`` keeps every step, an int k the last k, a
    callable ``f(t)`` the steps where it is true (reference
    smoothing.py:151-161); ``times`` records which.
    """

    def __init__(self, option=True):
        self._save_if = None
        self.times = []
        if option is True:
            self.X, self.wgts = [], []
        elif (isinstance(option, int) and not isinstance(option, bool)
              and option >= 1):
            self.X = deque([], option)
            self.wgts = deque([], option)
            self.times = deque([], option)
        elif callable(option):
            self.X, self.wgts = [], []
            self._save_if = option
        else:
            raise ValueError(
                f"store_history: invalid option {option!r} for an SMC "
                "sampler (use True, a window length k >= 1, or a callable "
                "t -> bool)")

    @property
    def T(self):
        return len(self.X)

    def save(self, X, wgts):
        self.X.append(X)
        self.wgts.append(wgts)

    def save_step(self, t, X, wgts):
        if self._save_if is None or self._save_if(t):
            self.X.append(X)
            self.wgts.append(wgts)
            self.times.append(t)


def _gather_rows(a, P, ctx):
    """The global (N0, ...) tensor of the ranks' (N0/D, ...) slices ``a``
    in the single-device order: the ranks' blocks joined, each a
    waste-free sampler's (P, M/D) chain-position-major block interleaved
    into (P, M), so that chain m is the same starting point's chain as on
    one device."""
    g = comm.all_gather(a, ctx.group)
    if P == 1:
        return g
    tail = tuple(a.shape[1:])
    return (g.reshape((ctx.D, P, -1) + tail).transpose(0, 1)
            .reshape((-1,) + tail))


def _global_view(view, fk, ctx):
    """The step's view on the global particles and log-weights (one
    all-gather a leaf and one of lw), with ``Weights`` computed on one
    device: what a collector that is not ``dist_safe``, and the history,
    read under sharding.  Evaluate it, and what reads it, under
    ``distctx.local_context()``."""
    P = fk.len_chain if fk.wastefree else 1
    leaves, unflatten = view.X._leaves()
    X = ThetaParticles(shared=dict(view.X.shared), **unflatten(
        [_gather_rows(a, P, ctx) for a in leaves]))
    lw = _gather_rows(view.wgts.lw, P, ctx)
    with distctx.local_context():
        wgts = rs.Weights(lw)
    return view._replace(X=X, Xp=X, wgts=wgts, aux=wgts)


def _needs_global_view(smc):
    """Under a context: whether the history or a collector that is not
    ``dist_safe`` reads the step (then the step's particles are gathered
    once)."""
    cols = [] if smc.summaries is None else smc.summaries._collectors
    return (smc.hist_option not in (False, None)
            or any(not c.dist_safe for c in cols))


def sampler_next(smc):
    """One step of an SMC sampler; ``core.SMC.__next__`` calls it when
    ``fk.is_sampler``.  Collectors run on the step's view afterwards, as
    for a filter (host-side ones among them).

    Under a :mod:`particles_tpu_torch.distctx` context ``smc`` holds the
    rank's slice.  The ``dist_safe`` collectors read the step's global
    reductions; when the history or another collector is asked for, the
    step's particles and log-weights are gathered once, and they and the
    history read the global arrays (in the single-device order) on every
    rank."""
    fk = smc.fk
    ctx = distctx.current()
    if smc.t == 0:
        carry, view = _sampler_step0(fk, smc.gen, smc.N, smc.ESSrmin)
    else:
        if hasattr(fk, "maybe_exchange"):
            fk.maybe_exchange(smc)
        carry, view = _sampler_step(fk, smc.gen, smc._carry, smc.t, smc.N,
                                    smc.resampling, smc.ESSrmin)
    gathered = ctx is not None and _needs_global_view(smc)
    rview = _global_view(view, fk, ctx) if gathered else view
    if smc.summaries is not None:
        with (distctx.local_context() if gathered
              else contextlib.nullcontext()):
            if smc.t == 0:
                smc._col_states, outs = smc.summaries.init_step(rview)
            else:
                smc._col_states, outs = smc.summaries.step(
                    rview, smc._col_states)
        smc.summaries.append_step(outs)
    smc._carry = carry
    smc.X, smc.Xp, smc.A = view.X, view.Xp, view.A
    smc.wgts, smc.aux = view.wgts, view.aux
    smc.rs_flag = view.rs_flag
    smc.logLt, smc.loglt = view.logLt, view.loglt
    if smc.hist_option is not False and smc.hist_option is not None:
        if smc.t == 0:
            smc.hist = SamplerHistory(smc.hist_option)
        smc.hist.save_step(smc.t, rview.X, rview.wgts)
    if smc.verbose:
        print(fk.summary_format(smc))
    smc.t += 1


# ---------------------------------------------------------------------------
# single-run variance estimators for waste-free SMC
# ---------------------------------------------------------------------------

def var_wf(smc, phi):
    """Single-run asymptotic-variance estimate of a waste-free sampler's
    mean of ``phi`` (reference smc_samplers.py:943-1000; Dau & Chopin
    2022): the N0 = M·P particles, in chain-position-major order, are M
    chains of length P.  On the host, in numpy."""
    W = _host(smc.wgts.W)
    N0 = W.shape[0]
    fx = _host(phi(smc.X))
    fmean = np.average(fx, weights=W)
    wphi = W * (fx - fmean)
    wphi_reshaped = np.reshape(wphi, (-1, smc.N))
    return variance_mcmc.MCMC_variance(wphi_reshaped, "init_seq") * N0 ** 2


class _VarView:
    """What :func:`var_wf` reads of a step's view."""

    def __init__(self, view):
        self.wgts, self.X, self.N = view.wgts, view.X, view.N


class Var_phi(col.Collector):
    """Waste-free single-run variance estimates of the mean of ``phi``
    (reference smc_samplers.py:985-997).  Host-side: reads the step's
    weights and particles on the host."""

    summary_name = "var_phi"
    signature = {"phi": None}
    host_side = True
    uses_genealogy = False

    def collect(self, view):
        return var_wf(_VarView(view), self.phi)


class Var_logLt(col.Collector):
    """Waste-free single-run variance estimate of log L_t (reference
    smc_samplers.py:1000-1036).  Host-side and stateful."""

    summary_name = "var_logLt"
    stateful = True
    host_side = True
    uses_genealogy = False

    def _var_logw(self, view):
        lw = np.reshape(_host(view.wgts.lw), (-1, view.N))
        w = np.exp(lw - lw.max())
        var_w = variance_mcmc.MCMC_variance(w, "init_seq")
        return var_w / np.mean(w) ** 2

    def init(self, view):
        var_logw = self._var_logw(view)
        return (0.0, var_logw), var_logw

    def step(self, view, state):
        var_prev, var_logw = state
        if bool(view.rs_flag):
            var_prev = var_prev + var_logw
        var_logw = self._var_logw(view)
        return (var_prev, var_logw), var_logw + var_prev
