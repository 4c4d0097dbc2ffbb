"""Feynman-Kac models and the SMC engine (PyTorch port).

Counterpart of ``particles_tpu/core.py``: :class:`FeynmanKac`, the step
logic of ``_step0``/``_step``, the :class:`SMC` class with ``run()`` and
the iterator protocol, and ``multiSMC``.  Where the JAX package compiles
the time loop into one ``lax.scan`` and picks the resampling branch with
``lax.cond``, this engine is an eager Python loop that decides on the
host: each step syncs once, on ``bool(ESS < N * ESSrmin)``, and then runs
only the branch it needs.  Every resampling scheme of the JAX package is
ported; the sorted ones serve the particles by their z-form through the
CUDA kernels of :mod:`particles_tpu_torch.ops` on the card (their plain
versions on the CPU), the others (``killing``, ``idiotic``) gather by
their ancestors.

Ported: every resampling scheme, adaptive (ESS) or custom
``time_to_resample``, the guided and auxiliary particle filters (an
auxiliary filter resamples on the auxiliary weights, lw + logeta, and
resets the weights from ``logeta`` recomputed on the served particles),
SQMC (``qmc=True``, :func:`SQMC`; :func:`_step_qmc`), stateless and
stateful collectors, the particle history (``store_history``),
``multiSMC`` (one run after another), the SMC samplers: a
Feynman-Kac model with ``is_sampler`` (``smc_samplers.IBIS``,
``Tempering``, ``AdaptiveTempering``, ``SMC2``) runs through
:func:`particles_tpu_torch.smc_samplers.sampler_next`, with its own
history (``smc_samplers.SamplerHistory``), and checkpoint and resume
(:meth:`SMC.save_state`, :meth:`SMC.load_state`).
"""

from __future__ import annotations

from collections import deque
from typing import Any, NamedTuple

import numpy as np
import torch

from particles_tpu_torch import collectors
from particles_tpu_torch import distctx
from particles_tpu_torch import hilbert
from particles_tpu_torch import ops
from particles_tpu_torch import resampling as rs
from particles_tpu_torch import rqmc
from particles_tpu_torch import smoothing
from particles_tpu_torch import tracing
from particles_tpu_torch import utils

__all__ = ["FeynmanKac", "SMC", "SQMC", "SMCResult", "StepView", "multiSMC"]


class FeynmanKac:
    """Abstract Feynman-Kac model.

    Necessary methods: ``M0(gen, N)`` samples N initial particles,
    ``M(gen, t, xp)`` samples X_t given ancestors ``xp`` (t >= 1), and
    ``logG(t, xp, x)`` is the log potential (called with ``xp=None`` at
    t=0).  ``gen`` is the run's ``torch.Generator``.  Particles are a
    tensor with leading dimension N, or a dict of such tensors.
    """

    T = 0
    du = 0

    def M0(self, gen, N):
        raise NotImplementedError(self._error_msg("M0"))

    def M(self, gen, t, xp):
        raise NotImplementedError(self._error_msg("M"))

    def logG(self, t, xp, x):
        raise NotImplementedError(self._error_msg("logG"))

    def Gamma0(self, u):
        raise NotImplementedError(self._error_msg("Gamma0"))

    def Gamma(self, t, xp, u):
        raise NotImplementedError(self._error_msg("Gamma"))

    def logpt(self, t, xp, x):
        raise NotImplementedError(self._error_msg("logpt"))

    def _error_msg(self, method):
        return (f"method/property {method} missing in class "
                f"{self.__class__.__name__}")

    @property
    def isAPF(self):
        """True if the model defines an auxiliary function ``logeta``."""
        return callable(getattr(self, "logeta", None))

    def done(self, smc):
        """Time to stop?"""
        return smc.t >= self.T

    def time_to_resample(self, smc):
        """Resample or not (a bool or a one-element tensor)."""
        return smc.aux.ESS < smc.N * smc.ESSrmin

    def default_moments(self, W, X):
        if isinstance(X, dict):
            return rs.wmean_and_var_str_array(W, X)
        return rs.wmean_and_var(W, X)

    def summary_format(self, smc):
        """The line ``SMC(verbose=True)`` prints after each step; reading
        the ESS as a number syncs with the device."""
        return (f"t={smc.t}: resample={smc.rs_flag}, "
                f"ESS (end of iter)={float(smc.wgts.ESS)}")


class StepView(NamedTuple):
    """What collectors and ``time_to_resample`` see at each step.

    ``A`` (ancestor indices, int64) is filled only when the history is
    stored or a collector reads the genealogy; otherwise it is None.
    ``rs_flag`` is a Python bool.  ``gen`` is the run's generator (the
    JAX view carries a key); a collector that draws takes a generator of
    its own, so that the filter's particles do not depend on it.
    """

    fk: Any
    t: int
    X: Any
    Xp: Any
    A: Any
    wgts: Any
    aux: Any
    rs_flag: Any
    logLt: Any
    loglt: Any
    N: int
    ESSrmin: float
    gen: Any = None

    @property
    def W(self):
        return self.wgts.W


class _Carry(NamedTuple):
    """The state one step hands to the next, with the stateful collectors'
    states and ``wgts``, the :class:`resampling.Weights` of ``lw`` (None:
    the next step computes them)."""

    X: Any
    lw: Any
    logLt: Any
    log_mean_w: Any
    col_states: Any = ()
    wgts: Any = None


def _serve(X, z, N, want_anc):
    """Resampling move of every leaf of ``X`` (a tensor or a dict of
    tensors), all in one kernel launch; the ancestors ride it when asked."""
    if isinstance(X, dict):
        keys = list(X)
        served, A = ops.repeat_cols(
            z, N, [X[k].contiguous() for k in keys], want_anc)
        return dict(zip(keys, served)), A
    (Xp,), A = ops.repeat_cols(z, N, [X.contiguous()], want_anc)
    return Xp, A


def _gather(X, A):
    """Select ancestors ``A`` of every leaf of ``X`` (a tensor or a dict of
    tensors)."""
    if isinstance(X, dict):
        return {k: v.index_select(0, A) for k, v in X.items()}
    return X.index_select(0, A)


def _qmc_reorder(X, extras):
    """Particles ``X`` ((N,) or (N, d)) and the (N, ...) tensors ``extras``
    in the Hilbert order of X, by one stable sort of its key."""
    X_s, *rest = hilbert.hilbert_sort_with(X, (X,) + tuple(extras))
    return X_s, tuple(rest)


def _dist_qmc_count(N, ctx):
    """The global particle count of SQMC under the context ``ctx``: the
    sharded sorted Sobol set is in closed form only at a power of two, so
    another count raises ``NotImplementedError``, as in the JAX
    package."""
    Ng = N * ctx.D
    if Ng & (Ng - 1):
        raise NotImplementedError(
            "SQMC under particle sharding needs the global particle count "
            f"to be a power of two (got N={Ng}): the sharded sorted Sobol "
            "set is in closed form only at 2^m")
    return Ng


def _reorder(X, extras):
    """:func:`_qmc_reorder`, or under a context the global Hilbert order
    (:func:`parallel.dqmc.dist_qmc_reorder`)."""
    ctx = distctx.current()
    if ctx is None:
        return _qmc_reorder(X, extras)
    from particles_tpu_torch.parallel import dqmc

    return dqmc.dist_qmc_reorder(X, extras, ctx.group)


def _model(f, *args):
    """``f(*args)``, a call into the user's model, inside the span
    ``particles.model``."""
    with tracing.span("model"):
        return f(*args)


def _step0(fk, gen, N, ESSrmin, summaries, need_gen, qmc=False):
    """Step t=0.  Under ``qmc`` the particles are ``Gamma0`` of scrambled
    Sobol points, and the carry holds them in Hilbert order.

    Under a :mod:`particles_tpu_torch.distctx` context ``N`` is the rank's
    slice: the model draws from the rank's generator, the ancestors are
    global and the view's ``N`` is the global count.  Under ``qmc`` the
    rank takes its rows of one global Sobol set drawn from ``gen`` (the
    replicated generator), and the particles go to the global Hilbert
    order."""
    ctx = distctx.current()
    if qmc:
        du = max(fk.du, 1)
        if ctx is None:
            u = rqmc.sobol(gen, N, du)
        else:
            u = rqmc.sobol(gen, _dist_qmc_count(N, ctx), du,
                           start=ctx.rank * N, count=N)
        # every later step draws du + 1 columns: their direction numbers
        # go to the device now, since a copy from the host synchronises
        rqmc.load_directions(du + 1, u.device)
    with tracing.span("model"):
        if qmc:
            X = fk.Gamma0(u if du > 1 else u[:, 0])
        else:
            X = fk.M0(gen if ctx is None else ctx.gen, N)
        lw = fk.logG(0, None, X)
    if qmc:
        X, (lw,) = _reorder(X, (lw,))
    wgts = rs.Weights(lw)
    logLt = wgts.log_mean
    A = _identity_ancestors(N, lw.device) if need_gen else None
    view = StepView(fk=fk, t=0, X=X, Xp=X, A=A, wgts=wgts, aux=wgts,
                    rs_flag=False, logLt=logLt, loglt=logLt,
                    N=N if ctx is None else N * ctx.D, ESSrmin=ESSrmin,
                    gen=gen if ctx is None else ctx.gen)
    states, outs = ((), ()) if summaries is None else summaries.init_step(view)
    carry = _Carry(X=X, lw=lw, logLt=logLt, log_mean_w=wgts.log_mean,
                   col_states=states, wgts=wgts)
    return carry, view, outs


def _identity_ancestors(N, device):
    """``arange(N)``, or under a context the rank's slice of the global
    identity, ``rank * N + arange(N)``."""
    ctx = distctx.current()
    A = torch.arange(N, device=device)
    return A if ctx is None else A + ctx.rank * N


def _step(fk, gen, carry, t, N, scheme, ESSrmin, summaries, need_gen):
    """One step for t >= 1.

    An auxiliary filter (``fk.isAPF``) first adds ``logeta(t - 1, X)`` to
    the weights: the decision and the resampling read these auxiliary
    weights.  The decision is taken on the host (one sync); a resampling
    step serves the particles by the scheme's z-form (sorted-ancestor
    schemes, through B2) or gathers them by its ancestors (``killing``,
    ``idiotic``), and resets the log-weights: to zero, or for an auxiliary
    filter to ``log_mean_exp(logeta, lw) - logeta(t - 1, Xp)`` with logeta
    recomputed on the served particles (no gather of the column).  No
    scheme reads a device value on the host, except the sequential SSP at
    N < ``resampling._SSP_BLOCKED_MIN``.  The log-likelihood increment is
    ``log_mean`` of the new weights after resampling, and otherwise its
    difference from the carried ``log_mean``.

    Under a :mod:`particles_tpu_torch.distctx` context ``N`` is the rank's
    slice and the same code runs on every rank: the weights' reductions
    are global (two all-reduces a step, and two more for an auxiliary
    filter's auxiliary weights), the decision reads the global ESS (the
    same on every rank, so every rank takes the same branch), a
    resampling step is the ring of the scheme
    (:func:`parallel.distributed.ring_resample`; ``systematic``,
    ``stratified`` or ``multinomial``, others raise), ancestors are
    global, the model draws from the rank's generator, and ``gen`` (the
    same on every rank) draws only the resampling's shared uniforms.  An
    auxiliary filter's reset weights reuse the sums of the auxiliary and
    plain weights (``log_mean_exp(logeta, lw)`` is ``aux.log_mean -
    wgts.log_mean``, on one device too), so they add no collective.
    """
    ctx = distctx.current()
    X, lw = carry.X, carry.lw
    wgts = carry.wgts if carry.wgts is not None else rs.Weights(lw)
    if fk.isAPF:
        logetat = _model(fk.logeta, t - 1, X)
        aux = wgts.add(logetat)
    else:
        logetat, aux = None, wgts
    Ng = N if ctx is None else N * ctx.D
    pre_view = StepView(fk=fk, t=t, X=X, Xp=X, A=None, wgts=wgts, aux=aux,
                        rs_flag=None, logLt=carry.logLt, loglt=None, N=Ng,
                        ESSrmin=ESSrmin, gen=gen)
    with tracing.sync("decide"):
        rs_flag = bool(fk.time_to_resample(pre_view))   # the step's host sync
    if rs_flag:
        if ctx is not None:
            from particles_tpu_torch.parallel import distributed

            out = distributed.ring_resample(scheme, gen, X, aux.W, Ng,
                                            return_ancestors=need_gen)
            Xp, A = out if need_gen else (out, None)
        elif scheme in rs.rs_counts_funcs:
            z = rs.resampling_z(scheme, gen, aux.W, M=N)
            Xp, A = _serve(X, z, N, need_gen)
        else:
            A = rs.resampling(scheme, gen, aux.W, M=N)
            Xp = _gather(X, A)
        if logetat is None:
            lw = torch.zeros_like(lw)
        else:
            lw = (aux.log_mean - wgts.log_mean
                  - _model(fk.logeta, t - 1, Xp))
    else:
        Xp = X
        A = _identity_ancestors(N, lw.device) if need_gen else None
    X_new = _model(fk.M, gen if ctx is None else ctx.gen, t, Xp)
    lw_new = lw + _model(fk.logG, t, Xp, X_new)
    new_wgts = rs.Weights(lw_new)
    if rs_flag:
        loglt = new_wgts.log_mean
    else:
        loglt = new_wgts.log_mean - carry.log_mean_w
    logLt = carry.logLt + loglt
    view = StepView(fk=fk, t=t, X=X_new, Xp=Xp, A=A, wgts=new_wgts,
                    aux=aux, rs_flag=rs_flag, logLt=logLt, loglt=loglt,
                    N=Ng, ESSrmin=ESSrmin,
                    gen=gen if ctx is None else ctx.gen)
    states, outs = ((), ()) if summaries is None else summaries.step(
        view, carry.col_states)
    carry = _Carry(X=X_new, lw=lw_new, logLt=logLt,
                   log_mean_w=new_wgts.log_mean, col_states=states,
                   wgts=new_wgts)
    return carry, view, outs


def _step_qmc(fk, gen, carry, t, N, ESSrmin, summaries, need_gen,
              points=None):
    """One SQMC step for t >= 1: it always resamples, with one scrambled
    Sobol set of du + 1 columns sorted by the first (``points``, (N, du +
    1), when given; else drawn from ``gen``, in closed form at N = 2^m <=
    2^24).  The carry holds the particles in Hilbert order, so the sorted
    first column serves them by the inverse CDF of the (auxiliary) weights
    (B3 builds the CDF, B4 serves X and the ancestors in one launch), and
    the other columns go through ``fk.Gamma``.  One stable sort by the new
    particles' Hilbert key carries lw, the ancestors and Xp: the ancestors
    index the previous Hilbert-ordered generation, so the genealogy stays
    exact.  No device value is read on the host.

    Under a :mod:`particles_tpu_torch.distctx` context (distributed SQMC)
    the same recursion runs on every rank's slice: the global count must
    be a power of two; the rank takes its rows ``[rank N, (rank + 1) N)``
    of one globally sorted Sobol set drawn from ``gen`` (replicated);
    the merge ring serves them
    (:func:`parallel.dqmc.ring_merge_resample`: B6, then B5 and B2 a hop),
    with global ancestors; an auxiliary filter's reset weights are
    recomputed from the served particles; and the sort is the global
    Hilbert sort (:func:`parallel.dqmc.dist_qmc_reorder`).  The model's
    draws (none: ``Gamma`` is deterministic) would come from the rank's
    generator."""
    ctx = distctx.current()
    X, lw = carry.X, carry.lw
    wgts = rs.Weights(lw)
    if fk.isAPF:
        logetat = _model(fk.logeta, t - 1, X)
        aux = wgts.add(logetat)
    else:
        logetat, aux = None, wgts
    du = max(fk.du, 1)
    if points is None and ctx is not None:
        points = rqmc.sobol_sorted0(gen, _dist_qmc_count(N, ctx), du + 1,
                                    start=ctx.rank * N, count=N)
    elif points is None:
        if N & (N - 1) == 0 and N <= 1 << 24:
            points = rqmc.sobol_sorted0(gen, N, du + 1)
        else:
            u = rqmc.sobol(gen, N, du + 1)
            points = u.index_select(
                0, torch.sort(u[:, 0], stable=True).indices)
    su = points[:, 0].contiguous()
    if ctx is None:
        (Xp,), A = ops.repeat_cols_su(su, rs.pinned_cdf(aux.W), N,
                                      [X.contiguous()], want_anc=need_gen)
    else:
        from particles_tpu_torch.parallel import dqmc

        out = dqmc.ring_merge_resample(X, su, aux.W, ctx.group,
                                       return_ancestors=need_gen)
        Xp, A = out if need_gen else (out, None)
    if logetat is None:
        lw_reset = torch.zeros_like(lw)
    else:
        lw_reset = (rs.log_mean_exp(logetat, lw=wgts.lw)
                    - _model(fk.logeta, t - 1, Xp))
    v = points[:, 1] if du == 1 else points[:, 1:]
    X_new = _model(fk.Gamma, t, Xp, v)
    lw_new = lw_reset + _model(fk.logG, t, Xp, X_new)
    if need_gen:
        X_h, (lw_h, A_s, Xp_h) = _reorder(X_new, (lw_new, A, Xp))
    else:
        X_h, (lw_h,) = _reorder(X_new, (lw_new,))
        A_s = Xp_h = None
    h_wgts = rs.Weights(lw_h)
    loglt = h_wgts.log_mean
    logLt = carry.logLt + loglt
    view = StepView(fk=fk, t=t, X=X_h, Xp=Xp_h, A=A_s, wgts=h_wgts, aux=aux,
                    rs_flag=True, logLt=logLt, loglt=loglt,
                    N=N if ctx is None else N * ctx.D, ESSrmin=ESSrmin,
                    gen=gen if ctx is None else ctx.gen)
    states, outs = ((), ()) if summaries is None else summaries.step(
        view, carry.col_states)
    carry = _Carry(X=X_h, lw=lw_h, logLt=logLt, log_mean_w=h_wgts.log_mean,
                   col_states=states)
    return carry, view, outs


# ---------------------------------------------------------------------------
# checkpoint: the run's objects as what torch.load(weights_only=True) reads
# ---------------------------------------------------------------------------

_TAG = "__particles_tpu_torch__"


def _pack(obj):
    """``obj`` as tensors, lists, tuples, dicts and numbers only: a
    ``ThetaParticles``, a ``Weights``, a generator or a numpy value becomes
    a dict tagged by ``_TAG``; anything else raises ``TypeError``."""
    from particles_tpu_torch import smc_samplers

    if obj is None or isinstance(obj, (bool, int, float, str,
                                       torch.Tensor)):
        return obj
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return {_TAG: "ndarray", "v": torch.from_numpy(obj.copy())}
    if isinstance(obj, rs.Weights):
        return {_TAG: "Weights", "lw": obj.lw}
    if isinstance(obj, smc_samplers.ThetaParticles):
        return {_TAG: "ThetaParticles", "shared": _pack(obj.shared),
                "fields": _pack(obj._particle_fields())}
    if isinstance(obj, torch.Generator):
        return {_TAG: "Generator", "device": obj.device.type,
                "state": obj.get_state()}
    if isinstance(obj, (list, deque)):
        return [_pack(v) for v in obj]
    if type(obj) is tuple:
        return tuple(_pack(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    raise TypeError(f"save_state: cannot store a {type(obj).__name__}")


def _unpack(obj, device):
    """The inverse of :func:`_pack`; generators are rebuilt on
    ``device``."""
    from particles_tpu_torch import smc_samplers

    if isinstance(obj, list):
        return [_unpack(v, device) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, device) for v in obj)
    if not isinstance(obj, dict):
        return obj
    tag = obj.get(_TAG)
    if tag is None:
        return {k: _unpack(v, device) for k, v in obj.items()}
    if tag == "ndarray":
        return obj["v"].cpu().numpy()
    if tag == "Weights":
        return rs.Weights(obj["lw"])
    if tag == "ThetaParticles":
        return smc_samplers.ThetaParticles(
            shared=_unpack(obj["shared"], device),
            **_unpack(obj["fields"], device))
    if tag == "Generator":
        gen = torch.Generator(device=obj["device"] if obj["device"] == "cpu"
                              else device)
        gen.set_state(obj["state"].cpu())
        return gen
    raise ValueError(f"load_state: unknown entry {tag!r}")


def _hist_kind(smc):
    """What the run's history is: None, ``full``, ``rolling``, ``partial``
    or ``sampler``."""
    if smc.is_sampler:
        return (None if smc.hist_option is False or smc.hist_option is None
                else "sampler")
    h = smc._hist_obj
    if h is None:
        return None
    if isinstance(h, smoothing.RollingParticleHistory):
        return "rolling"
    if isinstance(h, smoothing.PartialParticleHistory):
        return "partial"
    return "full"


def _dump_hist(smc, kind):
    if kind == "full":
        return [list(f) for f in smc._hist_obj.frames]
    if kind == "rolling":
        h = smc._hist_obj
        return {"X": list(h.X), "A": list(h.A), "wgts": list(h.wgts)}
    if kind == "partial":
        h = smc._hist_obj
        return {"times": list(h.X), "X": list(h.X.values()),
                "wgts": list(h.wgts.values())}
    if kind == "sampler":
        h = smc.hist
        return {"X": list(h.X), "wgts": list(h.wgts),
                "times": [int(t) for t in h.times]}
    return None


def _load_hist(smc, kind, dumped):
    if kind == "full":
        smc._hist_obj.frames = [tuple(f) for f in dumped]
    elif kind == "rolling":
        h = smc._hist_obj
        for q in (h.X, h.A, h.wgts):
            q.clear()
        h.X.extend(dumped["X"])
        h.A.extend(dumped["A"])
        h.wgts.extend(dumped["wgts"])
        smc.hist = h
    elif kind == "partial":
        h = smc._hist_obj
        h.X = dict(zip(dumped["times"], dumped["X"]))
        h.wgts = dict(zip(dumped["times"], dumped["wgts"]))
        smc.hist = h
    elif kind == "sampler":
        from particles_tpu_torch.smc_samplers import SamplerHistory

        # rebuilt with the live option, so that a window keeps rolling
        h = SamplerHistory(smc.hist_option)
        for X, w, t in zip(dumped["X"], dumped["wgts"], dumped["times"]):
            h.X.append(X)
            h.wgts.append(w)
            h.times.append(t)
        smc.hist = h


class SMC:
    """A particle filter or SMC algorithm::

        pf = SMC(fk=ssms.Bootstrap(ssm=model, data=y), N=1000)
        pf.run()
        pf.logLt, pf.summaries.ESSs, pf.X, pf.W

    plus the iterator protocol (``next(pf)`` advances one step; ``run()``
    continues from there).  ``resampling`` names a scheme of
    ``resampling.rs_funcs``.  ``device`` defaults to the device of
    ``fk.data`` when that is a tensor, else of ``generator`` when one is
    given, else the current CUDA card; with no card, pass
    ``device="cpu"``.  Every draw comes from one ``torch.Generator`` on
    that device, seeded by ``seed`` unless ``generator`` is given.

    ``verbose=True`` prints ``str(self)`` (``fk.summary_format``) after
    each step, which reads the ESS on the host: one more sync a step.

    ``store_history``: ``False``; ``True``, and after the run ``pf.hist``
    is a :class:`smoothing.ParticleHistory` of the stacked frames ``X``
    (T, N, ...), ``A`` (T, N) int64 and ``lw`` (T, N); an int k, the last k
    frames (:class:`smoothing.RollingParticleHistory`); or a callable
    ``t -> bool``, the frames at those times
    (:class:`smoothing.PartialParticleHistory`).  Frames stay on the device
    and add no host sync.

    ``save_state(path)`` after a step and ``load_state(path)`` into a new
    ``SMC`` built with the same model and options resume the run: the
    steps that follow are the ones the run would have taken.

    ``qmc=True`` runs SQMC (:func:`_step_qmc`): every step resamples, by
    scrambled Sobol points, with no host sync; ``resampling`` and
    ``ESSrmin`` are not read.  The particles are kept in Hilbert order,
    and the history says so (``hilbert_ordered``, which QMC FFBS needs).

    A sampler (``fk.is_sampler``) steps by
    :func:`smc_samplers.sampler_next`: ``N`` is the number of starting
    points a resample picks (a waste-free sampler carries N·len_chain
    particles), ``resampling`` must be a counts-based scheme
    (``resampling.rs_counts_funcs``), the device defaults to that of
    ``fk.model.data``, and ``store_history`` fills a
    :class:`smc_samplers.SamplerHistory`.
    """

    def __init__(self, fk=None, N=100, seed=0, generator=None, device=None,
                 resampling="systematic", ESSrmin=0.5, collect=None,
                 qmc=False, store_history=False, verbose=False):
        if resampling not in rs.rs_funcs:
            raise ValueError(f"{resampling} is not a valid resampling scheme")
        self.is_sampler = getattr(fk, "is_sampler", False)
        if self.is_sampler and resampling not in rs.rs_counts_funcs:
            raise ValueError(f"{resampling} has no counts-based (sorted) "
                             "form: an SMC sampler takes "
                             f"{sorted(rs.rs_counts_funcs)}")
        if device is None:
            data = getattr(fk, "data", None)
            if self.is_sampler:
                data = getattr(getattr(fk, "model", None), "data", None)
            if isinstance(data, (tuple, list)) and data:
                data = data[0]      # a regression's (x, y)
            if isinstance(data, torch.Tensor):
                device = data.device
            elif generator is not None:
                device = generator.device
        self.device = utils.resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        elif utils.resolve_device(generator.device) != self.device:
            raise ValueError(f"generator on {generator.device}, run on "
                             f"{self.device}")
        self.gen = generator
        self.fk = fk
        self.N = N
        self.qmc = qmc
        self.resampling = resampling
        self.ESSrmin = ESSrmin
        self.verbose = verbose
        self.summaries = (None if collect == "off"
                          else collectors.Summaries(collect))
        # a sampler keeps its own history (smc_samplers.SamplerHistory)
        self.hist_option = store_history
        self._hist_obj = (None if self.is_sampler else
                          smoothing.generate_hist_obj(store_history,
                                                      hilbert_ordered=qmc))
        self.hist = None
        self._finalize_history()

        self.t = 0
        self.rs_flag = False
        self.logLt = 0.0
        self.wgts = rs.Weights()
        self.aux = None
        self.X, self.Xp, self.A = None, None, None
        self.loglt = None
        self._carry = None

    def __str__(self):
        return self.fk.summary_format(self)

    @property
    def W(self):
        return self.wgts.W

    @property
    def _need_gen(self):
        return (self._hist_obj is not None
                or (self.summaries is not None
                    and self.summaries.needs_genealogy))

    def _install_view(self, view, carry):
        self._carry = carry
        self.X, self.Xp, self.A = view.X, view.Xp, view.A
        self.wgts, self.aux = view.wgts, view.aux
        self.rs_flag = view.rs_flag
        self.logLt, self.loglt = view.logLt, view.loglt
        if self._hist_obj is not None:
            self._hist_obj.save(self)

    def _finalize_history(self):
        if self._hist_obj is not None:
            self.hist = self._hist_obj.finalize(self.fk)

    def __next__(self):
        with tracing.span("step", t=self.t):
            if self.fk.done(self):
                if self.summaries is not None:
                    self.summaries.finalize_lists()
                self._finalize_history()
                raise StopIteration
            if self.is_sampler:
                from particles_tpu_torch import smc_samplers

                smc_samplers.sampler_next(self)
                return
            if self.t == 0:
                carry, view, outs = _step0(self.fk, self.gen, self.N,
                                           self.ESSrmin, self.summaries,
                                           self._need_gen, qmc=self.qmc)
            elif self.qmc:
                carry, view, outs = _step_qmc(
                    self.fk, self.gen, self._carry, self.t, self.N,
                    self.ESSrmin, self.summaries, self._need_gen)
            else:
                carry, view, outs = _step(
                    self.fk, self.gen, self._carry, self.t, self.N,
                    self.resampling, self.ESSrmin, self.summaries,
                    self._need_gen)
            self._install_view(view, carry)
            if self.summaries is not None:
                self.summaries.append_step(outs)
            if self.verbose:
                print(self)
            self.t += 1

    def next(self):
        return self.__next__()

    def __iter__(self):
        return self

    # ------------------------------------------------------------------
    # checkpoint and resume
    # ------------------------------------------------------------------

    def save_state(self, path):
        """Checkpoint the run after its last step to ``path`` (with
        ``torch.save``): t, the carry, the generator's state, the history,
        the collectors' records and states.  Only tensors, lists, tuples,
        dicts and numbers are stored, so :meth:`load_state` reads it with
        ``weights_only=True``.  Before the first step it raises
        ``ValueError``."""
        if self._carry is None:
            raise ValueError("save_state: nothing to save (run a step "
                             "first)")
        kind = _hist_kind(self)
        state = {
            "t": self.t,
            "carry": _pack(self._carry._asdict()),
            "rs_flag": bool(self.rs_flag),
            "generator": {"device": self.gen.device.type,
                          "state": self.gen.get_state()},
            "hist_kind": kind,
            "hist": _pack(_dump_hist(self, kind)),
            "col_states": _pack(getattr(self, "_col_states", None)),
            "summaries": None,
        }
        if self.summaries is not None:
            state["summaries"] = {
                c.summary_name: {
                    "record": _pack(getattr(self.summaries, c.summary_name)),
                    "attrs": _pack({k: v for k, v in vars(c).items()
                                    if k not in c.signature})}
                for c in self.summaries._collectors}
        torch.save(state, path)

    def load_state(self, path):
        """Restore a checkpoint of :meth:`save_state` into this object,
        built with the same model and options (its own seed does not
        matter: the generator's state is restored), and continue with
        ``next(pf)`` or ``pf.run()``.  A checkpoint whose history kind or
        generator device differs from this object's raises
        ``ValueError``."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        kind = _hist_kind(self)
        if state["hist_kind"] != kind:
            raise ValueError(
                f"load_state: the checkpoint holds a {state['hist_kind']} "
                f"history, this SMC a {kind} one (store_history="
                f"{self.hist_option!r})")
        gstate = state["generator"]
        if gstate["device"] != self.gen.device.type:
            raise ValueError(
                f"load_state: the checkpoint's generator ran on "
                f"{gstate['device']}, this run's is on "
                f"{self.gen.device.type}: its stream would differ")
        self.gen.set_state(gstate["state"].cpu())
        carry = _Carry(**_unpack(state["carry"], self.device))
        self._carry = carry
        self.t = state["t"]
        self.X = self.Xp = carry.X
        self.wgts = rs.Weights(carry.lw)
        self.logLt = carry.logLt
        self.rs_flag = state["rs_flag"]
        self.A = self.aux = self.loglt = None
        _load_hist(self, kind, _unpack(state["hist"], self.device))
        col_states = _unpack(state["col_states"], self.device)
        if col_states is not None:
            self._col_states = col_states
        if state["summaries"] is not None and self.summaries is not None:
            for c in self.summaries._collectors:
                saved = state["summaries"][c.summary_name]
                setattr(self.summaries, c.summary_name,
                        _unpack(saved["record"], self.device))
                for k, v in _unpack(saved["attrs"], self.device).items():
                    setattr(c, k, v)
        if self.qmc:
            # the directions the steps draw with, on the device now, as
            # _step0 puts them (a later copy from the host would sync)
            rqmc.load_directions(max(self.fk.du, 1) + 1, self.device)

    @utils.timer
    def run(self):
        """Run the algorithm to completion, continuing from the current
        step."""
        for _ in self:
            pass


def SQMC(*args, **kwargs):
    """Sequential quasi-Monte Carlo: an :class:`SMC` with ``qmc=True``."""
    kwargs["qmc"] = True
    return SMC(*args, **kwargs)


class SMCResult:
    """Light-weight result of one run inside :func:`multiSMC`: ``logLt``,
    the final log-weights ``lw`` (and ``wgts``, ``W`` from them), each
    collector's record as an attribute (``summaries`` is the result
    itself, so ``res.summaries.ESSs`` reads as for an SMC), ``cpu_time``,
    the run's wall time, ``hist``, the run's history (None unless
    ``store_history`` was given), and ``X``, the final particles where the
    caller keeps them (:func:`parallel.run_shardmap_smc`)."""

    def __init__(self, logLt, summaries_dict, lw=None, cpu_time=None,
                 hist=None, X=None):
        self.logLt = logLt
        self.lw = lw
        self.X = X
        self.cpu_time = cpu_time
        self.hist = hist
        for name, val in summaries_dict.items():
            setattr(self, name, val)
        self.summaries = self

    @property
    def wgts(self):
        return rs.Weights(self.lw) if self.lw is not None else None

    @property
    def W(self):
        return None if self.lw is None else rs.exp_and_normalise(self.lw)


def multiSMC(fk=None, N=100, qmc=False, resampling="systematic", ESSrmin=0.5,
             nruns=10, nprocs=0, collect=None, seed=0, out_func=None, **args):
    """Run many independent SMC algorithms: ``nruns`` replicates, crossed
    with the cartesian product of every keyword argument given as a list
    (``resampling=['multinomial', 'systematic']``) or as a dict of name ->
    value (``fk={'boot': fk_b, 'other': fk_o}``).  Any other :class:`SMC`
    option (``device``, ``verbose``, ...) passes through.

    Returns a list of dicts holding the varying options (a dict's names),
    ``'run'`` and ``'output'``: an :class:`SMCResult`, or what
    ``out_func`` makes of it.  Run ``r`` of every combination draws from
    its own generator, seeded from ``seed`` and ``r`` alone, so the
    combinations share their random streams as in the JAX package.  This
    port runs one :class:`SMC` after another; ``nprocs`` is accepted and
    ignored.
    """
    del nprocs
    base_args = dict(fk=fk, N=N, qmc=qmc, resampling=resampling,
                     ESSrmin=ESSrmin, **args)
    varying = [k for k, v in base_args.items() if isinstance(v, (list, dict))]
    labels_list, values_list = utils.cartesian_args(base_args)
    seeder = torch.Generator().manual_seed(seed)
    run_seeds = torch.randint(0, 2**62, (nruns,), generator=seeder).tolist()
    results = []
    for labels, values in zip(labels_list, values_list):
        for r, run_seed in enumerate(run_seeds):
            pf = SMC(collect=collect, seed=run_seed, **values)
            pf.run()
            sm = ({} if pf.summaries is None else
                  {c.summary_name: getattr(pf.summaries, c.summary_name)
                   for c in pf.summaries._collectors})
            res = SMCResult(pf.logLt, sm, lw=pf.wgts.lw,
                            cpu_time=pf.cpu_time, hist=pf.hist)
            entry = {k: labels[k] for k in varying}
            entry["run"] = r
            entry["output"] = res if out_func is None else out_func(res)
            results.append(entry)
    return results
