"""Feynman-Kac models and the SMC engine (PyTorch port, first slice).

Counterpart of ``particles_tpu/core.py``: :class:`FeynmanKac`, the step
logic of ``_step0``/``_step`` and the :class:`SMC` class with ``run()``
and the iterator protocol.  Where the JAX package compiles the time loop
into one ``lax.scan`` and picks the resampling branch with ``lax.cond``,
this engine is an eager Python loop that decides on the host: each step
syncs once, on ``bool(ESS < N * ESSrmin)``, and then runs only the branch
it needs.  Systematic resampling goes through the two CUDA kernels of
:mod:`particles_tpu_torch.ops` on the card (their plain versions on the
CPU).

Ported: systematic resampling, adaptive (ESS) or custom
``time_to_resample``, stateless collectors.  Not yet: the other schemes,
SQMC, history, auxiliary filters, samplers and ``multiSMC`` (ROADMAP
queue A); asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from particles_tpu_torch import collectors
from particles_tpu_torch import ops
from particles_tpu_torch import resampling as rs
from particles_tpu_torch import utils

__all__ = ["FeynmanKac", "SMC", "StepView"]


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
        return rs.wmean_and_var(W, X)

    def summary_format(self, smc):
        return (f"t={smc.t}: resample={smc.rs_flag}, "
                f"ESS (end of iter)={smc.wgts.ESS}")


class StepView(NamedTuple):
    """What collectors and ``time_to_resample`` see at each step.

    ``A`` (ancestor indices, int64) is filled only when a collector reads
    the genealogy; otherwise it is None.  ``rs_flag`` is a Python bool.
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

    @property
    def W(self):
        return self.wgts.W


class _Carry(NamedTuple):
    """The state one step hands to the next."""

    X: Any
    lw: Any
    logLt: Any
    log_mean_w: Any


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


def _step0(fk, gen, N, ESSrmin, summaries, need_gen):
    """Step t=0."""
    X = fk.M0(gen, N)
    lw = fk.logG(0, None, X)
    wgts = rs.Weights(lw)
    logLt = wgts.log_mean
    A = torch.arange(N, device=lw.device) if need_gen else None
    view = StepView(fk=fk, t=0, X=X, Xp=X, A=A, wgts=wgts, aux=wgts,
                    rs_flag=False, logLt=logLt, loglt=logLt, N=N,
                    ESSrmin=ESSrmin)
    outs = summaries.collect(view) if summaries is not None else ()
    return _Carry(X=X, lw=lw, logLt=logLt, log_mean_w=wgts.log_mean), view, outs


def _step(fk, gen, carry, t, N, scheme, ESSrmin, summaries, need_gen):
    """One step for t >= 1.

    The resampling decision is taken on the host (one sync); a resampling
    step serves the particles by the scheme's z-form and resets the
    log-weights to zero.  The log-likelihood increment is ``log_mean`` of
    the new weights after resampling, and otherwise its difference from
    the carried ``log_mean``.
    """
    X, lw = carry.X, carry.lw
    wgts = rs.Weights(lw)
    pre_view = StepView(fk=fk, t=t, X=X, Xp=X, A=None, wgts=wgts, aux=wgts,
                        rs_flag=None, logLt=carry.logLt, loglt=None, N=N,
                        ESSrmin=ESSrmin)
    rs_flag = bool(fk.time_to_resample(pre_view))   # the step's host sync
    if rs_flag:
        z = rs.resampling_z(scheme, gen, wgts.W, M=N)
        Xp, A = _serve(X, z, N, need_gen)
        lw = torch.zeros_like(lw)
    else:
        Xp = X
        A = torch.arange(N, device=lw.device) if need_gen else None
    X_new = fk.M(gen, t, Xp)
    lw_new = lw + fk.logG(t, Xp, X_new)
    new_wgts = rs.Weights(lw_new)
    if rs_flag:
        loglt = new_wgts.log_mean
    else:
        loglt = new_wgts.log_mean - carry.log_mean_w
    logLt = carry.logLt + loglt
    view = StepView(fk=fk, t=t, X=X_new, Xp=Xp, A=A, wgts=new_wgts,
                    aux=wgts, rs_flag=rs_flag, logLt=logLt, loglt=loglt,
                    N=N, ESSrmin=ESSrmin)
    outs = summaries.collect(view) if summaries is not None else ()
    carry = _Carry(X=X_new, lw=lw_new, logLt=logLt,
                   log_mean_w=new_wgts.log_mean)
    return carry, view, outs


def _as_device(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class SMC:
    """A particle filter or SMC algorithm::

        pf = SMC(fk=ssms.Bootstrap(ssm=model, data=y), N=1000)
        pf.run()
        pf.logLt, pf.summaries.ESSs, pf.X, pf.W

    plus the iterator protocol (``next(pf)`` advances one step; ``run()``
    continues from there).  ``device`` defaults to the device of
    ``fk.data``; every draw comes from one ``torch.Generator`` on that
    device, seeded by ``seed`` unless ``generator`` is given.

    ``qmc``, ``store_history`` and the resampling schemes other than
    ``systematic`` exist in the JAX package and are not ported yet: asking
    for them raises ``NotImplementedError`` (ROADMAP queue A).
    """

    def __init__(self, fk=None, N=100, seed=0, generator=None, device=None,
                 resampling="systematic", ESSrmin=0.5, collect=None,
                 qmc=False, store_history=False):
        if qmc:
            raise NotImplementedError(
                "SQMC is not ported to particles_tpu_torch yet (ROADMAP A.8)")
        if store_history:
            raise NotImplementedError(
                "store_history (particle history and genealogy) is not "
                "ported to particles_tpu_torch yet (ROADMAP A.3)")
        if resampling not in rs.rs_z_funcs:
            raise rs._unported(resampling)
        if getattr(fk, "is_sampler", False):
            raise NotImplementedError(
                "SMC samplers are not ported to particles_tpu_torch yet "
                "(ROADMAP A.9)")
        if fk.isAPF:
            raise NotImplementedError(
                "auxiliary particle filters are not ported to "
                "particles_tpu_torch yet (ROADMAP A.5)")
        if device is None:
            data = getattr(fk, "data", None)
            device = data.device if isinstance(data, torch.Tensor) else "cpu"
        self.device = _as_device(device)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        elif _as_device(generator.device) != self.device:
            raise ValueError(f"generator on {generator.device}, run on "
                             f"{self.device}")
        self.gen = generator
        self.fk = fk
        self.N = N
        self.resampling = resampling
        self.ESSrmin = ESSrmin
        self.summaries = (None if collect == "off"
                          else collectors.Summaries(collect))

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
        return self.summaries is not None and self.summaries.needs_genealogy

    def _install_view(self, view, carry):
        self._carry = carry
        self.X, self.Xp, self.A = view.X, view.Xp, view.A
        self.wgts, self.aux = view.wgts, view.aux
        self.rs_flag = view.rs_flag
        self.logLt, self.loglt = view.logLt, view.loglt

    def __next__(self):
        if self.fk.done(self):
            if self.summaries is not None:
                self.summaries.finalize_lists()
            raise StopIteration
        if self.t == 0:
            carry, view, outs = _step0(self.fk, self.gen, self.N,
                                       self.ESSrmin, self.summaries,
                                       self._need_gen)
        else:
            carry, view, outs = _step(self.fk, self.gen, self._carry, self.t,
                                      self.N, self.resampling, self.ESSrmin,
                                      self.summaries, self._need_gen)
        self._install_view(view, carry)
        if self.summaries is not None:
            self.summaries.append_step(outs)
        self.t += 1

    def next(self):
        return self.__next__()

    def __iter__(self):
        return self

    @utils.timer
    def run(self):
        """Run the algorithm to completion, continuing from the current
        step."""
        for _ in self:
            pass
