"""On-line summary collectors (PyTorch port).

Counterpart of ``particles_tpu/collectors.py``: the ``Collector`` base,
the default collectors ``ESSs``, ``LogLts`` and ``Rs_flags``, ``Moments``,
the on-line smoothers (``Fixed_lag_smooth``, ``Online_smooth_naive``,
``Online_smooth_ON2``, ``Paris``) and the ``Summaries`` container.

A stateless collector defines ``collect(view)``; a stateful one sets
``stateful = True`` and defines ``init(view) -> (state, out)`` (t=0) and
``step(view, state) -> (state, out)``, and ``Summaries`` threads the
states through the steps, as the JAX package threads them through its
scan.  The view is :class:`particles_tpu_torch.core.StepView`.  Test
functions (``add_func``, ``phi``) and ``fk.logpt`` must broadcast over
leading dimensions: the O(N²) and PaRIS updates call them on (R, N) and
(N, P) blocks.
"""

from __future__ import annotations

import torch

from particles_tpu_torch import smoothing

__all__ = ["Collector", "Summaries", "ESSs", "LogLts", "Rs_flags",
           "Moments", "Fixed_lag_smooth", "OnlineSmootherMixin",
           "Online_smooth_naive", "Online_smooth_ON2", "Paris",
           "default_collector_cls"]

class Collector:
    """Base class for collectors: ``collect(view)`` returns what to record
    at one step (stateful ones: ``init`` and ``step``, above).  Keyword
    arguments declared in the class attribute ``signature`` become
    attributes.  ``uses_genealogy`` says whether the collector reads
    ``view.A`` or ``view.Xp`` (the ancestor indices are then returned by
    the resampling kernel on resampling steps).  ``host_side`` says that it
    reads the step on the host, in numpy (the waste-free variance
    collectors of ``smc_samplers``).  ``dist_safe`` says that it is right
    under particle sharding (:func:`parallel.run_shardmap_smc`): its
    reductions go through the dist-aware numerics (``Weights``,
    ``wmean_and_var``), and it neither walks the genealogy nor keeps
    per-particle state across steps."""

    signature = {}
    stateful = False
    uses_genealogy = True
    host_side = False
    dist_safe = False

    @property
    def summary_name(self):
        cn = self.__class__.__name__
        return cn[0].lower() + cn[1:]

    def __init__(self, **kwargs):
        params = dict(self.signature)
        params.update(kwargs)
        for k, v in params.items():
            setattr(self, k, v)

    def collect(self, view):
        raise NotImplementedError


class ESSs(Collector):
    """Effective sample size at each t."""

    summary_name = "ESSs"
    uses_genealogy = False
    dist_safe = True

    def collect(self, view):
        return view.wgts.ESS


class LogLts(Collector):
    """Cumulative log-likelihood estimate at each t."""

    summary_name = "logLts"
    uses_genealogy = False
    dist_safe = True

    def collect(self, view):
        return view.logLt


class Rs_flags(Collector):
    """Whether resampling happened at each t."""

    summary_name = "rs_flags"
    uses_genealogy = False
    dist_safe = True

    def collect(self, view):
        return view.rs_flag


class Moments(Collector):
    """Weighted moments of the particles at each t: ``fk.default_moments``
    (``{'mean', 'var'}``) unless ``mom_func(W, X)`` is given.  Under
    particle sharding the default moments are global; a ``mom_func`` must
    reduce through the dist-aware numerics too."""

    summary_name = "moments"
    uses_genealogy = False
    dist_safe = True
    signature = {"mom_func": None}

    def collect(self, view):
        f = view.fk.default_moments if self.mom_func is None else self.mom_func
        return f(view.wgts.W, view.X)


# ---------------------------------------------------------------------------
# smoothing collectors
# ---------------------------------------------------------------------------

def _wsum(W, vals):
    """sum_n W_n vals[n] over the particle axis."""
    return (W.reshape((-1,) + (1,) * (vals.ndim - 1)) * vals).sum(0)


class Fixed_lag_smooth(Collector):
    """Fixed-lag smoothing over a window of ``lag + 1`` frames: at time t,
    the weighted mean of ``phi`` of the window's trajectories, followed
    back through the window's genealogy.  ``phi`` maps the stacked window
    (lag + 1, N, ...) to (N, ...) values; by default the oldest frame (the
    state at lag ``lag``).  The window (frames and ancestor vectors) is the
    collector's state; before the window fills, its oldest frames are
    time 0's."""

    summary_name = "fixed_lag_smooths"
    signature = {"phi": None, "lag": 5}
    stateful = True

    def test_func(self, Xwin):
        return Xwin[0] if self.phi is None else self.phi(Xwin)

    def _out(self, view, Xs):
        return _wsum(view.wgts.W, self.test_func(smoothing._stack(Xs)))

    def init(self, view):
        k = self.lag + 1
        ar = torch.arange(view.N, device=view.wgts.W.device)
        state = ((view.X,) * k, (ar,) * k)
        return state, self._out(view, state[0])

    def step(self, view, state):
        Xbuf, Abuf = state
        Xbuf = Xbuf[1:] + (view.X,)
        Abuf = Abuf[1:] + (view.A,)
        B = smoothing._compute_trajectories(Abuf)
        Xs = [smoothing._take(Xt, Bt) for Xt, Bt in zip(Xbuf, B)]
        return (Xbuf, Abuf), self._out(view, Xs)


class OnlineSmootherMixin:
    """On-line smoothing of the additive function ``fk.add_func``: each
    particle carries Phi, its estimate of sum_s psi_s(x_{s-1}, x_s); the
    output at t is the weighted mean of Phi."""

    stateful = True

    def init(self, view):
        Phi = view.fk.add_func(0, None, view.X)
        return self.save_for_later((Phi,), view), _wsum(view.wgts.W, Phi)

    def step(self, view, state):
        Phi = self.update(view, state)
        return self.save_for_later((Phi,), view), _wsum(view.wgts.W, Phi)

    def update(self, view, state):
        raise NotImplementedError

    def save_for_later(self, base, view):
        return base


class Online_smooth_naive(OnlineSmootherMixin, Collector):
    """Genealogy-tracking on-line smoother, O(N) a step."""

    summary_name = "online_smooth_naives"

    def update(self, view, state):
        (Phi,) = state
        return Phi.index_select(0, view.A) + view.fk.add_func(
            view.t, view.Xp, view.X)


class Online_smooth_ON2(OnlineSmootherMixin, Collector):
    """Exact O(N²) on-line smoother: for each new particle, the softmax of
    its backward weights against the previous particles, by blocks of
    rows of at most 2^24 pairs."""

    summary_name = "online_smooth_ON2s"
    uses_genealogy = False

    def update(self, view, state):
        Phi, prev_X, prev_lw = state
        fk, t = view.fk, view.t
        N = prev_lw.shape[0]
        prev = smoothing._map(lambda v: v.unsqueeze(0), prev_X)
        R = smoothing._rows_per_block(N, N)
        out = []
        for s in range(0, N, R):
            rows = smoothing._map(lambda v: v[s:s + R].unsqueeze(1), view.X)
            Wn = torch.softmax(prev_lw + fk.logpt(t, prev, rows), dim=1)
            vals = Phi + fk.add_func(t, prev, rows)
            out.append((Wn.reshape(Wn.shape + (1,) * (vals.ndim - 2))
                        * vals).sum(1))
        return torch.cat(out)

    def save_for_later(self, base, view):
        return base + (view.X, view.wgts.lw)


PARIS_SEED_OFFSET = 987654321


class Paris(OnlineSmootherMixin, Collector):
    """Hybrid PaRIS on-line smoother (Olsson & Westerborn 2017; hybrid
    variant of Dau & Chopin 2022).

    For each particle, ``Nparis`` backward indices are drawn by rejection
    from the previous weights (B3 + B4, the proposed particles served in
    the same launch), accepted with probability ``p(x_t | x_{t-1}) /
    exp(fk.ssm.upper_bound_log_pt(t))``: at most ``max_trials`` rounds
    (default N), each drawing only for the draws still rejected, then the
    exact O(N) kernel for the stragglers, by blocks of rows.  Learning how
    many are left is one host sync a round; ``rounds`` lists each step's
    rounds of the last run.  The draws come from a generator of its own on
    the run's device, seeded from the run generator's ``initial_seed()``
    plus ``PARIS_SEED_OFFSET``, so that the filter's particles are the
    same with and without it.
    """

    summary_name = "paris"
    signature = {"Nparis": 2, "max_trials": None}
    uses_genealogy = False

    def update(self, view, state):
        Phi, prev_X, prev_lw, gen = state
        fk, t, N, P = view.fk, view.t, view.N, self.Nparis
        # draw n * P + p is the p-th backward index of particle n
        x_new = smoothing._map(lambda v: v.repeat_interleave(P, 0), view.X)
        As, n, _, _ = smoothing._hybrid_reject(
            gen, lambda xp, x: fk.logpt(t, xp, x),
            fk.ssm.upper_bound_log_pt(t), prev_X, prev_lw, x_new,
            N if self.max_trials is None else self.max_trials)
        self.rounds.append(n)
        As = As.view(N, P)
        x_new = smoothing._map(lambda v: v.unsqueeze(1), view.X)
        vals = Phi[As] + fk.add_func(t, smoothing._take(prev_X, As), x_new)
        return vals.mean(1)

    def init(self, view):
        self.rounds = []
        Phi = view.fk.add_func(0, None, view.X)
        seed = (PARIS_SEED_OFFSET if view.gen is None
                else view.gen.initial_seed() + PARIS_SEED_OFFSET)
        gen = torch.Generator(device=view.wgts.W.device)
        gen.manual_seed(seed % 2 ** 64)
        return (Phi, view.X, view.wgts.lw, gen), _wsum(view.wgts.W, Phi)

    def step(self, view, state):
        Phi = self.update(view, state)
        return ((Phi, view.X, view.wgts.lw, state[3]),
                _wsum(view.wgts.W, Phi))


default_collector_cls = [ESSs, LogLts, Rs_flags]


class Summaries:
    """Per-run summaries: after a run, each collector's record is an
    attribute, e.g. ``smc.summaries.ESSs`` (a (T,) tensor)."""

    def __init__(self, cols):
        self._collectors = [cls() for cls in default_collector_cls]
        if cols is not None:
            self._collectors.extend(
                c if isinstance(c, Collector) else c() for c in cols)
        for col in self._collectors:
            setattr(self, col.summary_name, [])

    @property
    def needs_genealogy(self):
        return any(c.uses_genealogy for c in self._collectors)

    @property
    def has_host_side(self):
        """True if a collector reads the step on the host (numpy).  The
        eager engine runs every collector on the step's view alike, so
        this only informs: each such collector syncs once a step."""
        return any(c.host_side for c in self._collectors)

    def init_step(self, view):
        """t=0: ``(states, outputs)``, one of each per collector."""
        states, outs = [], []
        for c in self._collectors:
            s, o = c.init(view) if c.stateful else (None, c.collect(view))
            states.append(s)
            outs.append(o)
        return tuple(states), tuple(outs)

    def step(self, view, states):
        """t >= 1: ``(states, outputs)`` from the previous states."""
        new_states, outs = [], []
        for c, s in zip(self._collectors, states):
            s, o = c.step(view, s) if c.stateful else (None, c.collect(view))
            new_states.append(s)
            outs.append(o)
        return tuple(new_states), tuple(outs)

    def append_step(self, outputs):
        for col, out in zip(self._collectors, outputs):
            getattr(self, col.summary_name).append(out)

    def finalize_lists(self):
        """Stack each record into one tensor where its entries allow."""
        for col in self._collectors:
            val = getattr(self, col.summary_name)
            if not isinstance(val, list) or not val:
                continue
            if (all(isinstance(v, torch.Tensor) for v in val)
                    and len({v.shape for v in val}) == 1):
                setattr(self, col.summary_name, torch.stack(val))
            elif all(isinstance(v, (bool, int, float)) for v in val):
                setattr(self, col.summary_name, torch.tensor(val))
