"""Particle history and off-line smoothing (FFBS, two-filter), PyTorch port.

Counterpart of ``particles_tpu/smoothing.py``: the history containers
(full, partial and rolling), the genealogy (``_compute_trajectories``),
FFBS in its O(N²), MCMC, rejection and QMC forms, two-filter smoothing in
its O(N²) and O(N) forms, and :func:`smoothing_worker`.

The full history is what the engine stacks after a run: ``X`` (T, N, ...)
(or a dict of such tensors), ``A`` (T, N) int64 and ``lw`` (T, N).  Each
backward pass is a Python loop over reversed time, vectorised over the M
trajectories, and every index read is a gather (``index_select``): the
JAX package's sort-serve-unsort and sorted-ancestor serves answered a TPU
that has no fast gather.  Draws from the filter's weights go through
``resampling.multinomial_iid`` and ``multinomial_iid_values`` (the B3 CDF
and the B4 inverse-CDF serve on the card, with the particles' columns as
payloads); a sampler that draws from the same weights more than once
builds the CDF once (``resampling.pinned_cdf``) and serves each draw from
it (``resampling.draw_by_cdf``).  Every draw comes from the
``torch.Generator`` passed in.

``fk.logpt(t, xp, x)`` and the test functions must broadcast over leading
dimensions: the O(N²) forms call them on an (R, 1, ...) block against a
(1, N, ...) one.  Those forms go by blocks of rows of at most 2^24 pairs
(the JAX package's ``Kc`` rule), since the whole (M, N) matrix is 64 GiB
at M = N = 2^17.
"""

from __future__ import annotations

import math
import time
from collections import deque

import torch

from particles_tpu_torch import ops
from particles_tpu_torch import resampling as rs
from particles_tpu_torch import rqmc

__all__ = [
    "ParticleHistory",
    "PartialParticleHistory",
    "RollingParticleHistory",
    "generate_hist_obj",
    "smoothing_worker",
]

PAIRS_PER_BLOCK = 1 << 24   # (rows x N) elements of an O(N²) block


# ---------------------------------------------------------------------------
# particles: a tensor with leading dimension N, or a dict of such tensors
# ---------------------------------------------------------------------------

def _map(f, X):
    if isinstance(X, dict):
        return {k: f(v) for k, v in X.items()}
    return f(X)


def _leaves(X):
    return list(X.values()) if isinstance(X, dict) else [X]


def _rebuild(X, leaves):
    if isinstance(X, dict):
        return dict(zip(X, leaves))
    return leaves[0]


def _take(X, idx):
    """``X[idx]`` along the particle axis, for any index shape."""
    return _map(lambda v: v[idx], X)


def _stack(frames):
    if isinstance(frames[0], dict):
        return {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
    return torch.stack(frames)


def _rows_per_block(M, N):
    """Rows of an (M, N) computation taken at once (the JAX ``Kc``)."""
    return int(min(M, max(8, PAIRS_PER_BLOCK // max(N, 1))))


def _categorical_rows(gen, logits):
    """One draw per row of (R, N) unnormalised log-probabilities: the
    Gumbel argmax, with the Gumbel noise as -log of Exp(1) draws."""
    E = torch.empty_like(logits).exponential_(generator=gen)
    return torch.argmax(logits - torch.log(E), dim=1)


def _backward_exact(gen, logpt, X_src, lw_src, x_dst):
    """For each of the M points ``x_dst``, an index n drawn with probability
    proportional to ``exp(lw_src[n]) * exp(logpt(X_src[n], x))``: the exact
    O(MN) backward kernel, by blocks of rows.  Returns (M,) int64."""
    M = _leaves(x_dst)[0].shape[0]
    N = lw_src.shape[0]
    R = _rows_per_block(M, N)
    src = _map(lambda v: v.unsqueeze(0), X_src)
    out = []
    for s in range(0, M, R):
        rows = _map(lambda v: v[s:s + R].unsqueeze(1), x_dst)
        out.append(_categorical_rows(gen, lw_src + logpt(src, rows)))
    return torch.cat(out)


def _hybrid_reject(gen, logpt, ubnd, X_src, lw_src, x_dst, max_trials):
    """The same draws as :func:`_backward_exact`, by rejection: rounds of
    proposals from the weights of ``lw_src`` (B3 + B4, the proposed
    particles served in the same launch), accepted with probability
    ``exp(logpt(x_prop, x) - ubnd)``, at most ``max_trials`` of them, each
    drawing only for the points still rejected; then the exact kernel for
    the stragglers.  The CDF is built once (B3) and each round is one B4
    launch; learning how many are left is one host sync a round.
    Returns ``(idx, rounds, proposals, stragglers)``."""
    cs = rs.pinned_cdf(rs.exp_and_normalise(lw_src))
    M = _leaves(x_dst)[0].shape[0]
    dev = lw_src.device
    idx = torch.empty(M, dtype=torch.int64, device=dev)
    todo = torch.arange(M, device=dev)
    rounds = nprops = 0
    while todo.numel() > 0 and rounds < max_trials:
        m = todo.numel()
        prop, vals = rs.draw_by_cdf(gen, cs, _leaves(X_src), m)
        lp = logpt(_rebuild(X_src, vals), _take(x_dst, todo)) - ubnd
        ok = torch.log(torch.rand(m, generator=gen, device=dev)) < lp
        idx.index_put_((todo,), torch.where(ok, prop, idx[todo]))
        todo = todo[~ok]                           # the round's host sync
        nprops += m
        rounds += 1
    if todo.numel() > 0:
        idx.index_put_((todo,), _backward_exact(gen, logpt, X_src, lw_src,
                                                _take(x_dst, todo)))
    return idx, rounds, nprops, todo.numel()


# ---------------------------------------------------------------------------
# genealogy
# ---------------------------------------------------------------------------

def _genealogy(As, B_last):
    """``[B_0, ..., B_k]`` for k ancestor vectors ``As``: ``B_k = B_last``
    and ``B_i = As[i][B_{i+1}]``, a reverse loop of gathers."""
    B = [B_last]
    for A in reversed(list(As)):
        B.append(A.index_select(0, B[-1]))
    B.reverse()
    return B


def _compute_trajectories(A):
    """(T, N) int64 ``B`` with ``B[t, n]`` the time-t ancestor of particle n
    at the last time, from T ancestor vectors (``A[0]`` is not read)."""
    N = A[0].shape[0]
    last = torch.arange(N, device=A[0].device)
    return torch.stack(_genealogy(A[1:], last))


# ---------------------------------------------------------------------------
# history containers
# ---------------------------------------------------------------------------

def generate_hist_obj(option, hilbert_ordered=False):
    """What ``SMC(store_history=option)`` fills as it runs: ``None`` for
    ``False``; for ``True``, the frames that ``finalize`` stacks into a
    :class:`ParticleHistory`; a :class:`PartialParticleHistory` for a
    callable; a :class:`RollingParticleHistory` for an int k >= 0.  Each
    has ``save(smc)``, called after every step, and ``finalize(fk)``, what
    ``smc.hist`` holds (during the run and after it), and records
    ``hilbert_ordered``: the frames are in Hilbert order (an SQMC run)."""
    if option is True:
        return _FullHistory(hilbert_ordered)
    if option is False:
        return None
    if callable(option):
        return PartialParticleHistory(option, hilbert_ordered)
    if isinstance(option, int) and option >= 0:
        return RollingParticleHistory(option, hilbert_ordered)
    raise ValueError("store_history: invalid option")


class _FullHistory:
    """The frames ``(X, A, lw)`` of every step, kept on the device and
    stacked once, by ``finalize``, into a :class:`ParticleHistory`."""

    def __init__(self, hilbert_ordered=False):
        self.frames, self.hist = [], None
        self.hilbert_ordered = hilbert_ordered

    def save(self, smc):
        self.frames.append((smc.X, smc.A, smc.wgts.lw))

    def finalize(self, fk):
        if self.frames:
            X, A, lw = zip(*self.frames)
            self.hist = ParticleHistory(fk, _stack(X), torch.stack(A),
                                        torch.stack(lw),
                                        hilbert_ordered=self.hilbert_ordered)
            self.frames = []
        return self.hist


class PartialParticleHistory:
    """History recorded only at the times t where ``func(t)`` is true:
    dicts ``X`` and ``wgts`` keyed by t."""

    def __init__(self, func, hilbert_ordered=False):
        self.is_save_time = func
        self.hilbert_ordered = hilbert_ordered
        self.X, self.wgts = {}, {}

    def save(self, smc):
        t = smc.t
        if self.is_save_time(t):
            self.X[t] = smc.X
            self.wgts[t] = smc.wgts

    def finalize(self, fk):
        return self


class RollingParticleHistory:
    """The k most recent particle systems: deques ``X``, ``A`` and ``wgts``
    of at most k frames, so O(kN) memory."""

    def __init__(self, length, hilbert_ordered=False):
        self.hilbert_ordered = hilbert_ordered
        self.X = deque([], length)
        self.A = deque([], length)
        self.wgts = deque([], length)

    @property
    def N(self):
        return _leaves(self.X[0])[0].shape[0]

    @property
    def T(self):
        return len(self.X)

    def save(self, smc):
        self.X.append(smc.X)
        self.A.append(smc.A)
        self.wgts.append(smc.wgts)

    def finalize(self, fk):
        return self

    def compute_trajectories(self):
        """(T, N) ``B``, ``B[t, n]`` the ancestor in frame t of particle n
        of the last frame."""
        return _compute_trajectories(list(self.A))


class ParticleHistory:
    """The full history of a run, and the off-line smoothers as methods.

    ``X`` (T, N, ...) (or a dict of such tensors), ``A`` (T, N) int64 and
    ``lw`` (T, N); ``wgts`` is the last frame's :class:`Weights`,
    ``wgts_at(t)`` frame t's.  ``hilbert_ordered`` says that every frame
    is in Hilbert order, each ``A`` indexing the previous ordered frame (an
    SQMC run), which QMC FFBS needs.  ``backward_sampling_reject`` leaves,
    in time order for t = 0..T-2, ``acc_rate`` (a tensor), ``rounds`` and
    ``stragglers`` (lists of ints) on the object.
    """

    def __init__(self, fk, X, A, lw, hilbert_ordered=False):
        self.fk = fk
        self.X = X
        self.A = A
        self.lw = lw
        self.hilbert_ordered = hilbert_ordered

    @property
    def T(self):
        return self.A.shape[0]

    @property
    def N(self):
        return self.A.shape[1]

    @property
    def wgts(self):
        return rs.Weights(self.lw[-1])

    def wgts_at(self, t):
        return rs.Weights(self.lw[t])

    def _x_at(self, t):
        return _map(lambda v: v[t], self.X)

    def compute_trajectories(self):
        return _compute_trajectories(self.A)

    def extract_one_trajectory(self, gen):
        """One trajectory drawn from the genealogy: the last frame's
        particle is drawn from its weights and followed back through
        ``A``."""
        n = rs.multinomial_once(gen, self.wgts.W).reshape(1)
        idx = _genealogy(list(self.A[1:]), n)
        idx = torch.cat(idx)
        return _map(lambda v: v[torch.arange(self.T, device=idx.device),
                                idx], self.X)

    # -- FFBS ---------------------------------------------------------------

    def _init_backward(self, gen, M):
        return rs.multinomial_iid(gen, self.wgts.W, M)

    def _output_paths(self, idx):
        """The paths, (T, M, ...), from the (T, M) indices."""
        ts = torch.arange(self.T, device=idx.device).unsqueeze(1)
        return _map(lambda v: v[ts, idx], self.X)

    def _logpt(self, t):
        return lambda xp, x: self.fk.logpt(t, xp, x)

    def backward_sampling_ON2(self, gen, M):
        """Exact O(N²) FFBS: each trajectory's index at t is drawn from
        its (N,) backward weights, by blocks of rows."""
        idx = [self._init_backward(gen, M)]
        for t in range(self.T - 2, -1, -1):
            xn = _take(self._x_at(t + 1), idx[-1])
            idx.append(_backward_exact(gen, self._logpt(t + 1),
                                       self._x_at(t), self.lw[t], xn))
        idx.reverse()
        return self._output_paths(torch.stack(idx))

    def backward_sampling_mcmc(self, gen, M, nsteps=1):
        """MCMC FFBS (independent Metropolis, Dau & Chopin 2022), O(N + M)
        a step: each trajectory starts from its genealogical ancestor, then
        takes ``nsteps`` steps proposing from the filter's weights (B3 + B4,
        the proposed particles served in the same launch)."""
        fk = self.fk
        idx_next = self._init_backward(gen, M)
        idx = [idx_next]
        for t in range(self.T - 2, -1, -1):
            X_t = self._x_at(t)
            cs = rs.pinned_cdf(rs.exp_and_normalise(self.lw[t]))
            xn = _take(self._x_at(t + 1), idx_next)
            idx_t = self.A[t + 1].index_select(0, idx_next)
            lp_cur = fk.logpt(t + 1, _take(X_t, idx_t), xn)
            for _ in range(nsteps):
                prop, vals = rs.draw_by_cdf(gen, cs, _leaves(X_t), M)
                lp_prop = fk.logpt(t + 1, _rebuild(X_t, vals), xn)
                lu = torch.log(torch.rand(M, generator=gen,
                                          device=cs.device))
                accept = lu < lp_prop - lp_cur
                idx_t = torch.where(accept, prop, idx_t)
                lp_cur = torch.where(accept, lp_prop, lp_cur)
            idx.append(idx_t)
            idx_next = idx_t
        idx.reverse()
        return self._output_paths(torch.stack(idx))

    def backward_sampling_reject(self, gen, M, max_trials=None):
        """Hybrid rejection FFBS: at most ``max_trials`` rounds (default M)
        of proposals from the filter's weights, accepted with probability
        ``p(x_{t+1} | x_t) / exp(fk.upper_bound_trans(t + 1))``, then the
        exact O(N) kernel for the trajectories still rejected (the
        stragglers), by blocks of rows.  A round draws only for the
        trajectories still rejected, and learning how many are left is one
        host sync a round."""
        if max_trials is None:
            max_trials = M
        idx = [self._init_backward(gen, M)]
        acc, rounds, stragglers = [], [], []
        for t in range(self.T - 2, -1, -1):
            xn = _take(self._x_at(t + 1), idx[-1])
            idx_t, n, nprops, nstrag = _hybrid_reject(
                gen, self._logpt(t + 1), self.fk.upper_bound_trans(t + 1),
                self._x_at(t), self.lw[t], xn, max_trials)
            acc.append((M - nstrag) / max(nprops, 1))
            rounds.append(n)
            stragglers.append(nstrag)
            idx.append(idx_t)
        idx.reverse()
        self.acc_rate = torch.tensor(acc[::-1])
        self.rounds = rounds[::-1]
        self.stragglers = stragglers[::-1]
        return self._output_paths(torch.stack(idx))

    def backward_sampling_qmc(self, gen, M):
        """QMC FFBS, O(M N) a step, on the history of an SQMC run: the
        M trajectories follow the rows of one scrambled Sobol set of T
        columns drawn from ``gen``.  At the last time each draws its index
        by the inverse CDF of the last weights (B3, then B4) at its last
        column; at each earlier t, by the inverse CDF of its (N,) backward
        weights at column t, which pairs the point with the Hilbert order
        of frame t.  The O(N) rows go by blocks of at most
        ``PAIRS_PER_BLOCK`` pairs."""
        if not self.hilbert_ordered:
            raise ValueError(
                "QMC FFBS requires particles to have been Hilbert-ordered "
                "during the forward pass (run SMC with qmc=True)")
        u = rqmc.sobol(gen, M, self.T)
        csT, _ = rs._normalised_cumsum_mono(self.wgts.W)
        idx = [ops.ancestors_by_su(u[:, -1].contiguous(), csT)]
        for t in range(self.T - 2, -1, -1):
            idx.append(self._backward_qmc(t, idx[-1], u[:, t]))
        idx.reverse()
        return self._output_paths(torch.stack(idx))

    def _backward_qmc(self, t, idx_next, u_t):
        """Each trajectory's index at t: the first n where the cumulative
        backward weights of its point at t + 1 reach ``u_t`` (N - 1 when
        none does), the count of a monotone CDF below u_t as in the JAX
        package, whose cumsum may dip where this one need not."""
        X_t, lw_t, N = self._x_at(t), self.lw[t], self.N
        xn = _take(self._x_at(t + 1), idx_next)
        src = _map(lambda v: v.unsqueeze(0), X_t)
        M = idx_next.shape[0]
        R = _rows_per_block(M, N)
        out = []
        for s in range(0, M, R):
            rows = _map(lambda v: v[s:s + R].unsqueeze(1), xn)
            lwm = lw_t + self.fk.logpt(t + 1, src, rows)
            cw = torch.softmax(lwm, 1).cumsum(1)
            reach = cw >= u_t[s:s + R, None]
            first = reach.to(torch.uint8).argmax(1)
            out.append(torch.where(reach.any(1), first, N - 1))
        return torch.cat(out)

    # -- two-filter smoothing -----------------------------------------------

    def two_filter_smoothing(self, t, info, phi, loggamma, linear_cost=False,
                             return_ess=False, modif_forward=None,
                             modif_info=None, gen=None):
        """Two-filter estimate of E[phi(X_t, X_{t+1}) | y_{0:T-1}], from
        this (forward) history and ``info``, an SMC run on the reversed data
        with ``store_history=True``; ``loggamma`` is the log-density of the
        information filter's artificial prior.  ``linear_cost`` takes the
        O(N) importance-sampling form, which draws from ``gen`` (seed 0
        when not given)."""
        if not 0 <= t < self.T - 1:
            raise ValueError("two-filter smoothing: t must be in 0..T-2")
        ti = self.T - 2 - t
        Xinfo = _map(lambda v: v[ti], info.hist.X)
        lwinfo = info.hist.lw[ti] - loggamma(Xinfo)
        if linear_cost:
            if gen is None:
                gen = torch.Generator(device=lwinfo.device).manual_seed(0)
            return self._two_filter_ON(t, Xinfo, lwinfo, phi, return_ess,
                                       modif_forward, modif_info, gen)
        return self._two_filter_ON2(t, Xinfo, lwinfo, phi)

    def _two_filter_ON2(self, t, Xinfo, lwinfo, phi):
        """O(N²), by blocks of forward particles."""
        X_t, lw_t = self._x_at(t), self.lw[t]
        upb = lwinfo.max() + lw_t.max()
        info = _map(lambda v: v.unsqueeze(0), Xinfo)
        R = _rows_per_block(lw_t.shape[0], lwinfo.shape[0])
        sp = sw = 0.0
        for s in range(0, lw_t.shape[0], R):
            rows = _map(lambda v: v[s:s + R].unsqueeze(1), X_t)
            om = torch.exp(lwinfo + lw_t[s:s + R, None] - upb
                           + self.fk.logpt(t + 1, rows, info))
            sp = sp + (om * phi(rows, info)).sum()
            sw = sw + om.sum()
        return sp / sw

    def _two_filter_ON(self, t, Xinfo, lwinfo, phi, return_ess,
                       modif_forward, modif_info, gen):
        """O(N) importance sampling: N pairs (I_k, J_k), I_k drawn from the
        information filter's weights and J_k from the forward filter's, each
        an IID multinomial draw (B3 + B4, the particles served in the same
        launch), and the pairs independent, so that the pairs weighted by
        ``p(x_I | x_J)`` target the O(N²) form's sum over all pairs.  This
        departs from the JAX package (and upstream ``particles``), which
        pairs the order statistics of two sorted multinomial draws: the
        port computes another estimator of the same quantity.
        ``tests/test_torch_smoothing.py`` holds it to the O(N²) form on the
        same two histories."""
        if modif_info is not None:
            lwinfo = lwinfo + modif_info
        I, vi = rs.multinomial_iid_values(gen, rs.exp_and_normalise(lwinfo),
                                          _leaves(Xinfo))
        X_t, lw_t = self._x_at(t), self.lw[t]
        if modif_forward is not None:
            lw_t = lw_t + modif_forward
        J, vj = rs.multinomial_iid_values(gen, rs.exp_and_normalise(lw_t),
                                          _leaves(X_t))
        X_J, Xinfo_I = _rebuild(X_t, vj), _rebuild(Xinfo, vi)
        log_omega = self.fk.logpt(t + 1, X_J, Xinfo_I)
        if modif_forward is not None:
            log_omega = log_omega - modif_forward[J]
        if modif_info is not None:
            log_omega = log_omega - modif_info[I]
        Om = rs.exp_and_normalise(log_omega)
        vals = phi(X_J, Xinfo_I)
        est = (Om * vals).sum(0) if vals.ndim == 1 else torch.tensordot(
            Om, vals, dims=([0], [0]))
        if return_ess:
            return est, 1.0 / (Om * Om).sum()
        return est


# ---------------------------------------------------------------------------
# benchmark harness
# ---------------------------------------------------------------------------

def _norm_logpdf(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(scale) - 0.5 * math.log(2.0 * math.pi)


def smoothing_worker(method=None, N=100, fk=None, fk_info=None,
                     add_func=None, log_gamma=None, seed=0):
    """Generic worker for off-line smoothing benchmarks.

    ``method`` in ['FFBS_purereject', 'FFBS_hybrid', 'FFBS_MCMC',
    'FFBS_ON2', 'FFBS_QMC', 'two-filter_ON', 'two-filter_ON_prop',
    'two-filter_ON2'] ('FFBS_QMC' runs the forward pass as SQMC).  The
    filters run on
    ``fk.data``'s device; their generators and the smoother's are seeded
    from ``seed``.  Returns ``{'est': (T-1,) tensor, 'cpu': seconds}``, the
    time of the forward pass and the smoother, the clock stopped after the
    device finishes.
    """
    from particles_tpu_torch.core import SMC

    seeds = torch.randint(0, 2 ** 62, (3,),
                          generator=torch.Generator().manual_seed(seed))
    seeds = seeds.tolist()
    T = fk.T
    if fk_info is None:
        fk_info = fk.__class__(ssm=fk.ssm, data=fk.data.flip(0))
    pf = SMC(fk=fk, N=N, qmc=method == "FFBS_QMC", store_history=True,
             seed=seeds[0])
    gen = torch.Generator(device=pf.device).manual_seed(seeds[1])
    tic = time.perf_counter()
    pf.run()
    if method.startswith("FFBS"):
        sub = method.split("_")[-1]
        if sub == "QMC":
            z = pf.hist.backward_sampling_qmc(gen, N)
        elif sub == "ON2":
            z = pf.hist.backward_sampling_ON2(gen, N)
        elif sub == "MCMC":
            z = pf.hist.backward_sampling_mcmc(gen, N)
        elif sub == "hybrid":
            z = pf.hist.backward_sampling_reject(gen, N)
        elif sub == "purereject":
            z = pf.hist.backward_sampling_reject(gen, N, max_trials=10 ** 9)
        else:
            raise ValueError(f"unknown FFBS submethod {sub}")
        est = torch.stack([
            add_func(t, _map(lambda v: v[t], z),
                     _map(lambda v: v[t + 1], z)).mean(0)
            for t in range(T - 1)])
    elif method in ("two-filter_ON2", "two-filter_ON", "two-filter_ON_prop"):
        infopf = SMC(fk=fk_info, N=N, store_history=True, seed=seeds[2])
        infopf.run()
        ests = []
        for t in range(T - 1):
            def psi(x, xf, t=t):
                return add_func(t, x, xf)
            if method == "two-filter_ON2":
                ests.append(pf.hist.two_filter_smoothing(t, infopf, psi,
                                                         log_gamma))
                continue
            modif_fwd = modif_info = None
            if method == "two-filter_ON_prop":
                ti = T - 2 - t
                Xi1 = infopf.hist.X[ti + 1]
                modif_fwd = _norm_logpdf(pf.hist.X[t], Xi1.mean(),
                                         Xi1.std(correction=0))
                Xf1 = pf.hist.X[t + 1]
                modif_info = _norm_logpdf(infopf.hist.X[ti], Xf1.mean(),
                                          Xf1.std(correction=0))
            ests.append(pf.hist.two_filter_smoothing(
                t, infopf, psi, log_gamma, linear_cost=True,
                modif_forward=modif_fwd, modif_info=modif_info, gen=gen))
        est = torch.stack(ests)
    else:
        raise ValueError(f"smoothing_worker: no such method {method}")
    if est.is_cuda:
        torch.cuda.synchronize(est.device)
    return {"est": est, "cpu": time.perf_counter() - tic}
