"""B particle filters advanced together, one parameter vector a row
(PyTorch port).

The inner filter that PMMH (rows = chains) and SMC² (rows = θ-particles)
share: the counterpart of ``SMC2._inner_init`` and ``SMC2._inner_step``
(``particles_tpu/smc_samplers.py:1215-1251``), which the JAX package vmaps
over θ, and of the vmapped ``core._run_full`` inside PMMH
(``particles_tpu/mcmc.py:501-508``).

Layout.  The states of the B filters are one (B·Nx, ...) tensor, row b's
particles at b·Nx .. (b + 1)·Nx - 1, and the log-weights are (B, Nx).
Each θ leaf, (B,) or (B, d), is expanded to one value a particle,
(B·Nx,) or (B·Nx, d), so that ``ssm_cls(**theta)`` is one model whose
laws take a parameter a particle, as the port's laws do: ``fk.M``,
``fk.logG`` and ``fk.logeta`` then evaluate every row at once.  A model
whose laws do not give one value a particle raises ``ValueError`` naming
the model.

A step, for every row at once and with no host read: the row's ESS
decides ``ESS_b < ESSrmin · Nx`` on the device; every row draws its
scheme's z-form (plain batched torch: the JAX package serves these rows
with ``serve_by_z(use_pallas=False)``, outside any Pallas kernel), the
ancestors are ``searchsorted(z, arange(Nx), right=True)`` and a gather,
and ``torch.where`` keeps the old particles in the rows that do not
resample.  ``systematic``, ``stratified`` and ``multinomial`` are batched;
``residual`` and ``ssp`` draw their counts row by row (correct, slow).
An auxiliary ``fk_cls`` (``logeta``) resamples on the auxiliary weights
and resets them as ``core._step`` does.

Randomness.  A step is ``draws`` (the scheme's uniforms or exponentials,
and the transition ``move(fk, t, xp)``, which draws from the generator)
then ``step_with``; the tests replay the JAX package's draws through
``step_with`` and ``init_with``.
"""

from __future__ import annotations

import torch

from particles_tpu_torch import resampling as rs
from particles_tpu_torch import tracing

__all__ = ["InnerPF", "BATCHED_SCHEMES", "ROW_LOOP_SCHEMES"]

BATCHED_SCHEMES = ("systematic", "stratified", "multinomial")
ROW_LOOP_SCHEMES = ("residual", "ssp")


def _rows(lw):
    """Row-wise :class:`resampling.Weights` of (B, Nx) log-weights:
    ``(W, ESS, log_mean)``; NaN counts as -inf."""
    lw = torch.nan_to_num(lw, nan=-torch.inf, posinf=torch.inf,
                          neginf=-torch.inf)
    m = lw.max(1, keepdim=True).values
    w = torch.exp(lw - m)
    s = w.sum(1, keepdim=True)
    W = w / s
    log_mean = (m + torch.log(s / lw.shape[1])).squeeze(1)
    return W, 1.0 / (W * W).sum(1), log_mean


def _row_log_mean_exp(v, lw):
    """Row-wise ``resampling.log_mean_exp(v, lw=lw)``: log of the
    lw-weighted mean of exp(v), (B,)."""
    s = v + lw
    m = s.max(1, keepdim=True).values
    out = m.squeeze(1) + torch.log(torch.exp(s - m).sum(1))
    ml = lw.max(1, keepdim=True).values
    return out - (ml.squeeze(1) + torch.log(torch.exp(lw - ml).sum(1)))


def _row_cdf(W):
    """Normalised cumulative weights of each row (the JAX package's plain
    form, ``cumsum(W) / cumsum(W)[-1]``)."""
    cs = torch.cumsum(W, 1)
    return cs / cs[:, -1:]


def _finish_z(z, M):
    """Clip to [0, M], pin the last entry to M and enforce the
    nondecreasing contract, row by row."""
    z = z.clamp(0, M)
    z[:, -1:].fill_(M)
    return torch.cummax(z, 1).values


def systematic_z_rows(W, u, M):
    """Systematic z-form of each row: ``floor(M cs - u_b) + 1``."""
    z = torch.floor(M * _row_cdf(W) - u[:, None]).to(torch.int32) + 1
    return _finish_z(z, M)


def stratified_z_rows(W, u, M):
    """Stratified z-form of each row for the uniforms ``u`` (B, M)."""
    g = M * _row_cdf(W)
    k = torch.floor(g).to(torch.int32)
    frac = g - k
    uk = torch.gather(u, 1, k.clamp(0, M - 1).long())
    z = torch.where(k >= M, M, k + (uk <= frac).to(torch.int32))
    return _finish_z(z, M)


def multinomial_z_rows(W, E, M):
    """Multinomial z-form of each row from M + 1 exponentials ``E``
    (B, M + 1): the spacings' sorted uniforms counted below each cs."""
    ce = torch.cumsum(E, 1)
    su = ce[:, :-1] / ce[:, -1:]
    z = torch.searchsorted(su, _row_cdf(W).contiguous(), right=True)
    return _finish_z(z.to(torch.int32), M)


_Z_ROWS = {"systematic": systematic_z_rows,
           "stratified": stratified_z_rows,
           "multinomial": multinomial_z_rows}


def ancestors_rows(z, j=None):
    """Sorted ancestors of each row, ``A[b, j] = #{k: z[b, k] <= j}``
    (int64, clipped to Nx - 1 so that no gather leaves its row); ``j``,
    the (B, Nx) int32 positions, when the caller keeps them."""
    B, Nx = z.shape
    if j is None:
        j = torch.arange(Nx, dtype=z.dtype, device=z.device).expand(
            B, Nx).contiguous()
    A = torch.searchsorted(z, j, right=True)
    return A.clamp_(max=Nx - 1)


def expand_theta(theta, Nx):
    """Each θ leaf, (B,) or (B, d), as one value a particle, (B·Nx, ...)."""
    out = {}
    for k, v in theta.items():
        B = v.shape[0]
        out[k] = v.unsqueeze(1).expand((B, Nx) + v.shape[1:]).reshape(
            (B * Nx,) + v.shape[1:])
    return out


class InnerPF:
    """B particle filters of ``Nx`` particles each, row b run at the
    parameters ``theta[k][b]``: ``fk_cls(ssm=ssm_cls(**theta_b),
    data=data)`` for every row at once.

    ``init(gen)`` gives ``(xs, lws, ll)``: states (B, Nx, ...), log-weights
    (B, Nx) and the time-0 log-likelihood increments (B,); ``step(gen, t,
    xs, lws)`` gives the new states, log-weights and increments at time t.
    ``replay(gen, t)`` runs a fresh filter over the observations 0..t-1
    and returns the states, log-weights and log-likelihood (B,).
    """

    def __init__(self, fk_cls, ssm_cls, data, theta, Nx,
                 resampling="systematic", ESSrmin=0.5):
        if resampling not in BATCHED_SCHEMES + ROW_LOOP_SCHEMES:
            raise ValueError(
                f"{resampling!r}: the inner filter takes a counts-based "
                f"scheme, one of {BATCHED_SCHEMES + ROW_LOOP_SCHEMES}")
        self.B = next(iter(theta.values())).shape[0]
        self.Nx = Nx
        self.scheme = resampling
        self.ESSrmin = ESSrmin
        self.model_name = getattr(ssm_cls, "__name__", str(ssm_cls))
        try:
            self.fk = fk_cls(ssm=ssm_cls(**expand_theta(theta, Nx)),
                             data=data)
        except (TypeError, ValueError, RuntimeError) as e:
            raise self._not_batched(e) from e
        self.isAPF = self.fk.isAPF
        self._pos = self._base = None
        self._last = None       # (lw, its _rows), from the last step

    def _positions(self, device):
        """(B, Nx) int32 positions 0..Nx-1 and the (B, 1) row offsets
        b·Nx, made once."""
        if self._pos is None:
            B, Nx = self.B, self.Nx
            self._pos = torch.arange(Nx, dtype=torch.int32,
                                     device=device).expand(B, Nx).contiguous()
            self._base = torch.arange(0, B * Nx, Nx, device=device)[:, None]
        return self._pos, self._base

    def _not_batched(self, what):
        return ValueError(
            f"{self.model_name}: its laws must take one parameter value a "
            f"particle to run {self.B} filters as one ({what})")

    def _check(self, what, v, lead):
        if not isinstance(v, torch.Tensor) or v.shape[:1] != (lead,):
            shape = getattr(v, "shape", type(v).__name__)
            raise self._not_batched(f"{what} has shape {shape}, expected "
                                    f"({lead}, ...)")
        return v

    def _eval(self, what, f, *args):
        try:
            with tracing.span("model"):
                out = f(*args)
        except (TypeError, ValueError, RuntimeError) as e:
            raise self._not_batched(f"{what}: {e}") from e
        return self._check(what, out, self.B * self.Nx)

    # -- draws ---------------------------------------------------------------

    def draws0(self, gen):
        """The time-0 draw: ``move0(fk)``, the initial particles."""
        return lambda fk: fk.M0(gen, self.B * self.Nx)

    def draws(self, gen):
        """One step's randomness: ``(rs_draw, move)``.  ``rs_draw`` is the
        systematic scheme's (B,) uniforms, the stratified scheme's (B, Nx),
        the multinomial scheme's (B, Nx + 1) exponentials, or, for a
        row-loop scheme, the generator; ``move(fk, t, xp)`` draws the new
        particles."""
        B, Nx, dev = self.B, self.Nx, gen.device
        if self.scheme == "systematic":
            r = torch.rand(B, generator=gen, device=dev)
        elif self.scheme == "stratified":
            r = torch.rand(B, Nx, generator=gen, device=dev)
        elif self.scheme == "multinomial":
            r = torch.empty(B, Nx + 1, device=dev).exponential_(
                generator=gen)
        else:
            r = gen
        return r, lambda fk, t, xp: fk.M(gen, t, xp)

    # -- the filter ----------------------------------------------------------

    def _counted(self, t):
        """The span of one inner step of every row at time t, counted."""
        tracing.count("smc2.inner_steps")
        tracing.count("smc2.inner_particle_steps", self.B * self.Nx)
        return tracing.span("smc2.inner", t=t)

    def init_with(self, move0):
        """Time 0 from the initial particles ``move0(fk)``."""
        with self._counted(0):
            x0 = self._eval("M0", move0, self.fk)
            lw0 = self._eval("logG", self.fk.logG, 0, None, x0)
            lw0 = lw0.reshape(self.B, self.Nx)
            return self._shape(x0), lw0, self._keep(lw0)[2]

    def init(self, gen):
        return self.init_with(self.draws0(gen))

    def _shape(self, x):
        return x.reshape((self.B, self.Nx) + x.shape[1:])

    def _keep(self, lw):
        """:func:`_rows` of ``lw``, kept for the step that starts from it."""
        rows = _rows(lw)
        self._last = (lw, rows)
        return rows

    def _weights(self, lws):
        if self._last is not None and self._last[0] is lws:
            return self._last[1]
        return _rows(lws)

    def _z(self, W, rs_draw):
        if self.scheme in _Z_ROWS:
            return _Z_ROWS[self.scheme](W, rs_draw, self.Nx)
        counts = [rs.resampling_counts(self.scheme, rs_draw, W[b], self.Nx)
                  for b in range(self.B)]
        return torch.cumsum(torch.stack(counts), 1, dtype=torch.int32)

    def step_with(self, t, xs, lws, rs_draw, move):
        """One step at time t >= 1 given its draws: ``(xs, lws, loglt)``."""
        with self._counted(t):
            B, Nx, fk = self.B, self.Nx, self.fk
            X = xs.reshape((B * Nx,) + xs.shape[2:])
            W, ESS, lm = self._weights(lws)
            if self.isAPF:
                logeta = self._eval("logeta", fk.logeta, t - 1,
                                    X).reshape(B, Nx)
                Wa, ESSa, _ = _rows(lws + logeta)
            else:
                Wa, ESSa = W, ESS
            rs_flag = ESSa < self.ESSrmin * Nx                      # (B,)
            pos, base = self._positions(lws.device)
            A = ancestors_rows(self._z(Wa, rs_draw), pos)
            Xr = X.index_select(0, (A + base).reshape(-1))
            flag = rs_flag.reshape((B,) + (1,) * (xs.ndim - 1))
            Xp = torch.where(flag, self._shape(Xr), xs).reshape(X.shape)
            if self.isAPF:
                reset = (_row_log_mean_exp(logeta, lws)[:, None]
                         - self._eval("logeta", fk.logeta, t - 1, Xr).reshape(
                             B, Nx))
                lw_sel = torch.where(rs_flag[:, None], reset, lws)
            else:
                lw_sel = torch.where(rs_flag[:, None], 0.0, lws)
            X_new = self._eval("M", move, fk, t, Xp)
            lw_new = lw_sel + self._eval("logG", fk.logG, t, Xp,
                                         X_new).reshape(B, Nx)
            lm_new = self._keep(lw_new)[2]
            loglt = torch.where(rs_flag, lm_new, lm_new - lm)
            return self._shape(X_new), lw_new, loglt

    def step(self, gen, t, xs, lws):
        return self.step_with(t, xs, lws, *self.draws(gen))

    def replay(self, gen, t, draws=None):
        """A fresh filter over the observations 0..t-1: ``(xs, lws, ll)``.
        ``draws``, ``(move0, [(rs_draw, move) for s in 1..t-1])``, replays
        given randomness."""
        if draws is None:
            xs, lws, ll = self.init(gen)
        else:
            xs, lws, ll = self.init_with(draws[0])
        for s in range(1, t):
            d = self.draws(gen) if draws is None else draws[1][s - 1]
            xs, lws, loglt = self.step_with(s, xs, lws, *d)
            ll = ll + loglt
        return xs, lws, ll

    def loglik(self, gen, T):
        """The log-likelihood estimate of every row over all T
        observations, (B,)."""
        return self.replay(gen, T)[2]
