"""A plain float64 reference of stochastic volatility with leverage and of
SMC²'s bookkeeping over it, in plain PyTorch.  It imports none of JAX, the
JAX package or the port, and switches TF32 off.

The model (Chopin, Jacob and Papaspiliopoulos 2013; the GBP/USD study of
the reference library's book script ``smc2_stochvol_leverage.py``):

- X_0 ~ N(mu, sigma_0^2), sigma_0^2 = sigma^2 / (1 - rho^2);
- X_t = mu + rho (X_{t-1} - mu) + sigma U_t;
- Y_t | X_{t-1}, X_t ~ N(e^{X_t / 2} phi u_t, e^{X_t} (1 - phi^2)), with
  u_t = (X_t - E[X_t | X_{t-1}]) / sigma and u_0 = (X_0 - mu) / sigma_0;
- the prior: mu ~ N(-1, 2^2), rho ~ U(-0.99, 0.99), sigma ~ Gamma(shape 2,
  rate 4), phi ~ U(-0.99, 0.99).

It holds (a) the laws, (b) the exact log-likelihood by a grid filter,
(c) one inner bootstrap step of one row from given draws, a loop over
rows, and (d) the θ-level bookkeeping of SMC²: a row's increment from its
inner log-weights before and after a step, the evidence increment and
``lpost``.  The tests hold the port's ``InnerPF`` and ``SMC2`` to it.
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
PRIOR = {"mu": ("normal", -1.0, 2.0), "rho": ("uniform", -0.99, 0.99),
         "sigma": ("gamma", 2.0, 4.0), "phi": ("uniform", -0.99, 0.99)}
# the grid filter: +-GRID_SD sd of X_0 about mu, GRID_DIV points a
# transition sd (the narrowest feature of the integrand, below)
GRID_SD = 8.0
GRID_DIV = 5.0
# elements of one block of the grid filter's pair sums
GRID_BLOCK = 1 << 24


# -- (a) the laws -----------------------------------------------------------

def _f64(v, device=None):
    return torch.as_tensor(v, dtype=F64, device=device)


def log_prior(theta):
    """The prior's log-density of each θ (dict of (K,) tensors), -inf
    outside its support.  A uniform's ends are compared in θ's own
    precision: a float32 draw at u = 0 is float32(-0.99), which lies
    below -0.99 in float64 but is the support's end as stated."""
    out = 0.0
    for k, (law, a, b) in PRIOR.items():
        stated = torch.as_tensor(theta[k])
        x = _f64(stated)
        if law == "normal":
            lp = -0.5 * ((x - a) / b) ** 2 - math.log(b) - 0.5 * math.log(
                2 * math.pi)
        elif law == "uniform":
            inside = (stated >= a) & (stated <= b)
            lp = torch.full_like(x, -math.log(b - a)).masked_fill(
                ~inside, -math.inf)
        else:       # Gamma, shape a, rate b
            safe = x.clamp(min=1e-300)
            lp = torch.where(x > 0, a * math.log(b) + (a - 1) * torch.log(
                safe) - b * x - math.lgamma(a), -math.inf)
        out = out + lp
    return out


def prior_moments():
    """{field: (mean, variance, fourth central moment)} of the prior."""
    out = {}
    for k, (law, a, b) in PRIOR.items():
        if law == "normal":
            out[k] = (a, b * b, 3 * b ** 4)
        elif law == "uniform":
            w = b - a
            out[k] = (0.5 * (a + b), w * w / 12, w ** 4 / 80)
        else:
            out[k] = (a / b, a / b ** 2, 3 * a * (a + 2) / b ** 4)
    return out


def sig0(rho, sigma):
    return sigma / torch.sqrt(1.0 - rho * rho)


def ext(xp, mu, rho):
    """E[X_t | X_{t-1} = xp]."""
    return mu + rho * (xp - mu)


def _normal_lpdf(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(scale) - 0.5 * math.log(2 * math.pi)


def log_px0(x, th):
    return _normal_lpdf(x, th["mu"], sig0(th["rho"], th["sigma"]))


def log_px(x, xp, th):
    return _normal_lpdf(x, ext(xp, th["mu"], th["rho"]), th["sigma"])


def log_py(y, xp, x, th):
    """log N(y; e^{x/2} phi u, e^x (1 - phi^2)); ``xp`` None at t = 0."""
    if xp is None:
        u = (x - th["mu"]) / sig0(th["rho"], th["sigma"])
    else:
        u = (x - ext(xp, th["mu"], th["rho"])) / th["sigma"]
    sd = torch.exp(0.5 * x)
    phi = th["phi"]
    return _normal_lpdf(y, sd * phi * u, sd * torch.sqrt(1.0 - phi * phi))


def lpost(theta, loglik):
    """log prior(θ) + loglik, float64."""
    return log_prior(theta) + _f64(loglik)


# -- (b) the exact log-likelihood: a grid filter -----------------------------

def grid_size(th, scale=1.0):
    """Points of each θ's grid: over +-GRID_SD sigma_0 about mu, spaced at
    most sigma sqrt(1 - phi^2) / GRID_DIV, the width of the narrowest
    factor of the pair integrand (the transition times the observation,
    as a function of X_t, is a Gaussian of at most that sd), so also under
    sigma / GRID_DIV.  ``scale`` 0.5 gives the halved grid."""
    width = 2 * GRID_SD / torch.sqrt(1.0 - th["rho"] ** 2)
    h = torch.sqrt(1.0 - th["phi"] ** 2) / GRID_DIV
    return (torch.ceil(scale * width / h) + 1).to(torch.int64)


def grid_loglik(y, theta, scale=1.0, group=8):
    """log p(y_{0:t} | θ) for every t and θ: (K, T) float64, by a grid
    filter on each θ's own grid (:func:`grid_size`).  The θ's go by
    ``group``, in the order of their grid sizes, and a group's grids share
    its largest count."""
    y = _f64(y)
    th = {k: _f64(v, y.device).reshape(-1) for k, v in theta.items()}
    order = torch.argsort(grid_size(th, scale))
    out = torch.empty(order.shape[0], y.shape[0], dtype=F64,
                      device=y.device)
    for a in range(0, order.shape[0], group):
        idx = order[a:a + group]
        out[idx] = _grid_group(y, {k: v[idx] for k, v in th.items()},
                               scale)
    return out


def _grid_group(y, th, scale):
    """:func:`grid_loglik` of K θ's on grids of one count.  Each step is an
    O(G^2) sum over pairs (x_{t-1}, x_t), in blocks of rows of GRID_BLOCK
    elements, in log space."""
    dev = y.device
    K, T = th["mu"].shape[0], y.shape[0]
    G = int(grid_size(th, scale).max())
    s0 = sig0(th["rho"], th["sigma"])
    lin = torch.linspace(-GRID_SD, GRID_SD, G, dtype=F64, device=dev)
    g = th["mu"][:, None] + s0[:, None] * lin                     # (K, G)
    logh = torch.log(g[:, 1] - g[:, 0])[:, None]
    col = {k: v[:, None] for k, v in th.items()}                  # (K, 1)
    lp = log_px0(g, col) + log_py(y[0], None, g, col)
    out = torch.empty(K, T, dtype=F64, device=dev)
    inc = torch.logsumexp(lp + logh, 1)
    out[:, 0] = inc
    lp = lp - inc[:, None]
    pair = {k: v[:, None, None] for k, v in th.items()}           # (K,1,1)
    bi = max(1, GRID_BLOCK // (K * G))
    for t in range(1, T):
        acc = torch.full((K, G), -math.inf, dtype=F64, device=dev)
        for a in range(0, G, bi):
            xp = g[:, a:a + bi, None]                             # (K,b,1)
            x = g[:, None, :]                                     # (K,1,G)
            s = (lp[:, a:a + bi, None] + log_px(x, xp, pair)
                 + log_py(y[t], xp, x, pair))
            acc = torch.logaddexp(acc, torch.logsumexp(s, 1))
        lq = acc + logh
        inc = torch.logsumexp(lq + logh, 1)
        out[:, t] = out[:, t - 1] + inc
        lp = lq - inc[:, None]
    return out


# -- (c) one inner bootstrap step of one row, from given draws -------------

def row_log_mean(lw):
    """log mean exp of the last axis."""
    lw = _f64(lw)
    return torch.logsumexp(lw, -1) - math.log(lw.shape[-1])


def row_ess(lw):
    W = torch.softmax(_f64(lw), -1)
    return 1.0 / (W * W).sum(-1)


def systematic_ancestors(lw, u):
    """The ancestors of one row's systematic resampling with uniform u:
    slot j takes the first particle whose cumulative weight reaches
    (j + u) / Nx."""
    W = torch.softmax(_f64(lw), -1)
    cs = torch.cumsum(W, -1)
    cs = cs / cs[-1]
    Nx = W.shape[-1]
    pts = (torch.arange(Nx, dtype=F64, device=cs.device) + float(u)) / Nx
    return torch.searchsorted(cs, pts).clamp(max=Nx - 1)


def row_init(y0, th, eps):
    """Time 0 of one row: states mu + sigma_0 eps, log-weights, the
    increment."""
    x = th["mu"] + sig0(th["rho"], th["sigma"]) * _f64(eps)
    lw = log_py(_f64(y0), None, x, th)
    return x, lw, row_log_mean(lw)


def row_step(yt, th, x, lw, u, eps, ESSrmin=0.5):
    """One step of one row from its systematic uniform ``u`` and the
    transition's normals ``eps``: ``(x, lw, increment, resampled)``.  It
    resamples where the row's ESS is below ESSrmin Nx, then moves and
    weights; the increment is log mean exp of the new log-weights, less
    that of the old ones where it did not resample."""
    x, lw = _f64(x), _f64(lw)
    Nx = x.shape[0]
    rs = bool(row_ess(lw) < ESSrmin * Nx)
    if rs:
        xp, lw_sel = x[systematic_ancestors(lw, u)], torch.zeros_like(lw)
    else:
        xp, lw_sel = x, lw
    xn = ext(xp, th["mu"], th["rho"]) + th["sigma"] * _f64(eps)
    lw_new = lw_sel + log_py(_f64(yt), xp, xn, th)
    inc = row_log_mean(lw_new) - (0.0 if rs else row_log_mean(lw))
    return xn, lw_new, inc, rs


def rows_step(yt, theta, xs, lws, us, eps, ESSrmin=0.5):
    """:func:`row_step` row by row: θ leaves (B,), states and log-weights
    (B, Nx), uniforms (B,), normals (B, Nx)."""
    out = [row_step(yt, {k: _f64(v[b]) for k, v in theta.items()}, xs[b],
                    lws[b], us[b], eps[b], ESSrmin)
           for b in range(xs.shape[0])]
    return (torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]),
            torch.stack([o[2] for o in out]))


def rows_init(y0, theta, eps):
    out = [row_init(y0, {k: _f64(v[b]) for k, v in theta.items()}, eps[b])
           for b in range(eps.shape[0])]
    return (torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]),
            torch.stack([o[2] for o in out]))


# -- (d) the θ-level bookkeeping --------------------------------------------

def row_increment(lw_before, lw_after, ESSrmin=0.5):
    """Each row's likelihood increment from its inner log-weights before
    and after a step ((B, Nx) each): lm(after), less lm(before) where the
    row did not resample (its ESS before at or above ESSrmin Nx)."""
    Nx = lw_before.shape[-1]
    rs = row_ess(lw_before) < ESSrmin * Nx
    return row_log_mean(lw_after) - torch.where(
        rs, 0.0, row_log_mean(lw_before))


def evidence_increment(lw_before, inc):
    """The θ-level evidence increment of a step without a move: the
    before-weights' mean of exp(inc)."""
    lw = _f64(lw_before)
    return torch.logsumexp(lw + _f64(inc), 0) - torch.logsumexp(lw, 0)


def evidence_increment_after_move(inc):
    """The increment of a step after a resample-move (equal weights)."""
    return row_log_mean(inc)


# -- a vectorised bootstrap filter of the same model ------------------------

class RowFilters:
    """B bootstrap filters of ``Nx`` particles, row b at θ_b, in ``dtype``,
    resampling a row by systematic resampling where its ESS falls below
    ESSrmin Nx: ``loglik(gen, t)`` replays each over y_0..y_{t-1}."""

    def __init__(self, y, theta, Nx, dtype=F64, ESSrmin=0.5):
        self.y = y.to(dtype)
        self.dtype, self.Nx, self.ESSrmin = dtype, Nx, ESSrmin
        self.th = {k: v.to(dtype).reshape(-1, 1) for k, v in theta.items()}
        self.B = self.th["mu"].shape[0]

    def _normals(self, gen):
        return torch.randn(self.B, self.Nx, generator=gen,
                           device=self.y.device).to(self.dtype)

    def _lm(self, lw):
        return torch.logsumexp(lw, 1) - math.log(self.Nx)

    def init(self, gen):
        th = self.th
        x = th["mu"] + sig0(th["rho"], th["sigma"]) * self._normals(gen)
        lw = log_py(self.y[0], None, x, th)
        return x, lw, self._lm(lw)

    def step(self, gen, t, x, lw):
        th, Nx = self.th, self.Nx
        u = torch.rand(self.B, 1, generator=gen, device=x.device)
        W = torch.softmax(lw, 1)
        rs = 1.0 / (W * W).sum(1) < self.ESSrmin * Nx
        cs = torch.cumsum(W, 1)
        # the search in float32 at least (no search in bfloat16)
        cs = (cs / cs[:, -1:]).to(torch.promote_types(self.dtype,
                                                      torch.float32))
        pts = ((torch.arange(Nx, device=x.device) + u) / Nx).to(cs.dtype)
        A = torch.searchsorted(cs, pts).clamp(max=Nx - 1)
        xp = torch.where(rs[:, None], torch.gather(x, 1, A), x)
        lw_sel = torch.where(rs[:, None], torch.zeros_like(lw), lw)
        xn = ext(xp, th["mu"], th["rho"]) + th["sigma"] * self._normals(gen)
        lw_new = lw_sel + log_py(self.y[t], xp, xn, th)
        inc = self._lm(lw_new) - torch.where(rs, 0.0, self._lm(lw))
        return xn, lw_new, inc

    def replay(self, gen, t):
        x, lw, ll = self.init(gen)
        for s in range(1, t):
            x, lw, inc = self.step(gen, s, x, lw)
            ll = ll + inc
        return x, lw, ll

    def loglik(self, gen, t):
        return self.replay(gen, t)[2]
