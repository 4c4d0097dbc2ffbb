"""The plain reference of SMC² for stochastic volatility with leverage, in
float64 PyTorch; it imports nothing of the program, and switches TF32 off.

The model (Chopin, Jacob and Papaspiliopoulos 2013; the book script
``smc2_stochvol_leverage.py`` of the reference library): X_0 ~ N(mu,
sigma_0^2), sigma_0^2 = sigma^2 / (1 - rho^2); X_t = mu + rho (X_{t-1} -
mu) + sigma U_t; Y_t | X_{t-1}, X_t ~ N(e^{X_t/2} phi u_t, e^{X_t} (1 -
phi^2)), u_t = (X_t - E[X_t | X_{t-1}]) / sigma, u_0 = (X_0 - mu) /
sigma_0; mu ~ N(-1, 2^2), rho ~ U(-0.99, 0.99), sigma ~ Gamma(2, rate 4),
phi ~ U(-0.99, 0.99).  The same laws, grid filter, row step and
bookkeeping as the repository's ``tests/plain_sv_leverage.py``, and:

It follows the program from the program's own state: for each step the
driver kept it reads the system before the step (B), after it (A) and, at
a resample-move, the θ-particles the resampling picked (S, which the move
started from).  The numbers compared, each the largest over the kept
steps:

- ``lpost_err``: every θ-particle's ``lpost`` against the prior's
  log-density plus the program's ``loglik``, as |lpost - ref| / (1 +
  |ref|);
- ``inc_err``: every row's likelihood increment, recomputed from its inner
  log-weights before and after the step (lm(after), less lm(before) where
  the row's ESS before stood at or above ESSrmin Nx), against the
  program's loglik after less loglik before, over 1 + |loglik| (a row
  whose ESS before is within ESS_BAND of the threshold may have taken
  either decision in float32: the nearer increment counts): at step 0
  every row (lm of its first weights); without a move every row; at a
  resample-move the rows that no move replaced (θ equal to S's), against
  S's inner filter;
- ``loglt_err``: the θ-level evidence increment, from B's log-weights and
  the recomputed increments (after a move: the mean of exp of the
  increments, the program's own where no recomputed one exists), absolute;
- ``rs_count_err``: at a resample-move, S's rows are rows of B picked by
  the θ-level scheme on B's weights, so each row of B has floor(N W) or
  ceil(N W) copies (rows of B with equal θ form one group of k); the
  largest |copies - N W| / k (a sound systematic resample reads under 1);
- ``prior_z``: at step 0, the largest |z| of the θ fields' means and
  variances against the prior's (the variances' sd from its fourth
  moments);
- ``ll_z``: K = 64 θ rows drawn from the seed by A's weights.  SMC²'s
  particles follow the extended target, in which a row's log-likelihood
  estimate is tilted by its own exponential: for an estimator near
  N(l - s^2 / 2, s^2) (a particle filter's, l exact), the tilted law is
  N(l + s^2 / 2, s^2).  With l from the grid filter and s from R = 32
  replicate filters of the reference's own at the row's θ and Nx, z_k =
  (loglik_k - l_k - s_k^2 / 2) / s_k; the number is the larger of |sum
  z_k| / sqrt(K) and (sum z_k^2 - K) / sqrt(2 K), over the rows whose s_k
  is at most S_MAX (beyond it the estimator is far from log-normal).  It
  is infinite where the reference fails its own checks: the replicates'
  mean more than REF_GAP sd from l - s^2 / 2, or the grid halved moving
  sqrt(K) l / s by over GRID_HALVING_Z.

The control (:func:`control_engine`) is the reference's own inner filter,
computed in bfloat16, in the place of the program's inner filters.
"""

from __future__ import annotations

import math

import numpy as np
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


# -- the judgement ------------------------------------------------------------

FIELDS = ("mu", "phi", "rho", "sigma")
LL_ROWS = 64
LL_REPS = 32
# the reference's own checks of ``ll_z``: its replicates' mean within
# REF_GAP sd of l - s^2 / 2; the grid halved moves sqrt(K) l / s by under
# GRID_HALVING_Z, less than a tenth of the mix's limit on ``ll_z``
GRID_HALVING_Z = 0.1
REF_GAP = 1.5
S_MAX = 2.5
# an inner ESS computed in float32 (the program's) is within a few 1e-7 of
# its float64 value: a row's decision to resample is ambiguous only within
# ESS_BAND of the threshold, 30 times that
ESS_BAND = 1e-5
# the row hash's coefficients: below 2^24, so that four float32 words
# times them sum below 2^62
_COEF = np.random.default_rng(20261019).integers(1, 1 << 24, size=4)


def _theta(X, idx=None):
    th = {k: X.theta[k] for k in FIELDS}
    return th if idx is None else {k: v[idx] for k, v in th.items()}


def row_hash(theta):
    """One int64 a θ-particle, from its four float32 words."""
    words = torch.stack([theta[k].contiguous().view(torch.int32)
                         for k in FIELDS], 1).to(torch.int64)
    coef = torch.as_tensor(_COEF, dtype=torch.int64, device=words.device)
    return (words * coef).sum(1)


def count_err(theta_b, lw_b, theta_s):
    """``rs_count_err`` of the rows ``theta_s`` picked from ``theta_b``
    with log-weights ``lw_b``."""
    N = theta_s["mu"].shape[0]
    hb = row_hash(theta_b)
    uniq, inv = torch.unique(hb, return_inverse=True)
    k = torch.bincount(inv, minlength=uniq.shape[0]).double()
    W = torch.softmax(lw_b.double(), 0)
    Wg = torch.zeros(uniq.shape[0], dtype=F64,
                     device=W.device).index_add_(0, inv, W)
    hs = row_hash(theta_s)
    pos = torch.searchsorted(uniq, hs).clamp(max=uniq.shape[0] - 1)
    if not bool((uniq[pos] == hs).all()):
        return math.inf
    cnt = torch.bincount(pos, minlength=uniq.shape[0]).double()
    return float(((cnt - N * Wg).abs() / k).max())


def prior_z(theta):
    """The largest |z| of the θ fields' sample means and variances against
    the prior's."""
    zs = []
    for k, (m, v, m4) in prior_moments().items():
        x = theta[k].double()
        n = x.shape[0]
        zs.append(abs(float(x.mean()) - m) / math.sqrt(v / n))
        zs.append(abs(float(x.var()) - v) / math.sqrt((m4 - v * v) / n))
    return max(zs)


def _rel(prog, ref, scale=None):
    """The largest |prog - ref| / (1 + |scale|), ``scale`` ``ref`` by
    default; a row where both are the same infinity (a filter whose every
    weight vanished, -inf) or both NaN agrees."""
    prog = prog.double()
    scale = ref if scale is None else scale
    same = (prog == ref) | (torch.isnan(prog) & torch.isnan(ref))
    err = torch.where(same, 0.0, (prog - ref).abs() / (1.0 + scale.abs()))
    return float(err.max())


def ll_z(y, A, t, seed, K=LL_ROWS, R=LL_REPS):
    """``ll_z`` of the kept system ``A`` after step ``t`` (see the module's
    docstring), and the reference's own readings, printed."""
    X = A["X"]
    dev = X.loglik.device
    g = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (1 << 64), 11, t]))
    W = torch.softmax(A["lw"].double(), 0).cpu().numpy()
    idx = torch.as_tensor(g.choice(W.shape[0], size=K, p=W / W.sum()),
                          device=dev)
    th = {k: v.double() for k, v in _theta(X, idx).items()}
    Nx = X.xs.shape[1]
    yt = torch.as_tensor(y[:t + 1], device=dev).double()
    exact = grid_loglik(yt, th)[:, -1]
    half = grid_loglik(yt, th, scale=0.5)[:, -1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(g.integers(1 << 62)))
    reps = RowFilters(yt, {k: v.repeat_interleave(R) for k, v in th.items()},
                      Nx).loglik(gen, t + 1).reshape(K, R)
    s = reps.std(1)
    # rows whose filter spreads by more than S_MAX are left out: there the
    # log-normal law of the estimator, and so the tilt, no longer holds
    ok = s <= S_MAX
    n = int(ok.sum())
    if n == 0:
        return math.inf
    s, exact, half, reps = s[ok], exact[ok], half[ok], reps[ok]
    z = (X.loglik[idx][ok].double() - exact - 0.5 * s * s) / s
    ref_gap = float(((reps.mean(1) - exact + 0.5 * s * s) / s).abs().max())
    halving = math.sqrt(n) * float(((exact - half).abs() / s).max())
    zm = abs(float(z.sum())) / math.sqrt(n)
    zv = (float((z * z).sum()) - n) / math.sqrt(2 * n)
    out = max(zm, zv)
    print(f"reference t={t}: ll_z {out:.4g} over {n} rows (mean {zm:.4g}, "
          f"square "
          f"{zv:.4g}), replicates' gap {ref_gap:.4g} "
          f"sd, grid halving {halving:.3g} (s from {float(s.min()):.4g} to "
          f"{float(s.max()):.4g}, median {float(s.median()):.4g})",
          flush=True)
    if not (ref_gap <= REF_GAP and halving <= GRID_HALVING_Z):
        return math.inf
    return out


def increment_as_decided(lw_before, lw_after, ESSrmin, prog):
    """:func:`row_increment`, but a row whose ESS before lies within
    ESS_BAND (relative) of ESSrmin Nx may have resampled or not where the
    program computed its ESS in float32: there the increment of either
    decision is sound, and the one nearer the program's ``prog`` is
    taken."""
    thr = ESSrmin * lw_before.shape[-1]
    ess = row_ess(lw_before)
    lm_after, lm_before = row_log_mean(lw_after), row_log_mean(lw_before)
    rs = ess < thr
    inc = torch.where(rs, lm_after, lm_after - lm_before)
    other = torch.where(rs, lm_after - lm_before, lm_after)
    near = (ess - thr).abs() <= ESS_BAND * thr
    nearer = (other - prog).abs() < (inc - prog).abs()
    return torch.where(near & nearer, other, inc)


def _worst(a, b):
    """The larger of a and b, NaN where either is; b where a is not read
    yet (None)."""
    return b if (a is None or b != b or b > a) else a


def judge(config, params, inputs, outputs, device):
    """The numbers compared (see the module's docstring)."""
    y = inputs["y"]
    ess = config["inner_ESSrmin"]
    out = dict.fromkeys(("lpost_err", "inc_err", "loglt_err",
                         "rs_count_err", "prior_z", "ll_z"))
    for chk in outputs["checks"]:
        A, B, t = chk["after"], chk["before"], chk["t"]
        X = A["X"]
        th = _theta(X)
        out["lpost_err"] = _worst(out["lpost_err"], _rel(
            X.lpost, log_prior(th) + X.loglik.double()))
        if B is None:                                  # step 0
            inc = row_log_mean(X.lws)
            prog = X.loglik.double()
            rows = slice(None)
            loglt = row_log_mean(inc)
            out["prior_z"] = _worst(out["prior_z"], prior_z(th))
        elif not A["rs"]:
            prog = X.loglik.double() - B["X"].loglik.double()
            inc = increment_as_decided(B["X"].lws, X.lws, ess, prog)
            rows = slice(None)
            loglt = evidence_increment(B["lw"], inc)
        else:
            S = A["start"]
            out["rs_count_err"] = _worst(out["rs_count_err"], count_err(
                _theta(B["X"]), B["lw"], _theta(S)))
            kept = torch.ones_like(X.loglik, dtype=torch.bool)
            for k in FIELDS:
                kept &= X.theta[k] == S.theta[k]
            rows = torch.nonzero(kept).reshape(-1)
            prog = X.loglik[rows].double() - S.loglik[rows].double()
            inc = increment_as_decided(S.lws[rows], X.lws[rows], ess, prog)
            incs = A["lw"].double().clone()
            incs[rows] = inc
            loglt = evidence_increment_after_move(incs)
        if prog.numel():
            out["inc_err"] = _worst(out["inc_err"], _rel(
                prog, inc, X.loglik[rows].double()))
        out["loglt_err"] = _worst(out["loglt_err"],
                                  abs(float(A["loglt"]) - float(loglt)))
        out["ll_z"] = _worst(out["ll_z"], ll_z(
            y, A, t, outputs["seed"] + 1000 * chk["run"]))
    # a number no kept step could give is missing, and fails its limit
    return {k: v for k, v in out.items() if v is not None}


# -- the control --------------------------------------------------------------

class Bf16Filters:
    """The reference's own inner filters of B θ-particles in bfloat16, with
    the program's ``InnerPF`` interface (float32 in and out)."""

    def __init__(self, y, theta, Nx, ESSrmin):
        self.f = RowFilters(y, theta, Nx, dtype=torch.bfloat16,
                            ESSrmin=ESSrmin)

    def init(self, gen):
        return tuple(v.float() for v in self.f.init(gen))

    def step(self, gen, t, xs, lws):
        out = self.f.step(gen, t, xs.to(torch.bfloat16),
                          lws.to(torch.bfloat16))
        return tuple(v.float() for v in out)

    def replay(self, gen, t):
        return tuple(v.float() for v in self.f.replay(gen, t))


def control_engine(config, inputs, device):
    """The control: the inner filters' factory ``engine(theta, Nx)`` that
    the driver puts in the place of the program's, the reference's own
    filters in bfloat16 over the mix's returns (float32 stated)."""
    y = torch.as_tensor(inputs["y"], device=device)

    def engine(theta, Nx):
        return Bf16Filters(y, theta, Nx, config["inner_ESSrmin"])

    return engine
