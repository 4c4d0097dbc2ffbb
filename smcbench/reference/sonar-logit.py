"""The plain reference of Bayesian logistic regression under waste-free
adaptive tempering, in float64 PyTorch; it imports nothing of the
program.

It follows the program step by step from the program's own state: for
each step the driver kept, it reads the particle system before the step
(B: particles, log-weights, exponent) and after it (A), and works out
again what the step produced.  The numbers compared, each the largest
over the steps kept:

- ``llik_err``: the log-likelihood of every particle of A, sum_i log
  sigmoid(beta . x_i) over the 208 rows, against the program's, as
  |llik - ref| / (1 + |ref|);
- ``lpost_err``: the tempered log-posterior lprior + exponent llik of
  every particle of A, the same way;
- ``epn_err``: the exponent the program chose against the one that solves
  ESS(delta llik) = ESSrmin N0 (bisection in float64 on the reference's
  log-likelihoods), over the reference's increment delta;
- ``loglt_err``: the evidence increment log mean exp(delta llik) at the
  program's delta, absolute;
- ``rs_count_err``: the resampling.  A's first M particles (the chains'
  starting points) are rows of B picked by systematic resampling on B's
  weights, so each particle of B has floor(M W) or ceil(M W) copies.
  Particles of B with equal values (a rejected move repeats its chain's
  state) form one group of k; the number is the largest |copies - M W|
  / k over the groups (a sound resample reads under 1), infinite where a
  starting point is no particle of B;
- ``acc_gap``: the share of chain steps whose state changed, against the
  program's acceptance rate (the mean acceptance probability), in units
  of the binomial sd;
- ``move_acc_z``: whether the move targets the right law.  For chain
  steps drawn from the seed, the reference works out the Metropolis
  acceptance probability of the state the step left, by its own
  proposals from the random walk (recomputed from B's weighted
  covariance) against the tempered posterior at B's exponent, the one the
  move targets; the number is the gap between the steps that moved and
  the sum of those probabilities, in units of its sd (binomial, plus the
  proposals' Monte Carlo error).  It holds for any state, stationary or
  not, so a sound move reads about a standard normal;
- ``prior_z``: at step 0, the largest |z| of the particles' means and
  variances against the prior N(0, scale^2).

The control is the program with TF32 matrix products switched on.
"""

from __future__ import annotations

import math

import numpy as np

BLOCK = 1 << 18
# the row hash's coefficients: below 2^24, so that a float32 row's 32-bit
# words times them sum below 2^62 for d <= 64 (no integer overflow)
_COEF = np.random.default_rng(20261018).integers(1, 1 << 24, size=64)


def loglik64(torch, theta, data):
    """Each row's sum_i log sigmoid(theta . x_i), in float64."""
    D = torch.as_tensor(data, device=theta.device).double()
    out = torch.empty(theta.shape[0], dtype=torch.float64,
                      device=theta.device)
    zero = torch.zeros((), dtype=torch.float64, device=theta.device)
    for s in range(0, theta.shape[0], BLOCK):
        lin = theta[s:s + BLOCK].double() @ D.T
        out[s:s + BLOCK] = -torch.logaddexp(zero, -lin).sum(1)
    return out


def lprior64(torch, theta, scale):
    d = theta.shape[1]
    sq = torch.empty(theta.shape[0], dtype=torch.float64,
                     device=theta.device)
    for s in range(0, theta.shape[0], BLOCK):
        th = theta[s:s + BLOCK].double()
        sq[s:s + BLOCK] = (th * th).sum(1)
    return -0.5 * sq / scale ** 2 - d * (math.log(scale)
                                         + 0.5 * math.log(2 * math.pi))


def ess64(torch, x):
    """exp(2 logsumexp(x) - logsumexp(2 x))."""
    return float(torch.exp(2 * torch.logsumexp(x, 0)
                           - torch.logsumexp(2 * x, 0)))


def next_exponent(torch, epn, llik, alpha, rounds=100):
    """The exponent e with ESS((e - epn) llik) = alpha N, by bisection on
    the increment; 1 where the whole increment keeps the ESS at or above
    alpha N."""
    N = llik.shape[0]
    hi = 1.0 - epn
    if ess64(torch, hi * llik) >= alpha * N:
        return 1.0
    a, b = 0.0, hi
    for _ in range(rounds):
        m = 0.5 * (a + b)
        if ess64(torch, m * llik) > alpha * N:
            a = m
        else:
            b = m
    return epn + 0.5 * (a + b)


def row_hash(torch, theta):
    """One int64 a row of float32 ``theta``, from its 32-bit words."""
    d = theta.shape[1]
    coef = torch.as_tensor(_COEF[:d], dtype=torch.int64, device=theta.device)
    out = torch.empty(theta.shape[0], dtype=torch.int64, device=theta.device)
    for s in range(0, theta.shape[0], BLOCK):
        words = theta[s:s + BLOCK].contiguous().view(torch.int32)
        out[s:s + BLOCK] = (words.to(torch.int64) * coef).sum(1)
    return out


def count_err(torch, theta_b, lw_b, starts):
    """``rs_count_err`` of the starting points ``starts`` ((M, d)) drawn
    from ``theta_b`` with log-weights ``lw_b``."""
    M = starts.shape[0]
    hb = row_hash(torch, theta_b)
    uniq, inv = torch.unique(hb, return_inverse=True)
    k = torch.bincount(inv, minlength=uniq.shape[0]).double()
    W = torch.softmax(lw_b.double(), 0)
    Wg = torch.zeros(uniq.shape[0], dtype=torch.float64,
                     device=W.device).index_add_(0, inv, W)
    ha = row_hash(torch, starts)
    pos = torch.searchsorted(uniq, ha).clamp(max=uniq.shape[0] - 1)
    if not bool((uniq[pos] == ha).all()):
        return math.inf
    cnt = torch.bincount(pos, minlength=uniq.shape[0]).double()
    return float(((cnt - M * Wg).abs() / k).max())


def acc_gap(torch, theta_a, P, acc_rate):
    """``acc_gap`` of the chains of ``theta_a`` ((P M, d), chain position
    major) against the acceptance rate ``acc_rate``."""
    M = theta_a.shape[0] // P
    th = theta_a.reshape(P, M, -1)
    moved = 0
    for s in range(0, M, BLOCK):
        blk = th[:, s:s + BLOCK]
        moved += int((blk[1:] != blk[:-1]).any(-1).sum())
    n = M * (P - 1)
    rep = float(acc_rate)
    sd = math.sqrt(max(rep * (1.0 - rep), 1e-12) / n)
    return abs(moved / n - rep) / sd


def lpost64(torch, theta, data, scale, epn):
    """The tempered log-posterior lprior + epn llik, in float64 (the
    prior alone at epn 0, as the program's target has it)."""
    lp = lprior64(torch, theta, scale)
    return lp + epn * loglik64(torch, theta, data) if epn > 0 else lp


def move_acc_z(torch, theta_a, theta_b, lw_b, epn, data, scale, P, seed,
               K=1 << 14, Q=64, block=2048):
    """``move_acc_z``: K chain steps of A ((P M, d), chain position major)
    drawn from ``seed``; B's particles ``theta_b`` and log-weights
    ``lw_b`` give the random walk's covariance, ``epn`` the exponent its
    target has."""
    N0, d = theta_a.shape
    M = N0 // P
    dev = theta_a.device
    f64 = dict(dtype=torch.float64, device=dev)
    # the proposal: 2.38 / sqrt(d) times the Cholesky factor of B's
    # weighted covariance (plus 1e-9 I), as the random walk calibrates it
    W = torch.softmax(lw_b.double(), 0)
    m = torch.zeros(d, **f64)
    for s in range(0, N0, BLOCK):
        m += W[s:s + BLOCK] @ theta_b[s:s + BLOCK].double()
    cov = torch.zeros(d, d, **f64)
    for s in range(0, N0, BLOCK):
        xc = theta_b[s:s + BLOCK].double() - m
        cov += (W[s:s + BLOCK, None] * xc).T @ xc
    L = (2.38 / math.sqrt(d)) * torch.linalg.cholesky(
        cov + 1e-9 * torch.eye(d, **f64))
    g = np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64),
                                                      7]))
    K = min(K, M * (P - 1))
    p = torch.as_tensor(g.integers(0, P - 1, size=K), device=dev)
    c = torch.as_tensor(g.integers(0, M, size=K), device=dev)
    A = theta_a.reshape(P, M, d)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(g.integers(1 << 62)))
    moved, alpha, alpha_var = 0, 0.0, 0.0
    for s in range(0, K, block):
        x, x1 = A[p[s:s + block], c[s:s + block]], A[p[s:s + block] + 1,
                                                    c[s:s + block]]
        moved += int((x1 != x).any(-1).sum())
        x = x.double()
        b = x.shape[0]
        z = torch.randn((b, Q, d), generator=gen, **f64)
        prop = (x[:, None, :] + z @ L.T).reshape(b * Q, d)
        lp0 = lpost64(torch, x, data, scale, epn)
        lp1 = lpost64(torch, prop, data, scale, epn).reshape(b, Q)
        acc = torch.exp((lp1 - lp0[:, None]).clamp(max=0.0))
        acc = torch.where(torch.isnan(acc), 0.0, acc)
        a = acc.mean(1)
        alpha += float(a.sum())
        alpha_var += float((a * (1.0 - a)).sum()
                           + (acc.var(1) / Q).sum())
    return abs(moved - alpha) / math.sqrt(max(alpha_var, 1e-300))


def prior_z(torch, theta, scale):
    th = theta.double()
    n = th.shape[0]
    zm = th.mean(0) / (scale / math.sqrt(n))
    zv = (th.var(0) / scale ** 2 - 1.0) / math.sqrt(2.0 / n)
    return float(torch.cat([zm, zv]).abs().max())


def _worst(a, b):
    """The larger of a and b, NaN where either is (``max`` would drop a
    NaN in first place); b where a is not read yet (None)."""
    return b if (a is None or b != b or b > a) else a


def _rel(port, ref):
    return float(((port.double() - ref).abs() / (1.0 + ref.abs())).max())


def judge(config, params, inputs, outputs, device):
    """The numbers compared (see the module's docstring)."""
    import torch

    scale, alpha = config["prior_scale"], params["ESSrmin"]
    M, P = outputs["M"], outputs["P"]
    out = dict.fromkeys(("llik_err", "lpost_err", "epn_err", "loglt_err",
                         "rs_count_err", "acc_gap", "move_acc_z",
                         "prior_z"))
    for chk in outputs["checks"]:
        A, B = chk["after"], chk["before"]
        X = A["X"]
        theta = X.theta["beta"]
        llik = loglik64(torch, theta, inputs["data"])
        lprior = lprior64(torch, theta, scale)
        epn_a = float(A["exponent"])
        epn_b = 0.0 if B is None else float(B["exponent"])
        out["llik_err"] = _worst(out["llik_err"], _rel(X.llik, llik))
        out["lpost_err"] = _worst(out["lpost_err"],
                                  _rel(X.lpost, lprior + epn_a * llik))
        ref = next_exponent(torch, epn_b, llik, alpha)
        out["epn_err"] = _worst(out["epn_err"], abs(epn_a - ref)
                                / max(ref - epn_b, 1e-300))
        inc = torch.logsumexp((epn_a - epn_b) * llik, 0) - math.log(
            llik.shape[0])
        out["loglt_err"] = _worst(out["loglt_err"],
                                  abs(float(A["loglt"]) - float(inc)))
        if B is None:
            out["prior_z"] = _worst(out["prior_z"],
                                    prior_z(torch, theta, scale))
            continue
        out["rs_count_err"] = _worst(out["rs_count_err"], count_err(
            torch, B["X"].theta["beta"], B["lw"], theta[:M]))
        out["acc_gap"] = _worst(out["acc_gap"],
                                acc_gap(torch, theta, P, A["acc_rate"]))
        out["move_acc_z"] = _worst(out["move_acc_z"], move_acc_z(
            torch, theta, B["X"].theta["beta"], B["lw"], epn_b,
            inputs["data"], scale, P, outputs["seed"] + 1000 * chk["run"]
            + chk["t"]))
    # a number no kept step could give is missing, and fails its limit
    return {k: v for k, v in out.items() if v is not None}


def control_engine(config, inputs, device):
    """The control: TF32 matrix products switched on for the rest of the
    process, so the program's likelihood runs in TF32 (10-bit mantissas);
    the program itself runs (None).  On the CPU there is no TF32."""
    import torch

    if device.type != "cuda":
        raise ValueError("smcbench: TF32 exists on the card only")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    return None
