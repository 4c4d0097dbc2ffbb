"""The plain reference of the scalar linear Gaussian model: a float64
Kalman filter in NumPy, and the judgement of a filter's outputs against it.

It imports nothing of the program.  The program's outputs are each step's
filtered mean and each run's log-likelihood.  Their errors are measured
in units of the particle filter's own Monte Carlo sd at N particles, which
the Kalman quantities give in closed form: a step's importance sampling
of the filtered law from the predictive one has asymptotic variance
V_t = E[w^2 (x - m_t)^2] / E[w]^2 for the mean and E[w^2] / E[w]^2 - 1
for the log of the mean weight (w the likelihood of y_t, x from the
predictive law), so that a sound filter's errors read about a standard
normal whatever N and whatever the observation.  The numbers compared:

- ``mean_err_med``: the median, over every step of every run, of
  N (m_hat - m)^2 / V_t.  A sound filter reads about 0.45 (a standard
  normal's median square; SQMC far less); half the particles left out
  doubles it;
- ``mean_max_err``: the largest |m_hat - m| sqrt(N / V_t) over those
  steps, which one altered answer moves;
- ``loglik_err``: the largest |logLt - logLt_Kalman| over the runs, over
  the sd sqrt(sum_t (E[w^2] / E[w]^2 - 1) / N) of a run cut after t
  steps.

The control, :class:`KalmanRun`, is this reference computed in bfloat16,
put in the program's place: one step of the Kalman recursion a step.
"""

from __future__ import annotations

import math

import numpy as np


def _phi(x, mean, var):
    return math.exp(-0.5 * (x - mean) ** 2 / var) / math.sqrt(
        2.0 * math.pi * var)


def kalman(y, rho, sigmaX, sigmaY, sigma0=None):
    """Per step of y: (filtered means, filtered variances, cumulative
    log-likelihood, V_t the asymptotic variance of a bootstrap step's
    filtered mean, the asymptotic variance of its log mean weight), each a
    (T,) float64 array, under X_0 ~ N(0, sigma0^2) (stationary by
    default), X_t = rho X_{t-1} + sigmaX U_t, Y_t = X_t + sigmaY V_t."""
    T = len(y)
    if sigma0 is None:
        sigma0 = sigmaX / math.sqrt(1.0 - rho ** 2)
    m, v, ll, vm, vl = (np.empty(T) for _ in range(5))
    mp, vp, tot = 0.0, sigma0 ** 2, 0.0
    sy2 = sigmaY ** 2
    for t in range(T):
        yt = float(y[t])
        s = vp + sy2
        k = vp / s
        r = yt - mp
        tot += -0.5 * (math.log(2.0 * math.pi * s) + r * r / s)
        m[t] = mp + k * r
        v[t] = (1.0 - k) * vp
        ll[t] = tot
        # w(x) = exp(-(y - x)^2 / (2 sy2)) with x ~ N(mp, vp): E[w] and
        # E[w^2 g(x)], w^2 being a Gaussian of x of variance sy2 / 2
        ew = math.sqrt(2.0 * math.pi * sy2) * _phi(yt, mp, s)
        c2 = (2.0 * math.pi * sy2 / math.sqrt(4.0 * math.pi * sy2)
              * _phi(yt, mp, vp + sy2 / 2.0))
        s2 = 1.0 / (1.0 / vp + 2.0 / sy2)
        mu2 = s2 * (mp / vp + 2.0 * yt / sy2)
        vm[t] = c2 * (s2 + (mu2 - m[t]) ** 2) / ew ** 2
        vl[t] = c2 / ew ** 2 - 1.0
        mp, vp = rho * m[t], rho ** 2 * v[t] + sigmaX ** 2
    return m, v, ll, vm, vl


def judge(config, params, inputs, outputs, device):
    """The numbers compared, from every run's outputs (see the module's
    docstring)."""
    m, _, L, vm, vl = kalman(inputs["y"].astype(np.float64), config["rho"],
                             config["sigmaX"], config["sigmaY"])
    N = outputs["N"]
    sd_l = np.sqrt(np.cumsum(vl) / N)
    errs, lls = [], []
    for run in outputs["runs"]:
        t = len(run["means"])
        if t == 0:
            continue
        errs.append((run["means"] - m[:t]) * np.sqrt(N / vm[:t]))
        lls.append(abs(run["logLt"] - L[t - 1]) / sd_l[t - 1])
    if not errs:
        return {}
    e = np.concatenate(errs)
    return {"mean_err_med": float(np.median(e * e)),
            "mean_max_err": float(np.max(np.abs(e))),
            "loglik_err": float(np.max(lls))}


class KalmanRun:
    """The control: the Kalman recursion in ``dtype`` (bfloat16 by
    default), run step by step in the program's place; its filtered means
    and its log-likelihood are what a run of the program would hand in."""

    def __init__(self, y, config, device, dtype=None):
        import torch

        self.torch = torch
        self.dtype = torch.bfloat16 if dtype is None else dtype
        self.y = torch.as_tensor(y, device=device).to(self.dtype)
        self.rho, self.sx, self.sy = (config["rho"], config["sigmaX"],
                                      config["sigmaY"])

        def c(x):
            return torch.tensor(x, dtype=self.dtype, device=device)

        self.c = c
        self.mp = c(0.0)
        self.vp = c(self.sx ** 2 / (1.0 - self.rho ** 2))
        self.tot = c(0.0)
        self.t = 0
        self.rs_flag = True
        self.means = []
        self.inc = None

    def step(self):
        torch, c = self.torch, self.c
        s = self.vp + c(self.sy ** 2)
        k = self.vp / s
        r = self.y[self.t] - self.mp
        self.inc = -0.5 * (torch.log(c(2.0 * math.pi) * s) + r * r / s)
        self.tot = self.tot + self.inc
        m = self.mp + k * r
        v = (c(1.0) - k) * self.vp
        self.means.append(m)
        self.mp, self.vp = c(self.rho) * m, c(self.rho ** 2) * v + c(
            self.sx ** 2)
        self.t += 1

    def read(self):
        return [float(self.means[-1]), float(self.inc)]

    def finish(self):
        torch = self.torch
        if not self.means:
            return torch.zeros(0), torch.zeros(())
        return torch.stack(self.means).float(), self.tot.float()


def control_engine(config, inputs, device):
    """The factory of :class:`KalmanRun` a driver takes as ``engine``."""

    def make(fk, N, seed, params, device):
        return KalmanRun(inputs["y"], config, device)

    return make
