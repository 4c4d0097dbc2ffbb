#!/usr/bin/env python3
"""The sd of each smoother that ``chip_smoke.py`` phases 11-13 hold to the
Kalman smoother, from the spread of its estimate over seeds.

Each estimator runs as the phase runs it, at the phase's N and T, once per
seed (``--seeds`` of them: 1000, 1010, 1020, ..., which with the 0 to 5
added for a seed's runs are seeds the phases do not use).
At each t, the sd over the seeds of the estimate is put in units of
``scale_t / sqrt(N)``: ``scale_t`` is the exact smoothing sd at t (the
fixed-lag, FFBS and two-filter estimates of a mean), or the mean smoothing
sd times ``sqrt(t + 1)`` (the on-line smoothers, whose target at t is a sum
of t + 1 means).  For each estimator it prints the largest of these over t
(``sd``, the value ``SMOOTH_SD`` in ``chip_smoke.py`` takes, rounded up to
a tenth), their median, and how far the mean over the seeds lies from the
exact target, in standard errors of that mean (``bias_z``: the largest over
t, and the share of times above 3), which the sd does not depend on.  On
the card::

    python3 tools/smoothing_error_scale.py --seeds 20 --out DIR

The exact targets (``kalman_targets``) are float64 numpy, the same as in
``chip_smoke.py``.  ``--scale`` divides every N (a quick look on the CPU;
the sd then belongs to the smaller N).
"""

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from chip_smoke import (HIST_WINDOW, LAG, N_MAIN, N_QUAD,  # noqa: E402
                        N_SMOOTH, REJECT_TRIALS, RHO, SIGX, SIGY, T_MAIN,
                        T_SMOOTH, _simulate_y, kalman_targets)
from particles_tpu_torch import SMC, collectors, kalman  # noqa: E402
from particles_tpu_torch import state_space_models as ssms  # noqa: E402


class LGsmooth(kalman.LinearGauss):
    """The phases' model: the additive function is x_t."""

    def add_func(self, t, xp, x):
        return x


def _fk(y, device):
    return ssms.Bootstrap(ssm=LGsmooth(rho=RHO, sigmaX=SIGX, sigmaY=SIGY),
                          data=y, device=device)


def _runs(seed, dev, n_main, n_smooth, n_quad):
    """{estimator: (estimate over t, N)} of one seed, as the phases run
    them."""
    out = {}
    y1 = _simulate_y(T_MAIN)
    pf = SMC(fk=_fk(y1, dev), N=n_main, seed=seed,
             store_history=HIST_WINDOW,
             collect=[collectors.Fixed_lag_smooth(lag=LAG),
                      collectors.Online_smooth_naive()])
    pf.run()
    out["fixed_lag"] = (pf.summaries.fixed_lag_smooths, n_main)
    out["online_naive"] = (pf.summaries.online_smooth_naives, n_main)

    y2 = _simulate_y(T_SMOOTH)
    fk = _fk(y2, dev)
    loggamma = fk.ssm.PX0().logpdf
    gen = torch.Generator(device=fk.data.device).manual_seed(seed)

    def forward(N, s, data=y2):
        p = SMC(fk=_fk(data, dev), N=N, seed=s, store_history=True)
        p.run()
        return p

    steps = T_SMOOTH - 1
    pf, info = forward(n_smooth, seed), forward(n_smooth, seed + 1,
                                                y2[::-1].copy())
    out["ffbs_mcmc"] = (pf.hist.backward_sampling_mcmc(
        gen, n_smooth, nsteps=1).mean(1), n_smooth)
    out["ffbs_reject"] = (pf.hist.backward_sampling_reject(
        gen, n_smooth, max_trials=REJECT_TRIALS).mean(1), n_smooth)
    out["two_filter_ON"] = (torch.stack([pf.hist.two_filter_smoothing(
        t, info, lambda x, xf: x, loggamma, linear_cost=True, gen=gen)
        for t in range(steps)]), n_smooth)
    pfq, infoq = forward(n_quad, seed + 2), forward(n_quad, seed + 3,
                                                    y2[::-1].copy())
    out["ffbs_ON2"] = (pfq.hist.backward_sampling_ON2(gen, n_quad).mean(1),
                       n_quad)
    out["two_filter_ON2"] = (torch.stack([pfq.hist.two_filter_smoothing(
        t, infoq, lambda x, xf: x, loggamma) for t in range(steps)]), n_quad)
    p = SMC(fk=fk, N=n_smooth, seed=seed + 4,
            collect=[collectors.Paris(Nparis=2, max_trials=REJECT_TRIALS)])
    p.run()
    out["paris"] = (p.summaries.paris, n_smooth)
    p = SMC(fk=fk, N=n_quad, seed=seed + 5,
            collect=[collectors.Online_smooth_ON2()])
    p.run()
    out["online_ON2"] = (p.summaries.online_smooth_ON2s, n_quad)
    return {k: (v.double().cpu().numpy(), N) for k, (v, N) in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every N by this")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="directory for the per-t sd (JSON)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    tg1 = kalman_targets(_simulate_y(T_MAIN), LAG)
    tg2 = kalman_targets(_simulate_y(T_SMOOTH), LAG)
    sd1, sd2 = np.sqrt(tg1["var"]), np.sqrt(tg2["var"])
    exact = {
        "fixed_lag": (tg1["F"], sd1),
        "online_naive": (tg1["S"], sd1.mean()
                         * np.sqrt(np.arange(1, T_MAIN + 1))),
        "paris": (tg2["S"], sd2.mean() * np.sqrt(np.arange(1, T_SMOOTH + 1))),
        "online_ON2": (tg2["S"], sd2.mean()
                       * np.sqrt(np.arange(1, T_SMOOTH + 1))),
        "ffbs_mcmc": (tg2["mean"], sd2), "ffbs_reject": (tg2["mean"], sd2),
        "ffbs_ON2": (tg2["mean"], sd2),
        "two_filter_ON": (tg2["mean"][:-1], sd2[:-1]),
        "two_filter_ON2": (tg2["mean"][:-1], sd2[:-1]),
    }
    ests, Ns = {}, {}
    tic = time.perf_counter()
    for s in range(args.seeds):
        for k, (v, N) in _runs(1000 + 10 * s, dev, N_MAIN // args.scale,
                               N_SMOOTH // args.scale,
                               N_QUAD // args.scale).items():
            ests.setdefault(k, []).append(v)
            Ns[k] = N
        print(f"seed {s + 1} of {args.seeds}: "
              f"{time.perf_counter() - tic:.1f} s", file=sys.stderr,
              flush=True)
    summary, per_t = {}, {}
    for k, vals in ests.items():
        E = np.stack(vals)                       # (seeds, T)
        target, scale = exact[k]
        sd_t = E.std(0, ddof=1)
        c_t = sd_t * np.sqrt(Ns[k]) / scale
        z_t = (E.mean(0) - target) / (sd_t / np.sqrt(len(vals)))
        summary[k] = {"N": Ns[k], "seeds": len(vals),
                      "sd": math.ceil(10 * c_t.max()) / 10,
                      "sd_max_over_t": float(c_t.max()),
                      "sd_median_over_t": float(np.median(c_t)),
                      "bias_z_max": float(np.abs(z_t).max()),
                      "bias_z_share_above_3": float(np.mean(np.abs(z_t) > 3))}
        per_t[k] = {"sd": c_t.tolist(), "bias_z": z_t.tolist()}
    print(json.dumps({"sd_in_scale_over_sqrt_N": summary}))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "smoothing_sd_per_t.json"),
                  "w") as f:
            json.dump({"summary": summary, "per_t": per_t}, f)


if __name__ == "__main__":
    main()
