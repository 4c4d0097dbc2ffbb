#!/usr/bin/env python3
"""The port's and the JAX package's ``Fixed_lag_smooth`` on one history
(ROADMAP C.9): is the fixed-lag smoother's offset from the Kalman target
a fault of the port, or the estimator's own?

On the card, the port alone (this mode imports no JAX)::

    python3 tools/fixed_lag_check.py --save DIR [--seed 1000] [--t 864]

runs the filter as ``tools/smoothing_error_scale.py`` runs it (phase 11's
model, data and N, its first seed), stops after step t, and writes to
``DIR/fixed_lag_window.npz`` the window the smoother reads at t: the
frames t - LAG .. t of X and of the ancestors, the log-weights at t, and
the port's own estimate at t (the collector's record).  Then, where the
JAX package is installed::

    python3 tools/fixed_lag_check.py --compare DIR

rebuilds that window as a history of each package
(``convert.history_from_numpy`` for the port), applies each package's
``Fixed_lag_smooth.step`` to it, and prints both estimates, their
difference, the exact target ``F[t]`` (``chip_smoke.kalman_targets``) and
each error in units of one run's sd at t (``SMOOTH_SD["fixed_lag"]`` sd_t
/ sqrt(N)).
"""

import argparse
import json
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from chip_smoke import (LAG, N_MAIN, RHO, SIGX, SIGY, SMOOTH_SD,  # noqa: E402
                        T_MAIN, _simulate_y, kalman_targets)

WINDOW = "fixed_lag_window.npz"


def save(out_dir, seed, t_end, device):
    import torch

    from particles_tpu_torch import SMC, collectors, kalman
    from particles_tpu_torch import state_space_models as ssms

    class LGsmooth(kalman.LinearGauss):
        def add_func(self, t, xp, x):
            return x

    fk = ssms.Bootstrap(ssm=LGsmooth(rho=RHO, sigmaX=SIGX, sigmaY=SIGY),
                        data=_simulate_y(T_MAIN), device=device)
    pf = SMC(fk=fk, N=N_MAIN, seed=seed, store_history=LAG + 1,
             collect=[collectors.Fixed_lag_smooth(lag=LAG)])
    while pf.t <= t_end:
        next(pf)
    h = pf.hist
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(out_dir, WINDOW),
        X=torch.stack(list(h.X)).cpu().numpy(),
        A=torch.stack(list(h.A)).to(torch.int32).cpu().numpy(),
        lw=h.wgts[-1].lw.cpu().numpy(),
        port_record=float(pf.summaries.fixed_lag_smooths[t_end]),
        seed=seed, t=t_end)
    print(json.dumps({"saved": os.path.join(out_dir, WINDOW), "N": N_MAIN,
                      "t": t_end, "seed": seed,
                      "port_record": float(
                          pf.summaries.fixed_lag_smooths[t_end])}))


def compare(out_dir):
    import jax.numpy as jnp
    import torch

    from particles_tpu import collectors as jcol
    from particles_tpu import resampling as jrs
    from particles_tpu_torch import collectors as tcol
    from particles_tpu_torch import convert, kalman
    from particles_tpu_torch import resampling as trs
    from particles_tpu_torch import state_space_models as ssms

    d = np.load(os.path.join(out_dir, WINDOW))
    X, A, lw, t = d["X"], d["A"], d["lw"], int(d["t"])
    N = X.shape[1]
    k = LAG + 1
    assert X.shape[0] == k
    fk = ssms.Bootstrap(ssm=kalman.LinearGauss(rho=RHO, sigmaX=SIGX,
                                               sigmaY=SIGY),
                        data=_simulate_y(T_MAIN), device="cpu")
    lw_hist = np.zeros(X.shape, np.float32)
    lw_hist[-1] = lw
    hist = convert.history_from_numpy(fk, X, A.astype(np.int64), lw_hist,
                                      device="cpu")
    # each package's step at t, on the window: the state holds the frames
    # before t (its oldest, dropped by the step, is a placeholder)
    view = types.SimpleNamespace(X=hist.X[-1], A=hist.A[-1],
                                 wgts=trs.Weights(hist.lw[-1]), N=N)
    frames = [hist.X[0]] + list(hist.X[:-1])
    ancs = [hist.A[0]] + list(hist.A[:-1])
    _, port = tcol.Fixed_lag_smooth(lag=LAG).step(
        view, (tuple(frames), tuple(ancs)))
    jview = types.SimpleNamespace(X=jnp.asarray(X[-1]), A=jnp.asarray(A[-1]),
                                  wgts=jrs.Weights(jnp.asarray(lw)), N=N)
    jstate = (jnp.asarray(np.concatenate([X[:1], X[:-1]])),
              jnp.asarray(np.concatenate([A[:1], A[:-1]])))
    _, jx = jcol.Fixed_lag_smooth(lag=LAG).step(jview, jstate)
    tg = kalman_targets(_simulate_y(T_MAIN), LAG)
    sd = SMOOTH_SD["fixed_lag"] * np.sqrt(tg["var"][t]) / np.sqrt(N)
    port, jx = float(port), float(np.asarray(jx))
    print(json.dumps({
        "t": t, "N": N, "seed": int(d["seed"]),
        "port_record_in_run": float(d["port_record"]),
        "port_on_window": port, "jax_on_window": jx,
        "port_minus_jax": port - jx, "exact_F_t": float(tg["F"][t]),
        "one_run_sd": float(sd),
        "port_err_in_sd": (port - tg["F"][t]) / sd,
        "jax_err_in_sd": (jx - tg["F"][t]) / sd}, indent=1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save", metavar="DIR")
    ap.add_argument("--compare", metavar="DIR")
    ap.add_argument("--seed", type=int, default=1000)
    ap.add_argument("--t", type=int, default=864)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.save:
        save(args.save, args.seed, args.t, args.device)
    if args.compare:
        compare(args.compare)


if __name__ == "__main__":
    main()
