#!/usr/bin/env python3
"""Wall time of the rejection samplers of ``chip_smoke.py`` phases 12 and
13 (FFBS reject and PaRIS, at N = 2^17, T = 128, 32 rounds at most), with
their B3 and B4 launches, for the copy of ``particles_tpu_torch`` that is
first on the path.

Run from the repository root, on a CUDA card::

    python3 tools/time_smoothers.py
    PYTHONPATH=<another checkout> python3 tools/time_smoothers.py

The second form measures another checkout's package with this script, so
that two versions are compared on one card in one call, in turns.  Each
of ``--repeats`` rounds runs the backward pass on one forward history and
a PaRIS filter, after a warm-up of both; wall ms a backward step and a
filter step, the clock stopped after the device finishes.  Prints one
JSON line with the card's name and power limit and the package's path.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)   # after PYTHONPATH, which may name another checkout

import torch  # noqa: E402

import particles_tpu_torch  # noqa: E402
from chip_smoke import (N_SMOOTH, REJECT_TRIALS, T_SMOOTH,  # noqa: E402
                        _lg_smooth, _simulate_y)
from particles_tpu_torch import SMC, collectors, kalman, tracing  # noqa: E402
from particles_tpu_torch import state_space_models as ssms  # noqa: E402


def _counts():
    counts = tracing.counts()
    return {k: counts.get("launch." + k, 0)
            for k in ("normalised_cumsum", "repeat_by_su")}


def _timed(fn):
    torch.cuda.synchronize()
    before = _counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = 1000.0 * (time.perf_counter() - t0)
    return out, ms, {k: n - before[k] for k, n in _counts().items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    y = torch.from_numpy(_simulate_y(T_SMOOTH)).to(dev)
    fk = ssms.Bootstrap(ssm=_lg_smooth(kalman), data=y)
    steps = T_SMOOTH - 1
    pf = SMC(fk=fk, N=N_SMOOTH, seed=21, store_history=True)
    pf.run()

    def reject(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return pf.hist.backward_sampling_reject(gen, N_SMOOTH,
                                                max_trials=REJECT_TRIALS)

    def paris(seed):
        col = collectors.Paris(Nparis=2, max_trials=REJECT_TRIALS)
        p = SMC(fk=fk, N=N_SMOOTH, seed=seed, collect=[col])
        p.run()
        return col

    reject(0)
    paris(0)                                    # warm-up
    rounds = []
    for r in range(args.repeats):
        _, ms, launched = _timed(lambda: reject(5 + r))
        rounds.append({"ffbs_reject_ms_per_backward_step": ms / steps,
                       "ffbs_reject_rounds": sum(pf.hist.rounds),
                       "ffbs_reject_launches": launched})
        col, ms, launched = _timed(lambda: paris(32 + r))
        rounds[-1].update({"paris_ms_per_step": ms / T_SMOOTH,
                           "paris_rounds": sum(col.rounds),
                           "paris_launches": launched})
    print(json.dumps({"nvidia_smi": smi, "N": N_SMOOTH, "T": T_SMOOTH,
                      "max_trials": REJECT_TRIALS,
                      "package": os.path.dirname(particles_tpu_torch.__file__),
                      "runs": rounds}), flush=True)


if __name__ == "__main__":
    main()
