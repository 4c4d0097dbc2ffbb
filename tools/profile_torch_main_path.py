#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one CUDA card.

Run from the repository root::

    python3 tools/profile_torch_main_path.py [--out DIR]

The main path is the bootstrap filter of ``chip_smoke.py``: LinearGauss
(rho=0.9, sigmaX=1, sigmaY=0.2), N=2^20, T=1000, systematic resampling.

1. Wall time of a whole run with the CUDA kernels, and with both kernels'
   plain PyTorch versions swapped in, in turns (kernel, plain, plain,
   kernel), so that the two are compared on one card in one process.
2. A ``torch.profiler`` window of 50 steps: device time per step by
   kernel, and its share of the step's wall time, with the profiler on
   and against part 1's wall time without it.
   With ``--out``, the chrome trace is written there.

Prints one JSON line per part, each with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N, T = 2 ** 20, 1000
WINDOW = 50


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for the chrome trace")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_main_path: needs a CUDA card")
    import chip_smoke
    from particles_tpu_torch import kalman, ops
    from particles_tpu_torch import resampling as trs
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.core import SMC

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    y = chip_smoke._simulate_y(T)
    fk = ssms.Bootstrap(ssm=kalman.LinearGauss(rho=0.9, sigmaX=1.0,
                                                sigmaY=0.2),
                        data=torch.from_numpy(y).to(dev))

    def run(seed, use_plain):
        launches = ops.systematic_z_fused.launches
        pf = SMC(fk=fk, N=N, seed=seed)
        if use_plain:
            with mock.patch("particles_tpu_torch.ops.repeat_cols",
                            ops.repeat_cols_plain), \
                    mock.patch.object(trs, "systematic_z_fused",
                                      ops.systematic_z_plain):
                pf.run()
            assert ops.systematic_z_fused.launches == launches
        else:
            pf.run()
            assert ops.systematic_z_fused.launches > launches
        return pf.cpu_time, float(pf.logLt)

    run(0, False)   # warm-up: kernel build and load, allocator
    run(0, True)
    walls = {"kernel": [], "plain": []}
    for k, use_plain in enumerate((False, True, True, False)):
        wall, logLt = run(k + 1, use_plain)
        assert np.isfinite(logLt)
        walls["plain" if use_plain else "kernel"].append(wall)
    print(json.dumps({
        "part": "end_to_end", "nvidia_smi": smi, "N": N, "T": T,
        "wall_s": walls,
        "ms_per_step": {k: 1000 * min(v) / T for k, v in walls.items()},
        "order": "kernel, plain, plain, kernel"}), flush=True)

    # profiler window over WINDOW steps of a warm run
    from torch.profiler import ProfilerActivity, profile

    pf = SMC(fk=fk, N=N, seed=9)
    for _ in range(100):
        next(pf)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(WINDOW):
            next(pf)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue   # host-side ops; their kernels are listed on their own
        name = evt.key[:140]
        kernels[name] = (kernels.get(name, 0.0)
                         + evt.self_device_time_total / 1000.0 / WINDOW)
    busy = sum(kernels.values())
    unprofiled = 1000 * min(walls["kernel"]) / T
    print(json.dumps({
        "part": "profile", "nvidia_smi": smi, "steps": WINDOW,
        "wall_ms_per_step_profiled": 1000 * wall / WINDOW,
        "device_busy_ms_per_step": busy,
        "device_busy_share_of_profiled_wall": busy / (1000 * wall / WINDOW),
        "device_busy_share_of_unprofiled_wall": busy / unprofiled,
        "device_ms_per_step_by_kernel": dict(
            sorted(kernels.items(), key=lambda kv: -kv[1]))}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out,
                                              "main_path_trace.json"))


if __name__ == "__main__":
    main()
