#!/usr/bin/env python3
"""The PyTorch port's main path with its CUDA kernels and with their
plain versions, on one CUDA card.

Run from the repository root::

    python3 tools/profile_torch_main_path.py

The main path is the bootstrap filter of ``chip_smoke.py``: LinearGauss
(rho=0.9, sigmaX=1, sigmaY=0.2), N=2^20, T=1000, systematic resampling.
Wall time of a whole run with the CUDA kernels (B1, B2), and with both
kernels' plain PyTorch versions swapped in, in turns (kernel, plain,
plain, kernel), so that the two are compared on one card in one process.
Where a step's time goes is read from a ``torch.profiler`` window with the
program's ``particles.*`` spans (``particles_tpu_torch.tracing``).

Prints one JSON line with the card's name and power limit.
"""

import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N, T = 2 ** 20, 1000


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_main_path: needs a CUDA card")
    import chip_smoke
    from particles_tpu_torch import kalman, ops, tracing
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
        tracing.reset()
        pf = SMC(fk=fk, N=N, seed=seed)
        if use_plain:
            with mock.patch("particles_tpu_torch.ops.repeat_cols",
                            ops.repeat_cols_plain), \
                    mock.patch.object(trs, "systematic_z_fused",
                                      ops.systematic_z_plain):
                pf.run()
        else:
            pf.run()
        launched = tracing.counts().get("launch.systematic_z", 0)
        assert (launched == 0) == use_plain, (use_plain, launched)
        return pf.cpu_time, float(pf.logLt)

    run(0, False)   # warm-up: kernel build and load, allocator
    run(0, True)
    walls = {"kernel": [], "plain": []}
    for k, use_plain in enumerate((False, True, True, False)):
        wall, logLt = run(k + 1, use_plain)
        assert np.isfinite(logLt)
        walls["plain" if use_plain else "kernel"].append(wall)
    print(json.dumps({
        "nvidia_smi": smi, "N": N, "T": T,
        "wall_s": walls,
        "ms_per_step": {k: 1000 * min(v) / T for k, v in walls.items()},
        "order": "kernel, plain, plain, kernel"}), flush=True)


if __name__ == "__main__":
    main()
