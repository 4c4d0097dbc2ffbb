#!/usr/bin/env python3
"""Device time of the PyTorch port's kernels, and of a resampling step by
scheme, on one CUDA card, for the copy of ``particles_tpu_torch`` that is
first on the path.

Run from the repository root::

    python3 tools/profile_torch_kernels.py
    PYTHONPATH=<another checkout> python3 tools/profile_torch_kernels.py

The second form measures another checkout's package (for example the
parent commit's, unpacked with ``git archive``) with this script, so that
two versions are compared on one card in one call, in turns.

1. Each kernel at N = 2^20 on ``chip_smoke.py`` phase 10's inputs (B2 also
   as the filter calls it, one f32 column, B4 also on sorted uniforms, and
   B4 and B5 also on the CDF of degenerate weights), and the PyTorch call
   that computes the same function where there is one: ms a call back to back (``chip_smoke.py``'s
   CUDA-event timer, median of 25 batches of 10 calls), device ms a call
   and CUDA kernels a call, from a ``torch.profiler`` window of 20 calls,
   and host us a call, the time to enqueue 100 calls back to back (fewer
   launches than the stream's queue holds, so the host never waits on the
   device).
2. The bootstrap filter of ``chip_smoke.py`` phase 4 (N = 2^20; its
   weights degenerate, so every step resamples) with each scheme that
   runs kernels B1 to B5: wall ms a step of a warm unprofiled window of 50
   steps, then device ms a step of a profiled window of 50, in all and by
   CUDA kernel.

Prints one JSON line per part, with the card's name and power limit and
the measured package's path.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)   # after PYTHONPATH, which may name another checkout

N = 2 ** 20
STEPS = 50
SCHEMES = ["systematic", "stratified", "multinomial", "residual", "killing"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_us(torch, fn, calls=100):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_kernels: needs a CUDA card")
    import particles_tpu_torch
    from particles_tpu_torch import kalman, ops
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.core import SMC

    cs_mod = _chip_smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    head = {"nvidia_smi": smi,
            "package": os.path.dirname(particles_tpu_torch.__file__)}
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    W = torch.from_numpy(cs_mod._dirichlet_like(rng, "dirichlet1", N)).to(dev)
    W_deg = torch.from_numpy(
        cs_mod._dirichlet_like(rng, "degenerate", N)).to(dev)
    u = torch.tensor(0.37, dtype=torch.float32, device=dev)
    z = ops.systematic_z_fused(W, u, N)
    z_deg = ops.systematic_z_fused(W_deg, u, N)
    x = torch.randn(N, device=dev)
    cs = ops.normalised_cumsum_exact(W)
    cs_deg = ops.normalised_cumsum_exact(W_deg)
    cs1 = cs.clone()
    cs1[-1:].fill_(1.0)
    uu = torch.rand(N, device=dev)
    su = uu.sort().values
    zi = torch.randint(-2 ** 31, 2 ** 31 - 1, (N,), device=dev,
                       dtype=torch.int32)
    j = torch.arange(N, dtype=torch.int32, device=dev)
    calls = {
        "systematic_z": lambda: ops.systematic_z_fused(W, u, N),
        "repeat_by_z": lambda: ops.ancestors_by_z(z, N),
        "repeat_by_z_one_f32_column": lambda: ops.repeat_cols(z, N, [x]),
        "repeat_by_z_one_f32_column_degenerate":
            lambda: ops.repeat_cols(z_deg, N, [x]),
        "normalised_cumsum": lambda: ops.normalised_cumsum_exact(W),
        "repeat_by_su": lambda: ops.ancestors_by_su(uu, cs1),
        "repeat_by_su_sorted": lambda: ops.ancestors_by_su(su, cs1),
        "repeat_by_su_degenerate": lambda: ops.ancestors_by_su(uu, cs_deg),
        "merge_rank_counts": lambda: ops.merge_rank_counts(su, cs, N),
        "merge_rank_counts_degenerate":
            lambda: ops.merge_rank_counts(su, cs_deg, N),
        "running_max": lambda: ops.running_max(zi),
        "library:searchsorted(z, j, right=True)":
            lambda: torch.searchsorted(z, j, right=True),
        "library:cumsum(W)": lambda: torch.cumsum(W, 0),
        "library:searchsorted(cs, u)": lambda: torch.searchsorted(cs1, uu),
        "library:searchsorted(cs, u_sorted)":
            lambda: torch.searchsorted(cs1, su),
        "library:searchsorted(cs_degenerate, u)":
            lambda: torch.searchsorted(cs_deg, uu),
        "library:searchsorted(su, cs, right=True)":
            lambda: torch.searchsorted(su, cs, right=True),
        "library:searchsorted(su, cs_degenerate, right=True)":
            lambda: torch.searchsorted(su, cs_deg, right=True),
    }
    kernels = {}
    for name, fn in calls.items():
        by_kernel, per_call = cs_mod._device_window(torch, fn, 20)
        kernels[name] = {"ms": cs_mod._time_ms(torch, fn),
                         "device_ms": sum(by_kernel.values()),
                         "launches_per_call": per_call,
                         "host_us": _host_us(torch, fn)}
    print(json.dumps({"part": "kernels", **head, "N": N,
                      "kernels": kernels}), flush=True)

    T = 20 + STEPS + 5 * (STEPS - 1)   # room for retaken profiler windows
    y = torch.from_numpy(cs_mod._simulate_y(T)).to(dev)
    fk = ssms.Bootstrap(ssm=kalman.LinearGauss(rho=cs_mod.RHO,
                                               sigmaX=cs_mod.SIGX,
                                               sigmaY=cs_mod.SIGY), data=y)
    steps = {}
    for scheme in SCHEMES:
        pf = SMC(fk=fk, N=N, resampling=scheme, seed=0)
        for _ in range(20):
            next(pf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            next(pf)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / STEPS
        by_kernel, _ = cs_mod._device_window(torch, lambda pf=pf: next(pf),
                                             STEPS - 1)
        steps[scheme] = {
            "wall_ms_per_step": 1000.0 * wall,
            "device_ms_per_step": sum(by_kernel.values()),
            "device_ms_per_step_by_kernel": dict(sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:12])}
    print(json.dumps({"part": "steps", **head, "N": N, "steps": STEPS,
                      "schemes": steps}), flush=True)


if __name__ == "__main__":
    main()
