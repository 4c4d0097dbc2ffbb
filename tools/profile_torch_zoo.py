#!/usr/bin/env python3
"""Where the time of a step goes on the guided and auxiliary filters and
the Gaussian HMM, at ``chip_smoke.py`` phase 14's shapes, on one CUDA card.

Run from the repository root::

    python3 tools/profile_torch_zoo.py [--runs NAME,...] [--steps K]

Runs (N = 2^20 each; phase 14's models, data and ESSrmin):
``lg_guided``, ``lg_aux``, ``lg_auxboot`` (``GuidedPF``, ``AuxiliaryPF``,
``AuxiliaryBootstrap`` on the main path's LinearGauss), ``lg_boot`` (the
main path itself, for comparison), ``hmm`` (``Bootstrap`` on the
three-state Gaussian HMM), ``sv_boot``, ``sv_aux``, ``sv_auxboot``
(StochVol, always resampling).

For each: the filter stepped to its middle, then K steps timed without
the profiler (wall ms a step, the clock stopped after the device), then
a ``torch.profiler`` window of K more steps: device ms a step by CUDA
kernel (the largest eight, and the rest), the device's busy share of the
unprofiled wall, and the resampling steps in the window.  Prints one JSON
line per run, with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUNS = ("lg_boot", "lg_guided", "lg_aux", "lg_auxboot", "hmm", "sv_boot",
        "sv_aux", "sv_auxboot")
N = 2 ** 20


def _build(name, torch, dev):
    """(fk, T, ESSrmin) of run ``name``, as phase 14 builds it."""
    import chip_smoke as cs
    from particles_tpu_torch import hmm, kalman
    from particles_tpu_torch import state_space_models as ssms

    if name.startswith("lg_"):
        cls = {"lg_boot": "Bootstrap", "lg_guided": "GuidedPF",
               "lg_aux": "AuxiliaryPF", "lg_auxboot": "AuxiliaryBootstrap"}
        ssm = kalman.LinearGauss(rho=cs.RHO, sigmaX=cs.SIGX, sigmaY=cs.SIGY)
        y = torch.from_numpy(cs._simulate_y(cs.T_MAIN)).to(dev)
        return getattr(ssms, cls[name])(ssm=ssm, data=y), cs.T_MAIN, 0.5
    if name == "hmm":
        model = hmm.GaussianHMM(**{k: torch.tensor(v, device=dev)
                                   for k, v in cs.HMM_PARAMS.items()})
        y = torch.from_numpy(cs._simulate_hmm(cs.T_MAIN)).to(dev)
        return ssms.Bootstrap(ssm=model, data=y), cs.T_MAIN, 0.5
    cls = {"sv_boot": "Bootstrap", "sv_aux": "AuxiliaryPF",
           "sv_auxboot": "AuxiliaryBootstrap"}[name]
    y = torch.from_numpy(cs._simulate_sv(cs.T_SV)).to(dev)
    return getattr(ssms, cls)(ssm=ssms.StochVol(), data=y), cs.T_SV, 1.1


def profile_run(name, torch, dev, K, smi):
    """Run ``name``'s timed steps and profiler window; its JSON record."""
    from torch.profiler import ProfilerActivity, profile

    from particles_tpu_torch.core import SMC

    fk, T, ESSrmin = _build(name, torch, dev)
    if 2 * K + 2 > T:
        sys.exit(f"profile_torch_zoo: --steps {K} too many for T = {T}")
    pf = SMC(fk=fk, N=N, seed=0, ESSrmin=ESSrmin)
    while pf.t < T - 2 * K:
        next(pf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(K):
        next(pf)
    torch.cuda.synchronize()
    wall = 1000.0 * (time.perf_counter() - t0) / K
    rs0 = sum(bool(f) for f in pf.summaries.rs_flags)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(K):
            next(pf)
        torch.cuda.synchronize()
    rs_window = sum(bool(f) for f in pf.summaries.rs_flags) - rs0
    by_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            key = evt.key[:80]
            by_kernel[key] = (by_kernel.get(key, 0.0)
                              + evt.self_device_time_total / 1000.0 / K)
    device = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"run": name, "nvidia_smi": smi, "N": N, "steps": K,
            "resampling_steps_in_window": rs_window,
            "wall_ms_per_step": wall, "device_ms_per_step": device,
            "device_busy_share": device / wall,
            "largest_kernels_ms_per_step": dict(top),
            "other_kernels_ms_per_step": device - sum(v for _, v in top),
            "cuda_kernels": len(by_kernel)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_zoo: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    for name in args.runs.split(","):
        print(json.dumps(profile_run(name, torch, dev, args.steps, smi)),
              flush=True)


if __name__ == "__main__":
    main()
