#!/usr/bin/env python3
"""Where the time of a sampler step goes, at ``chip_smoke.py`` phase 16's
shape (waste-free adaptive tempering, Pima logistic regression, M = 2^14
starting points, P = 64, N0 = 2^20), on one CUDA card.

Run from the repository root::

    python3 tools/profile_torch_samplers.py [--seed S] [--model Pima|Sonar]
        [--steps K]

Steps ``SMC(AdaptiveTempering(model, len_chain=P), N=M, seed=S)`` past
its first resample-move step, then reads the next K steps (all of the
same form: calibrate, resample, move, the exponent's bisection and the
path sampling) from a ``torch.profiler`` window: device ms a step, by
CUDA kernel, and CUDA kernels a step; then times K more steps (wall ms a
step, the clock stopped after the device) and gives the busy share,
device over wall.  A window whose every try drops kernels is None (not
measured).  Prints the card's name and power limit, then one JSON line.
``chip_smoke.py`` phase 16 runs it in a fresh process (after many
profiler windows in one process, the profiler drops kernels).
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_sampler(torch, dev, seed, model_name, steps):
    """The readings above, as a dict."""
    import chip_smoke as cs
    from particles_tpu_torch import _build
    from particles_tpu_torch import smc_samplers as ssp
    from particles_tpu_torch.core import SMC

    _build.build()
    model, _ = cs.logistic_model(torch, dev, model_name)
    pf = SMC(fk=ssp.AdaptiveTempering(model=model, len_chain=cs.P_SAMPLER),
             N=cs.N_SAMPLER, seed=seed)
    next(pf)
    next(pf)
    out = {"model": model_name, "M": cs.N_SAMPLER, "P": cs.P_SAMPLER,
           "N0": pf.X.N, "seed": seed, "first_step": pf.t, "steps": steps}
    try:
        by_kernel, per_step = cs._device_window(torch, lambda: next(pf),
                                                steps)
        device_ms = sum(by_kernel.values())
    except AssertionError as err:
        print(f"{err}; not measured", file=sys.stderr, flush=True)
        by_kernel = per_step = device_ms = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        next(pf)
    torch.cuda.synchronize()
    wall_ms = 1000.0 * (time.perf_counter() - t0) / steps
    out.update(
        step_device_ms=device_ms, cuda_kernels_per_step=per_step,
        step_wall_ms=wall_ms,
        busy_share=None if device_ms is None else device_ms / wall_ms,
        exponent_after=float(pf.X.shared["exponent"]),
        largest_kernels_ms_per_step=None if by_kernel is None else
        dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]))
    return out


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=16)
    parser.add_argument("--model", default="Pima", choices=["Pima", "Sonar"])
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_samplers: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = profile_sampler(torch, torch.device("cuda", 0), args.seed,
                          args.model, args.steps)
    print(json.dumps({"nvidia_smi": smi, **out}), flush=True)


if __name__ == "__main__":
    main()
