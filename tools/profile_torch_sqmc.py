#!/usr/bin/env python3
"""Where the time of an SQMC step goes, at ``chip_smoke.py`` phase 15's
shape (LinearGauss, N = 2^20, the main path's data), on one CUDA card.

Run from the repository root::

    python3 tools/profile_torch_sqmc.py [--seed S]

Steps ``SQMC(fk, N=2^20, seed=S)`` to T/2, keeping the weights, the
particles and the sorted Sobol points of step T/2, then reads, each from
a ``torch.profiler`` window of 20 calls: B3 on those weights and B4 on
those points with the particles as payload (device ms a call), the next
20 steps (device ms a step, by CUDA kernel, and CUDA kernels a step), and
the step's two eager pieces alone, the sorted Sobol draw of 2 columns and
the Hilbert sort of (N, 2) particles (device ms, CUDA kernels, and ms a
call back to back).  A reading whose every window drops kernels is None
(not measured).  Prints the card's name and power limit, then one JSON
line.  ``chip_smoke.py`` phase 15 runs it in a fresh process: in a
process that has opened many profiler windows before, the profiler drops
kernels.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_sqmc(torch, dev, seed):
    """The readings above, as a dict."""
    import chip_smoke as cs
    from particles_tpu_torch import _build, hilbert, kalman, ops, rqmc
    from particles_tpu_torch import resampling as rs
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.core import SQMC

    _build.build()
    ssm = kalman.LinearGauss(rho=cs.RHO, sigmaX=cs.SIGX, sigmaY=cs.SIGY)
    fk = ssms.Bootstrap(ssm=ssm, data=torch.from_numpy(
        cs._simulate_y(cs.T_MAIN)).to(dev))
    N, t_mid = cs.N_MAIN, cs.T_MAIN // 2
    pf = SQMC(fk=fk, N=N, seed=seed)
    kept, draw = {}, rqmc.sobol_sorted0

    def keeping_draw(*args, **kwargs):
        kept["points"] = out = draw(*args, **kwargs)
        return out

    while pf.t < t_mid:
        next(pf)
    X = pf.X
    rqmc.sobol_sorted0 = keeping_draw
    try:
        next(pf)
    finally:
        rqmc.sobol_sorted0 = draw
    W = rs.exp_and_normalise(pf.aux.lw)
    su = kept["points"][:, 0].contiguous()
    cs_pinned = rs.pinned_cdf(W)

    def profiled(fn):
        try:
            by_kernel, per_call = cs._device_window(torch, fn, 20)
        except AssertionError as err:
            print(f"{err}; not measured", file=sys.stderr, flush=True)
            return None, None, None
        return sum(by_kernel.values()), per_call, by_kernel

    out = {"N": N, "seed": seed, "t": t_mid,
           "normalised_cumsum_device_ms": profiled(
               lambda: ops.normalised_cumsum_exact(W))[0],
           "repeat_by_su_sorted_device_ms": profiled(
               lambda: ops.repeat_cols_su(su, cs_pinned, N, [X]))[0]}
    device_ms, per_step, by_kernel = profiled(lambda: next(pf))
    out.update(step_device_ms=device_ms, cuda_kernels_per_step=per_step,
               largest_kernels_ms_per_step=None if by_kernel is None else
               dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x2 = torch.randn(N, 2, device=dev)
    for name, fn in (("sobol_sorted0 d=2", lambda: rqmc.sobol_sorted0(gen, N,
                                                                      2)),
                     ("hilbert_sort d=2", lambda: hilbert.hilbert_sort(x2))):
        piece_ms, piece_kernels, _ = profiled(fn)
        out[name] = {"ms": cs._time_ms(torch, fn, batches=5),
                     "device_ms": piece_ms, "cuda_kernels": piece_kernels}
    return out


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=17)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_sqmc: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = profile_sqmc(torch, torch.device("cuda", 0), args.seed)
    print(json.dumps({"nvidia_smi": smi, **out}), flush=True)


if __name__ == "__main__":
    main()
