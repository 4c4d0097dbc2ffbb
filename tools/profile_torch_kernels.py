#!/usr/bin/env python3
"""Device time of the PyTorch port's kernels, and of a resampling step by
scheme, on one CUDA card, for the copy of ``particles_tpu_torch`` that is
first on the path.

Run from the repository root::

    python3 tools/profile_torch_kernels.py
    PYTHONPATH=<another checkout> python3 tools/profile_torch_kernels.py
    python3 tools/profile_torch_kernels.py --schemes systematic \
        --kernels systematic_z,normalised_cumsum,running_max

The second form measures another checkout's package (for example the
parent commit's, unpacked with ``git archive``) with this script, so that
two versions are compared on one card in one call, in turns.  The third
measures only the named calls of part 1 (a library call is named as it
prints, ``library:cumsum(W)``) and the named schemes of part 2 (``none``
skips a part).  ``--hashes`` first prints, for comparing two checkouts bit
for bit, the sha256 of B1's z, B3's cs and B6's y on fixed inputs: N from
1 to 2^24 (B3's chunk edges included), Dirichlet(1), Dirichlet(0.05),
degenerate and one-hot weights, int32 over the whole range.

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

import argparse
import hashlib
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


def _hashes(torch, ops, cs_mod, dev):
    """sha256 (16 hex digits) of B1's z (u = 0.37, M = n), B3's cs and
    B6's y, by size n and input."""
    def digest(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    tile, cache_tiles, max_grid = ops.normalised_cumsum_geometry(dev)
    rng = np.random.default_rng(1)
    out = {}
    for n in (1, 7, 1000, tile + 1, N - 513, N,
              max_grid * tile + 1, max_grid * cache_tiles * tile + 1,
              2 ** 24):
        for kind in ("dirichlet1", "dirichlet0.05", "degenerate", "one_hot"):
            if kind == "one_hot":
                W_np = np.zeros(n, dtype=np.float32)
                W_np[n // 2] = 1.0
            else:
                W_np = cs_mod._dirichlet_like(rng, kind, n)
            W = torch.from_numpy(W_np).to(dev)
            out[f"{n} {kind}"] = {
                "B1": digest(ops.systematic_z_fused(W, 0.37, n)),
                "B3": digest(ops.normalised_cumsum_exact(W))}
        zi = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n).astype(
            np.int32)).to(dev)
        out[f"{n} int32"] = {"B6": digest(ops.running_max(zi))}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", help="comma-separated names of part 1's "
                    "calls to measure (default: all)")
    ap.add_argument("--schemes", help="comma-separated schemes of part 2 "
                    f"(default: {','.join(SCHEMES)}; 'none' for none)")
    ap.add_argument("--hashes", action="store_true",
                    help="first print the hashes of B1's, B3's and B6's "
                    "outputs on fixed inputs")
    args = ap.parse_args()
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

    if args.hashes:
        print(json.dumps({"part": "hashes", **head,
                          "hashes": _hashes(torch, ops, cs_mod, dev)}),
              flush=True)
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
        "library:cummax(z)": lambda: torch.cummax(zi, 0),
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
    if args.kernels:
        keep = [k for k in args.kernels.split(",") if k != "none"]
        unknown = set(keep) - set(calls)
        if unknown:
            sys.exit(f"profile_torch_kernels: unknown kernels {unknown}")
        calls = {k: v for k, v in calls.items() if k in keep}
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
    schemes = SCHEMES if args.schemes is None else [
        s for s in args.schemes.split(",") if s != "none"]
    steps = {}
    for scheme in schemes:
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
