#!/usr/bin/env python3
"""Where the time of the outer loops goes, at ``chip_smoke.py`` phase 17's
shapes, on one CUDA card.

Run from the repository root::

    python3 tools/profile_torch_outer.py [--parts pmmh,pmmh_qmc,csmc,smc2]
        [--out F]

For each part, a ``torch.profiler`` window gives the device ms by CUDA
kernel and the CUDA kernels of the unit below; the same unit timed again
(the clock stopped after the device) gives its wall ms, and the busy
share is device over wall.

- ``pmmh``: one PMMH log-posterior evaluation, ``PMMH.logpost`` at 8
  chains' θ (StochVol, T = 200, Nx = 100): the batched inner filter over
  200 observations, the bulk of an iteration; then the chain loop itself,
  wall ms an iteration over 50 iterations.
- ``pmmh_qmc``: the same chain with ``smc_options={"qmc": True}`` at
  Nx = 128: each chain's likelihood an SQMC run, one chain after another;
  wall ms an iteration over 3 iterations.
- ``csmc``: one conditional SMC run (LinearGauss, T = 100, N = 2^16),
  reported a step.
- ``smc2``: SMC² on GBP/USD (Ntheta = 1000, init_Nx = 100, len_chain = 4,
  ar_to_increase_Nx = 0.1) stepped past t = 200 to its next resample-move
  step: that step and the plain step before it, each replayed from a
  checkpoint (``save_state``, ``load_state``) for its window and again
  for its wall time, so both read the same step.

Prints the card's name and power limit, then one JSON line (also
written to ``--out`` when given).  A window whose every try drops kernels
is None (not measured).
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _window(torch, cs, fn):
    """({kernel: device ms}, CUDA kernels) of one call of ``fn`` (after
    one call to warm up), or (None, None)."""
    try:
        return cs._device_window(torch, fn, 1)
    except AssertionError as err:
        print(f"{err}; not measured", file=sys.stderr, flush=True)
        return None, None


def _wall_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1000.0 * (time.perf_counter() - t0)


def _summary(by_kernel, kernels, wall_ms, per):
    device = None if by_kernel is None else sum(by_kernel.values())
    return {
        "device_ms": None if device is None else device / per,
        "cuda_kernels": None if kernels is None else kernels / per,
        "wall_ms": wall_ms / per,
        "busy_share": None if device is None else device / wall_ms,
        "largest_kernels_ms": None if by_kernel is None else {
            k: v / per for k, v in sorted(by_kernel.items(),
                                          key=lambda kv: -kv[1])[:10]}}


def profile_pmmh(torch, dev):
    import chip_smoke as cs
    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import mcmc
    from particles_tpu_torch import state_space_models as ssms

    y = cs._simulate_sv(ssms.StochVol(mu=-1.0, rho=0.9, sigma=0.3),
                        cs.PMMH_T)
    prior = dists.StructDist({
        "mu": dists.Normal(scale=2.0),
        "rho": dists.Uniform(a=-0.99, b=0.99),
        "sigma": dists.Gamma(a=2.0, b=4.0)})
    m = mcmc.PMMH(ssm_cls=ssms.StochVol, prior=prior,
                  data=torch.from_numpy(y).to(dev), Nx=cs.PMMH_NX,
                  niter=51, nchains=cs.PMMH_CHAINS, seed=1)
    th = {"mu": torch.full((cs.PMMH_CHAINS,), -1.0, device=dev),
          "rho": torch.full((cs.PMMH_CHAINS,), 0.9, device=dev),
          "sigma": torch.full((cs.PMMH_CHAINS,), 0.3, device=dev)}
    by_kernel, n = _window(torch, cs, lambda: m.logpost(th))
    wall = _wall_ms(torch, lambda: m.logpost(th))
    out = {"logpost": _summary(by_kernel, n, wall, 1),
           "logpost_per_filter_step": _summary(by_kernel, n, wall,
                                               cs.PMMH_T)}
    m._chain()
    out["chain_wall_ms_per_iteration"] = _wall_ms(torch, m._chain) / 50
    out["shape"] = {"T": cs.PMMH_T, "Nx": cs.PMMH_NX,
                    "nchains": cs.PMMH_CHAINS}
    return out


def profile_pmmh_qmc(torch, dev, Nx=128, iterations=3):
    import chip_smoke as cs
    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import mcmc
    from particles_tpu_torch import state_space_models as ssms

    y = cs._simulate_sv(ssms.StochVol(mu=-1.0, rho=0.9, sigma=0.3),
                        cs.PMMH_T)
    prior = dists.StructDist({
        "mu": dists.Normal(scale=2.0),
        "rho": dists.Uniform(a=-0.99, b=0.99),
        "sigma": dists.Gamma(a=2.0, b=4.0)})
    m = mcmc.PMMH(ssm_cls=ssms.StochVol, prior=prior,
                  data=torch.from_numpy(y).to(dev), Nx=Nx,
                  niter=iterations + 1, nchains=cs.PMMH_CHAINS, seed=1,
                  smc_options={"qmc": True})
    m._chain()
    wall = _wall_ms(torch, m._chain)
    return {"chain_wall_ms_per_iteration": wall / (iterations + 1),
            "shape": {"T": cs.PMMH_T, "Nx": Nx, "nchains": cs.PMMH_CHAINS},
            "note": "iterations + 1 filter evaluations (the start's too)"}


def profile_csmc(torch, dev):
    import chip_smoke as cs
    from particles_tpu_torch import kalman, mcmc
    from particles_tpu_torch import state_space_models as ssms

    y = cs._simulate_y(cs.CSMC_T)
    xstar = torch.from_numpy(cs.kalman_targets(y, 1)["mean"].astype(
        "float32")).to(dev)
    fk = ssms.Bootstrap(ssm=kalman.LinearGauss(rho=cs.RHO, sigmaX=cs.SIGX,
                                               sigmaY=cs.SIGY),
                        data=torch.from_numpy(y).to(dev))
    cpf = mcmc.CSMC(fk=fk, N=cs.CSMC_N, xstar=xstar, seed=2)
    by_kernel, n = _window(torch, cs, cpf._run)
    wall = _wall_ms(torch, cpf._run)
    return {"per_step": _summary(by_kernel, n, wall, cs.CSMC_T - 1),
            "shape": {"T": cs.CSMC_T, "N": cs.CSMC_N}}


def profile_smc2(torch, dev, t_start=200):
    import tempfile

    import chip_smoke as cs
    from particles_tpu_torch import datasets
    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import smc_samplers as ssp
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.core import SMC

    y = datasets.GBP_vs_USD_9798().data.astype("float32")
    prior = dists.StructDist({
        "mu": dists.Normal(loc=-1.0, scale=2.0),
        "rho": dists.Uniform(a=-0.99, b=0.99),
        "sigma": dists.Gamma(a=2.0, b=4.0),
        "phi": dists.Uniform(a=-0.99, b=0.99)})
    fk = ssp.SMC2(ssm_cls=ssms.StochVolLeverage, prior=prior,
                  data=torch.from_numpy(y).to(dev), init_Nx=cs.SMC2_NX,
                  len_chain=cs.SMC2_LEN_CHAIN, ar_to_increase_Nx=cs.SMC2_AR)
    pf = SMC(fk=fk, N=cs.SMC2_NTHETA, seed=3, ESSrmin=0.5)
    while pf.t < t_start:
        next(pf)
    # the states before a plain step and before the next resample-move
    # step, saved, so that each window and its timing replay one step
    tmp = tempfile.mkdtemp()
    paths = [os.path.join(tmp, f"{i}.pt") for i in range(2)]
    plain = None
    while True:
        path = paths[pf.t % 2]
        pf.save_state(path)
        next(pf)
        if not pf.rs_flag:
            plain, t_plain = path, pf.t - 1
        elif plain is not None:
            move, t_move = path, pf.t - 1
            break

    def window(path):
        """The step's CUDA kernels, the load outside the window."""
        from torch.profiler import ProfilerActivity, profile

        pf.load_state(path)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            next(pf)
            torch.cuda.synchronize()
        by_kernel, n = {}, 0
        for evt in prof.key_averages():
            if (evt.device_type == torch.autograd.DeviceType.CUDA
                    and not evt.key.startswith(("Memcpy", "Memset"))):
                name = evt.key[:100]
                by_kernel[name] = (by_kernel.get(name, 0.0)
                                   + evt.self_device_time_total / 1000.0)
                n += evt.count
        return (by_kernel, n) if n else (None, None)

    def timed(path):
        pf.load_state(path)
        return _wall_ms(torch, lambda: next(pf))

    out = {"shape": {"Ntheta": cs.SMC2_NTHETA, "T": len(y)},
           "Nx": int(pf.X.xs.shape[1])}
    for name, path, t in (("plain_step", plain, t_plain),
                          ("resample_move_step", move, t_move)):
        timed(path)                                   # warm
        by_kernel, n = window(path)
        out[name] = {"t": t, **_summary(by_kernel, n, timed(path), 1)}
    return out


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parts", default="pmmh,pmmh_qmc,csmc,smc2")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_outer: needs a CUDA card")
    from particles_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _build.build()
    dev = torch.device("cuda", 0)
    parts = {"pmmh": profile_pmmh, "pmmh_qmc": profile_pmmh_qmc,
             "csmc": profile_csmc, "smc2": profile_smc2}
    out = {"nvidia_smi": smi}
    for name in args.parts.split(","):
        t0 = time.perf_counter()
        out[name] = parts[name](torch, dev)
        out[name]["seconds"] = time.perf_counter() - t0
        print(f"{name} done", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
