#!/usr/bin/env python3
"""``AuxiliaryBootstrap`` and ``AuxiliaryPF`` on ``StochVol`` on data with a
large observation, in the port and the JAX package.

Run from the repository root::

    JAX_PLATFORMS=cpu python3 tools/apf_stochvol_tail.py [--Ns 4096,16384]
    python3 tools/apf_stochvol_tail.py --packages port --device cuda \\
        --Ns 262144,1048576 --seeds 64 --filters Bootstrap,AuxiliaryPF

Data: T = 100 observations of ``StochVol()`` simulated by the port from
``torch.Generator().manual_seed(0)`` on the CPU (the output gives its
three largest |y| and their t).  For each N, the logLt of ``--seeds``
seeds (ESSrmin = 1.1, always resampling) of each filter, in each package
(the JAX package on the CPU; it is imported only when asked for), and
the runs more than ``--collapse`` below the bootstrap filter's median.
Pitt and Shephard's logeta grows like exp(-2 x) y^4 on the lowest
particles, so with the transition as the proposal (``AuxiliaryBootstrap``)
the auxiliary weights pick the particles the likelihood then rejects, and
the logLt falls far below the bootstrap filter's, the more so as N grows.
Prints one JSON line per package and N.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--Ns", default="4096,16384")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--packages", default="port,jax")
    ap.add_argument("--filters",
                    default="Bootstrap,AuxiliaryPF,AuxiliaryBootstrap")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--collapse", type=float, default=1.0,
                    help="a run this far below the bootstrap median counts "
                         "as collapsed")
    args = ap.parse_args()

    import numpy as np
    import torch

    from particles_tpu_torch import core
    from particles_tpu_torch import state_space_models as ssms

    packages = args.packages.split(",")
    filters = args.filters.split(",")
    if "jax" in packages:
        import jax
        import jax.numpy as jnp
        jax.config.update("jax_platforms", "cpu")
        import particles_tpu.core as jcore
        import particles_tpu.state_space_models as jssms

    _, y = ssms.StochVol().simulate(torch.Generator().manual_seed(0), 100)
    y_np = y.numpy()
    top = np.argsort(-np.abs(y_np))[:3]
    largest = {int(t): float(y_np[t]) for t in top}
    y_dev = y.to(args.device)
    for N in (int(n) for n in args.Ns.split(",")):
        for pkg in packages:
            out = {}
            for cls in filters:
                runs = []
                for s in range(args.seeds):
                    if pkg == "port":
                        pf = core.SMC(fk=getattr(ssms, cls)(
                            ssm=ssms.StochVol(), data=y_dev), N=N, seed=s,
                            ESSrmin=1.1)
                    else:
                        pf = jcore.SMC(fk=getattr(jssms, cls)(
                            ssm=jssms.StochVol(), data=jnp.asarray(y_np)),
                            N=N, seed=s, ESSrmin=1.1)
                    pf.run()
                    runs.append(float(pf.logLt))
                out[cls] = {"logLt": runs, "mean": float(np.mean(runs)),
                            "median": float(np.median(runs))}
            if "Bootstrap" in out:
                ref = out["Bootstrap"]["median"]
                for rec in out.values():
                    rec["collapsed"] = [
                        s for s, v in enumerate(rec["logLt"])
                        if v < ref - args.collapse]
            print(json.dumps({"package": pkg, "N": N,
                              "device": "cpu" if pkg == "jax"
                              else args.device,
                              "largest_y_by_t": largest, **out}),
                  flush=True)


if __name__ == "__main__":
    main()
