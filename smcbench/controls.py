#!/usr/bin/env python3
"""Run a cell's control on the card: the reference's lower-precision
stand-in in the program's place (``reference/<config>.py``'s
``control_engine``), judged with the cell's own limits, on several seeds
in one process; or, with ``--fault``, the program with one of
``faults.py``'s faults planted.  Their numbers are the upper readings the
limits were set below; the benchmark's own runs never run them.

From the root of a checkout::

    python3 smcbench/controls.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--fault <name>]

Prints one JSON line a seed: the seed, ``correct`` and each number
compared beside its limit.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from smcbench.lib import guard  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    guard.cache_env(ROOT)
    import torch

    from smcbench import faults
    from smcbench.lib import device, harness, spec

    cell = spec.find_cell(args.workload)
    try:
        device.require_cuda(torch, cell.chips)
    except device.NoDevice as err:
        print(err, file=sys.stderr, flush=True)
        return 2
    dev = torch.device("cuda", 0)
    what = args.fault or "control"
    print(f"smcbench {what}: {cell.name} on {device.power_limit()}",
          file=sys.stderr, flush=True)
    params, engine = None, None
    if args.fault:
        params = faults.plant(cell, args.fault)
    else:
        def engine(c, inputs, d):
            return c.reference.control_engine(c.config, inputs, d)
    for seed in (int(s) for s in args.seeds.split(",")):
        line, rows, info = harness.run_cell(
            torch, cell, seed, args.seconds, False, dev, time.time(),
            params=params, engine=engine)
        print(json.dumps({"seed": seed, "what": what,
                          "correct": line["correct"],
                          "attempted": line["attempted"], "info": info,
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
