#!/usr/bin/env python3
"""Run one cell of the benchmark of ``particles_tpu_torch`` on the card.

From the root of a checkout::

    python3 smcbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process a run: it makes the cell's inputs from the seed, builds and
warms the program (``setup_s``), drives it for ``--seconds`` seconds,
holds what the window produced to the plain reference, and prints, as the
last line of standard output, one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``checks``).  The numbers compared, each
beside its limit, are also the last lines of standard error.  With
``--trace 0`` the metrics are the cell's end-to-end ones; with
``--trace 1`` its per-layer ones, read from one profiler window.

It exits with 2 and prints no result where the card is missing, and with
3 where a module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from smcbench.lib import guard  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    guard.cache_env(ROOT)
    import torch

    from smcbench.lib import device, harness, result, spec

    # one process with one host thread: the card does the work, and idle
    # worker threads only add noise to the host's clock
    torch.set_num_threads(1)

    cell = spec.find_cell(args.workload)
    try:
        device.require_cuda(torch, cell.chips)
    except device.NoDevice as err:
        print(err, file=sys.stderr, flush=True)
        return 2
    print(f"smcbench: {cell.name} on {device.power_limit()}; peaks "
          f"{device.PEAKS}", file=sys.stderr, flush=True)
    line, rows, info = harness.run_cell(
        torch, cell, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START)
    bad = guard.forbidden_modules()
    if bad:
        print(f"smcbench: the run loaded {bad}; no JAX and no JAX package "
              "may be loaded", file=sys.stderr, flush=True)
        return 3
    print(f"smcbench: window {info}", file=sys.stderr, flush=True)
    result.print_checks(rows)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
