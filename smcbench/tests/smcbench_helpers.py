"""Small runs of the cells on the CPU, for the tests."""

import time

import torch

from smcbench.lib import harness, spec

CELLS = ["lingauss.boot.n26", "sonar-logit.awf.m20"]

# the cells' mixes cut to what a CPU test holds
SMALL = {
    "lingauss.boot.n26": {"N": 1 << 14, "T": 100, "trace_from": 3,
                          "trace_steps": 3},
    "sonar-logit.awf.m20": {"M": 512, "len_chain": 4, "trace_from": 2,
                            "trace_steps": 2},
}


def find(name, root=spec.ROOT, bench_dir=spec.BENCH_DIR):
    """The cell ``name``."""
    return spec.find_cell(name, root=root, bench_dir=bench_dir)


def run_small(name, seed=2718281828459, seconds=1.5, trace=False,
              engine=None, params=None, root=spec.ROOT,
              bench_dir=spec.BENCH_DIR):
    """(result line, rows, info) of one CPU run of the cell ``name`` cut
    to :data:`SMALL`."""
    cell = find(name, root=root, bench_dir=bench_dir)
    mix = dict(SMALL.get(name, {}))
    mix.update(params or {})
    return harness.run_cell(torch, cell, seed, seconds, trace,
                            torch.device("cpu"), time.time(), params=mix,
                            engine=engine)
