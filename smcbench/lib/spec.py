"""Discovery by name: a cell of ``BENCHMARK.json`` and the files that
belong to it.

A cell names a configuration and a traffic mix.  The harness finds

- ``configs/<config>.json``: the configuration's sizes, source, ``assumed``
  and ``reduced``;
- ``models/<config>.py``: the inputs made from the seed and the program's
  model built from them;
- ``reference/<config>.py``: the plain reference that judges the outputs;
- ``traffic/<traffic>.json``: the mix's parameters, its driver and the
  limits of the numbers compared;
- ``drivers/<driver>.py``: the loop that drives the program;
- ``metrics/<metric>.py``: one reader a per-layer metric.

A new configuration, mix or metric is new files and new entries of
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from functools import cached_property
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """The module in file ``path`` (its file name may hold dots or dashes),
    imported under ``name``."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"smcbench: no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _for_cell(entries, cell):
    return [m for m in entries if "workloads" not in m
            or cell in m["workloads"]]


@dataclass
class Cell:
    """One cell and everything found for it by name."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    why: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path = field(default=BENCH_DIR)

    def module(self, kind, name):
        """``<bench_dir>/<kind>/<name>.py``."""
        return load_module(self.bench_dir / kind / f"{name}.py",
                           f"smcbench_{kind}_{name}".replace(".", "_")
                           .replace("-", "_"))

    @cached_property
    def driver(self):
        return self.module("drivers", self.traffic["driver"])

    @cached_property
    def model(self):
        return self.module("models", self.config_name)

    @cached_property
    def reference(self):
        return self.module("reference", self.config_name)

    def metric_reader(self, name):
        return self.module("metrics", name)


def find_cell(name, root=ROOT, bench_dir=BENCH_DIR):
    """The cell ``name`` of ``<root>/BENCHMARK.json``; a name it lacks
    raises KeyError."""
    bench = load_json(Path(root) / "BENCHMARK.json")
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"smcbench: no workload {name!r} in BENCHMARK.json "
                       f"(has {[w['name'] for w in bench['workloads']]})")
    bench_dir = Path(bench_dir)
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]), why=w["why"],
        config=load_json(bench_dir / "configs" / f"{w['config']}.json"),
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name),
        bench_dir=bench_dir)
