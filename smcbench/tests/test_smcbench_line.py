"""The last line's schema, and the runs that must print no result: no
card, and a directory that holds only the benchmark."""

import json
import shutil
import subprocess
import sys

import pytest
from smcbench_helpers import CELLS, run_small

from smcbench.lib import spec
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _units(kind, cell):
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    return {m["name"]: m["unit"] for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_last_line_schema(name, trace):
    line, rows, info = run_small(name, seconds=0.5, trace=trace)
    text = json.dumps(line)
    back = json.loads(text)
    keys = list(back)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert keys[5:-1] == (["breakdown"] if trace else [])
    assert isinstance(back["correct"], bool)
    assert back["attempted"] == info["steps"] > 0
    dev = back["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(back["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in back["breakdown"].values())
        units = _units("per_layer", name)
        # a CPU trace holds no kernels: the readers are silent
        assert set(back["metrics"]) <= set(units)
    else:
        units = _units("end_to_end", name)
        assert set(back["metrics"]) == set(units)
    for k, v in back["metrics"].items():
        assert v["unit"] == units[k] and isinstance(v["value"], float)
    assert list(back["checks"]) == [r[0] for r in rows]
    for c in back["checks"].values():
        assert set(c) == {"value", "limit"}


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "smcbench/run.py", "--workload", CELLS[0],
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_run_py_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(spec.ROOT)
    assert out.returncode == 2
    assert "cuda" in out.stderr.lower()
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_benchmark_alone_prints_no_result(tmp_path):
    """A directory with BENCHMARK.json and smcbench/ only: the program is
    missing, so a run fails and prints no result (here through the
    harness itself, which the card's run reaches)."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "smcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys, time, torch; sys.path.insert(0, '.');"
            "from smcbench.lib import spec, harness;"
            "cell = spec.find_cell('lingauss.boot.n26');"
            "line = harness.run_cell(torch, cell, 1, 0.1, False,"
            " torch.device('cpu'), time.time(),"
            " params={'N': 256, 'T': 10});"
            "print(line)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert "particles_tpu_torch" in out.stderr
    assert out.stdout == ""
