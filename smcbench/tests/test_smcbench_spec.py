"""Discovery by name: every cell of ``BENCHMARK.json`` finds its files, and
a configuration, a mix, a cell or a per-layer metric is added by new files
and new entries alone."""

import json
import shutil

import pytest
from smcbench_helpers import CELLS, run_small

from smcbench.lib import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def test_cells_are_the_issue_s_in_order():
    assert [w["name"] for w in BENCH["workloads"]] == CELLS
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = spec.find_cell(name)
    assert cell.config["name"] == cell.config_name
    for mod in (cell.driver, cell.model, cell.reference):
        assert mod is not None
    assert hasattr(cell.driver, "setup") and hasattr(cell.driver, "window")
    assert hasattr(cell.model, "make_inputs") and hasattr(cell.model,
                                                          "make_fk")
    assert hasattr(cell.reference, "judge")
    assert cell.traffic["limits"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert hasattr(cell.metric_reader(m["name"]), "read")


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.find_cell("no.such.cell")


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"]


def test_config_entries_point_at_their_files():
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg and "source" in cfg


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "smcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_new_cell_config_and_metric_are_files_alone(tmp_path):
    """A later change adds a configuration, a mix, a cell and a per-layer
    metric by new files and new BENCHMARK.json entries; nothing that is
    there changes, and the harness finds and runs them by name."""
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "smcbench").rglob("*")
              if p.is_file()}
    b = root / "smcbench"
    cfg = json.loads((b / "configs" / "lingauss.json").read_text())
    cfg.update(name="lingauss-slow", rho=0.5)
    (b / "configs" / "lingauss-slow.json").write_text(json.dumps(cfg))
    for kind in ("models", "reference"):
        shutil.copy(b / kind / "lingauss.py", b / kind / "lingauss-slow.py")
    mix = json.loads((b / "traffic" / "boot.n26.json").read_text())
    mix["params"].update(resampling="stratified")
    (b / "traffic" / "strat.n26.json").write_text(json.dumps(mix))
    (b / "metrics" / "window_ms.py").write_text(
        "def read(ctx):\n    return 1000.0 * ctx.trace.window_s\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "lingauss-slow", "source": "x",
                             "file": "smcbench/configs/lingauss-slow.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "lingauss-slow.strat.n26",
                               "config": "lingauss-slow",
                               "traffic": "strat.n26", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "particle_steps_per_s":
            m["workloads"].append("lingauss-slow.strat.n26")
    bench["per_layer"].append({"name": "window_ms", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "Device",
                               "moves": "particle_steps_per_s",
                               "workloads": ["lingauss-slow.strat.n26"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data
    cell = spec.find_cell("lingauss-slow.strat.n26", root=root,
                          bench_dir=b)
    assert cell.config["rho"] == 0.5
    assert cell.traffic["params"]["resampling"] == "stratified"
    small = {"N": 1 << 12, "T": 50, "trace_from": 2, "trace_steps": 3}
    line, rows, _ = run_small("lingauss-slow.strat.n26", seconds=0.5,
                              params=small, root=root, bench_dir=b)
    assert line["attempted"] > 0
    assert [r[0] for r in rows] == list(cell.traffic["limits"])
    assert set(line["metrics"]) == {"particle_steps_per_s", "setup_s"}
    line, _, _ = run_small("lingauss-slow.strat.n26", seconds=0.5,
                           trace=True, params=small, root=root, bench_dir=b)
    assert "window_ms" in line["metrics"]
