"""No run loads JAX or the JAX package, and the references load nothing
of the program."""

import ast
import subprocess
import sys

import pytest
from smcbench_helpers import CELLS

from smcbench.lib import guard, spec


def test_forbidden_names_are_whole_top_level_names():
    assert guard.forbidden_modules(["particles_tpu_torch",
                                    "particles_tpu_torch.core", "numpy",
                                    "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_modules(["particles_tpu.core", "jaxlib.xla",
                                    "jax", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "particles_tpu"]


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_no_jax(name):
    """Each driver's run, in a fresh process, then the modules it holds."""
    code = (
        "import sys; sys.path.insert(0, 'smcbench/tests');"
        "sys.path.insert(0, '.');"
        "from smcbench_helpers import run_small;"
        "from smcbench.lib import guard;"
        f"line, rows, _ = run_small({name!r}, seconds=0.3, trace=True);"
        "assert line['attempted'] > 0;"
        "print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_references_import_nothing_of_the_program():
    for path in sorted((spec.BENCH_DIR / "reference").glob("*.py")):
        names = _imports(path)
        assert not names & {"particles_tpu_torch", "particles_tpu", "jax",
                            "jaxlib", "flax"}, path
        assert names <= {"__future__", "math", "numpy", "torch"}, (path,
                                                                   names)


def test_harness_sources_import_no_jax():
    for path in spec.BENCH_DIR.rglob("*.py"):
        assert not _imports(path) & {"particles_tpu", "jax", "jaxlib",
                                     "flax"}, path
