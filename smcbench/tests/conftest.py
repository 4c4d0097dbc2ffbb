"""The benchmark's own tests: the harness on the CPU at small sizes, and
a few that need the card (marked ``cuda``; they skip without one).

Run from the repository root::

    python -m pytest smcbench/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _few_threads():
    """Two host threads a test, as a run uses one: under ``-n`` workers
    the cores are shared, and a window's steps stay many."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """The CUDA card; the test skips where there is none (decided here,
    never when a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
