"""On the card (marked ``cuda``; they skip without one): each cell runs
a short window at its own sizes and comes out correct, and the sampler's
control, TF32 products, comes out not correct.

    python -m pytest -m cuda smcbench/tests -q
"""

import time

import pytest
import torch
from smcbench_helpers import CELLS

from smcbench.lib import harness, spec

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(card, name):
    cell = spec.find_cell(name)
    line, rows, _ = harness.run_cell(torch, cell, 3141592653, 2.0, False,
                                     card, time.time())
    assert line["correct"], rows
    assert line["device"]["platform"] == "gpu"


def test_sampler_tf32_control_is_not_correct(card):
    cell = spec.find_cell("sonar-logit.awf.m20")
    try:
        line, rows, _ = harness.run_cell(
            torch, cell, 2718281828, 2.0, False, card, time.time(),
            engine=lambda c, inputs, d: c.reference.control_engine(
                c.config, inputs, d))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
    assert not line["correct"], rows
