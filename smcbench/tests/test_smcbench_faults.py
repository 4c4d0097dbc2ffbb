"""The comparison that decides ``correct`` fails what it must.

Each cell is run on the CPU at a small size, past the harness's look for
a card: sound, it comes out correct; with the timed path broken
underneath (``smcbench/faults.py``), once for each fault the cell can
have (a step that returns its state unchanged; half of the particles
left out, the mean taken over the rest; an answer altered where it is
produced), for the sampler also a move that targets the wrong law, and
with the control in the program's place, it comes out not correct.  The limits are the cells' own, from ``traffic/<mix>.json``.
"""

import math

import pytest
import torch
from smcbench_helpers import CELLS, find, run_small

from particles_tpu_torch import smc_samplers as ssp
from smcbench import faults

FILTERS = ["lingauss.boot.n26"]
SAMPLER = "sonar-logit.awf.m20"


def _failed(rows):
    return [name for name, value, limit in rows
            if value is None or not math.isfinite(value) or value > limit]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line, rows, _ = run_small(name, seconds=5.0)
    assert line["correct"], rows
    assert line["attempted"] > 0 and line["failed"] == 0


def test_sound_sqmc_run_is_correct():
    """The filter driver's SQMC path (``qmc`` in a mix; no cell runs it
    yet) under the bootstrap cell's limits."""
    line, rows, _ = run_small(FILTERS[0], seconds=2.0, params={"qmc": True})
    assert line["correct"], rows


def _planted(monkeypatch, name, fault, params=None):
    return faults.plant(find(name), fault, monkeypatch.setattr, params)


@pytest.mark.parametrize("fault", ["stuck", "half", "altered"])
@pytest.mark.parametrize("name", FILTERS)
def test_filter_fault_is_not_correct(monkeypatch, name, fault):
    line, rows, _ = run_small(name, params=_planted(monkeypatch, name,
                                                    fault))
    assert not line["correct"], rows
    assert _failed(rows)


@pytest.mark.parametrize("fault", ["stuck", "half", "altered"])
def test_sampler_fault_is_not_correct(monkeypatch, fault):
    line, rows, _ = run_small(SAMPLER, params=_planted(monkeypatch, SAMPLER,
                                                       fault))
    assert not line["correct"], rows
    assert _failed(rows)


def test_wrong_target_move_fails_move_acc_z_alone(monkeypatch):
    """A move that accepts at twice the log ratio, storing true
    log-posteriors and reporting its true acceptance rate: only
    ``move_acc_z`` sees it (at 2048 chains, which the CPU holds)."""
    line, rows, _ = run_small(SAMPLER, params=_planted(
        monkeypatch, SAMPLER, "wrong_target", {"M": 2048}))
    assert _failed(rows) == ["move_acc_z"], rows


@pytest.mark.parametrize("name", FILTERS)
def test_filter_control_is_not_correct(name):
    """The control: the Kalman reference in bfloat16 in the program's
    place, judged at the cell's own N (the control holds no particles)."""
    N = find(name).traffic["params"]["N"]
    line, rows, _ = run_small(name, params={"N": N},
                           engine=lambda c, inputs, d:
                           c.reference.control_engine(c.config, inputs, d))
    assert not line["correct"], rows


def _tf32(x):
    """``x`` rounded to TF32's 10-bit mantissa (the operands of a TF32
    product)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32)


def test_sampler_control_is_not_correct(monkeypatch):
    """The sampler's control, TF32 products, as the CPU can show it: the
    likelihood's operands rounded to TF32 (the card runs the product in
    TF32 itself, ``controls.py``)."""

    def logpyt(self, theta, t):
        beta = _tf32(theta["beta"])
        return -torch.nn.functional.softplus(-(beta @ _tf32(self.data)[t]))

    orig = ssp.StaticModel.loglik

    def loglik(self, theta, t=None):
        if type(self).__name__ == "SonarLogit":
            type(self).logpyt = logpyt
        return orig(self, theta, t)

    monkeypatch.setattr(ssp.StaticModel, "loglik", loglik)
    line, rows, _ = run_small(SAMPLER)
    assert not line["correct"], rows
    assert "llik_err" in _failed(rows)
