"""``particles_tpu_torch.parallel.launch``: a rank that fails, or a launch
past its deadline, ends the launch with every rank killed, and the
caller gets an error, never a hang."""

import multiprocessing
import time

import pytest

import torch_dist_ranks as ranks
from particles_tpu_torch.parallel import launch


def test_a_failing_rank_fails_the_caller_at_once():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match="fail_on_rank_1 failed on rank(.|\n)*"
                             "--- rank 1 ---(.|\n)*"
                             "ValueError: rank 1 fails on purpose"):
        launch.spawn(ranks.fail_on_rank_1, 2, timeout=120,
                     collective_timeout=60)
    # rank 0 was still blocked in its all-reduce: killed, not waited for
    assert time.monotonic() - t0 < 60
    assert not multiprocessing.active_children()


def test_the_deadline_kills_every_rank():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 5 s"):
        launch.spawn(ranks.hang_on_rank_1, 2, timeout=5)
    assert time.monotonic() - t0 < 30
    assert not multiprocessing.active_children()
