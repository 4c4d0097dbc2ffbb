"""The ambient distributed context of the SMC engine (PyTorch port).

Counterpart of ``particles_tpu/distctx.py``.  The particle-sharded filter
runs the SAME engine (``core._step0`` / ``core._step``) on every rank, on
that rank's slice of N/D particles, in one process a rank (SPMD, a
``torch.distributed`` process group in place of the JAX mesh axis).  What
changes under a context is not the algorithm but three primitives:

* the weight reductions (log-normaliser, ESS, weighted moments) become
  all-reduces over the group (:mod:`particles_tpu_torch.parallel.comm`);
* resampling becomes the ring redistribution
  (:mod:`particles_tpu_torch.parallel.distributed`);
* the model draws come from the rank's own generator (``DistCtx.gen``),
  while the run's generator stays replicated: the same seed on every
  rank, consumed in the same order, so that the resampling uniforms and
  every branch decision agree everywhere.

The engine and the numerics consult :func:`current` rather than taking a
``dist`` argument in every signature.  No context means single-device
semantics.  This module imports no JAX.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, NamedTuple

import torch

__all__ = ["DistCtx", "dist_context", "local_context", "current",
           "rank_seed", "rank_generator"]

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


class DistCtx(NamedTuple):
    """Particle-axis sharding as the engine sees it.

    ``group``: the ``torch.distributed`` process group the particles are
    sharded over (None: the default group).  ``D``: its size; ``rank``:
    this process's rank in it.  Tensors under the context hold the rank's
    slice (``N_local``); the global particle count is ``N_local * D``, and
    rank r holds global particles ``[r * N_local, (r + 1) * N_local)``.
    ``gen``: the rank's model generator (:func:`rank_generator`).
    """

    group: Any
    D: int
    rank: int
    gen: Any


def _splitmix64(x):
    x = (x + _GOLDEN) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def rank_seed(seed, rank):
    """The seed of rank ``rank``'s model generator in a run seeded by
    ``seed``: the first output of SplitMix64 started from the state ``seed
    + (rank + 1) * 0x9E3779B97F4A7C15`` (mod 2^64).  That output is a
    bijection of the state, so for one run seed no two ranks share a
    stream (the counterpart of the JAX package's ``fold_in(key, shard)``)."""
    return _splitmix64((int(seed) + (int(rank) + 1) * _GOLDEN) & _MASK64)


def rank_generator(seed, rank, device):
    """A ``torch.Generator`` on ``device`` seeded by :func:`rank_seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(rank_seed(seed, rank))
    return gen


_state = threading.local()


def current():
    """The active :class:`DistCtx`, or None (single-device semantics)."""
    return getattr(_state, "ctx", None)


@contextmanager
def dist_context(group, gen):
    """Run the engine under particle sharding over ``group`` (an
    initialised ``torch.distributed`` process group; None for the default
    group), with ``gen`` the rank's model generator."""
    import torch.distributed as dist

    prev = current()
    _state.ctx = DistCtx(group, dist.get_world_size(group),
                         dist.get_rank(group), gen)
    try:
        yield _state.ctx
    finally:
        _state.ctx = prev


@contextmanager
def local_context():
    """Suspend the ambient context (single-device semantics) for strictly
    per-rank computations, such as a batch of independent inner filters
    whose reductions must stay local to each."""
    prev = current()
    _state.ctx = None
    try:
        yield
    finally:
        _state.ctx = prev
