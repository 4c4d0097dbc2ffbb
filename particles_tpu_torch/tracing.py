"""Spans and counters of the port: where a step's time and host reads go.

Spans.  While a ``torch.profiler`` window records, the engine marks its
work with ranges named ``particles.<name>``; otherwise each span is one
cheap check and the shared :data:`OFF` context, so a run with no profiler
pays almost nothing and no switch turns them on.  The ranges are the
profiler's function ranges, the kind it records for torch's own
operators (category ``cpu_op`` in a chrome trace, nested with the
``aten::`` operators they hold), on the same clock as the device's
kernels.  Each kernel's launch carries a correlation id that ties it to
the host's launch call, and that call lies inside the innermost span
open when it ran: so a trace gives every kernel, and every idle gap of
the device, the line of the program that caused it.

=====================================  =======================================
Span                                   Where
=====================================  =======================================
``particles.step``                     one call of ``next(smc)``, ``fk.done``
                                       included, for filters and samplers
``particles.sync.<site>``              one host read of a device value, with
                                       the comparison that feeds it: ``decide``
                                       (the resampling decision of a filter
                                       or a sampler step), ``done`` (a
                                       sampler's stopping rule), ``chain``
                                       (an adaptive move's chain step),
                                       ``smc2_acc`` (SMC²'s acceptance rate),
                                       ``ssp`` (the sequential SSP pairing)
``particles.model``                    the engine's calls into the user's
                                       model: ``M0``, ``M``, ``logG``,
                                       ``logeta``, ``Gamma0``, ``Gamma`` of a
                                       filter; a sampler's prior draws,
                                       ``logpdf`` and ``loglik``; the inner
                                       filters' ``M0``, ``M``, ``logG`` and
                                       ``logeta`` (``InnerPF._eval``)
``particles.smc2.inner``               one inner step of every row of an
                                       ``InnerPF`` (``init_with``,
                                       ``step_with``; ``t`` in its
                                       arguments): SMC²'s forward steps and
                                       replays, PMMH's filters
``particles.smc2.replay``              one replay of every θ-particle's
                                       filter over y_0..y_{t-1}: a move's
                                       target (``_ReplayTarget``) or the
                                       exchange step's (``SMC2._replay_all``)
``particles.smc2.exchange``            the exchange step's work once it has
                                       decided to double Nx
``particles.weights``                  ``resampling.Weights``: max, exp, sums,
                                       ``W``, ``ESS``, ``log_mean``
``particles.sampler.epn_search``       adaptive tempering's bisection for the
                                       next exponent
=====================================  =======================================

An operator reads a trace by these names: the device time of the kernels
launched inside ``particles.model`` or ``particles.weights`` is that
layer's share of the card; the idle gaps that open inside a
``particles.sync.*`` span are the host reads' cost.

Counters are always on, one dictionary in this module (:func:`count`,
:func:`counts`, :func:`reset`), and need no profiler:

- ``sync.<site>``: host reads, counted where their span is;
- ``launch.<kernel>``: launches of the kernels of :mod:`ops`, keyed as
  ``ops.KERNELS`` keys them (``systematic_z``, ``repeat_by_z``, ...);
- ``comm.<collective>``: calls of the collectives of
  :mod:`parallel.comm` (``pmax``, ``psum``, ``all_gather``,
  ``ring_shift``, ``exchange``);
- ``smc2.inner_steps`` and ``smc2.inner_particle_steps``: the inner steps
  of ``InnerPF`` (one a ``particles.smc2.inner`` span) and B·Nx summed
  over them; ``smc2.replays`` and ``smc2.exchanges``: SMC²'s replays and
  exchange steps.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["OFF", "PREFIX", "span", "sync", "count", "counts", "reset"]

PREFIX = "particles."

# what every span is while no profiler records
OFF = contextlib.nullcontext()

_counts = {}


def span(name, **values):
    """The range ``particles.<name>`` while a profiler records (``values``,
    such as ``t=3``, go in its arguments when the profiler records
    inputs), else :data:`OFF`."""
    if not torch._C._autograd._profiler_enabled():
        return OFF
    if values:
        return torch._C._profiler._RecordFunctionFast(PREFIX + name, (),
                                                      values)
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


def sync(site):
    """Count one host read at ``site`` (``sync.<site>``) and return its
    span, ``particles.sync.<site>``."""
    name = "sync." + site
    _counts[name] = _counts.get(name, 0) + 1
    return span(name)


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counts():
    """A copy of every counter: ``{name: value}``."""
    return dict(_counts)


def reset():
    """Set every counter to 0."""
    for k in _counts:
        _counts[k] = 0
