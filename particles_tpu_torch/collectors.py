"""On-line summary collectors (PyTorch port, first slice).

Counterpart of ``particles_tpu/collectors.py``: the ``Collector`` base,
the default collectors ``ESSs``, ``LogLts`` and ``Rs_flags``, and the
``Summaries`` container.  This slice runs stateless collectors only
(``collect(view)``); the stateful ones (on-line smoothers, ``Moments``...)
are ROADMAP A.6.
"""

from __future__ import annotations

import torch

__all__ = ["Collector", "Summaries", "ESSs", "LogLts", "Rs_flags",
           "default_collector_cls"]


class Collector:
    """Base class for collectors: ``collect(view)`` returns what to record
    at one step.  Keyword arguments declared in the class attribute
    ``signature`` become attributes.  ``uses_genealogy`` says whether the
    collector reads ``view.A`` (the ancestor indices, then computed by the
    resampling kernel on resampling steps)."""

    signature = {}
    stateful = False
    uses_genealogy = True

    @property
    def summary_name(self):
        cn = self.__class__.__name__
        return cn[0].lower() + cn[1:]

    def __init__(self, **kwargs):
        params = dict(self.signature)
        params.update(kwargs)
        for k, v in params.items():
            setattr(self, k, v)

    def collect(self, view):
        raise NotImplementedError


class ESSs(Collector):
    """Effective sample size at each t."""

    summary_name = "ESSs"
    uses_genealogy = False

    def collect(self, view):
        return view.wgts.ESS


class LogLts(Collector):
    """Cumulative log-likelihood estimate at each t."""

    summary_name = "logLts"
    uses_genealogy = False

    def collect(self, view):
        return view.logLt


class Rs_flags(Collector):
    """Whether resampling happened at each t."""

    summary_name = "rs_flags"
    uses_genealogy = False

    def collect(self, view):
        return view.rs_flag


default_collector_cls = [ESSs, LogLts, Rs_flags]


class Summaries:
    """Per-run summaries: after a run, each collector's record is an
    attribute, e.g. ``smc.summaries.ESSs`` (a (T,) tensor)."""

    def __init__(self, cols):
        self._collectors = [cls() for cls in default_collector_cls]
        if cols is not None:
            self._collectors.extend(
                c if isinstance(c, Collector) else c() for c in cols)
        for col in self._collectors:
            if col.stateful:
                raise NotImplementedError(
                    f"stateful collector {type(col).__name__} is not ported "
                    "to particles_tpu_torch yet (ROADMAP A.6)")
            setattr(self, col.summary_name, [])

    @property
    def needs_genealogy(self):
        return any(c.uses_genealogy for c in self._collectors)

    def collect(self, view):
        """One step's outputs, one per collector."""
        return tuple(c.collect(view) for c in self._collectors)

    def append_step(self, outputs):
        for col, out in zip(self._collectors, outputs):
            getattr(self, col.summary_name).append(out)

    def finalize_lists(self):
        """Stack each record into one tensor where its entries allow."""
        for col in self._collectors:
            val = getattr(self, col.summary_name)
            if not isinstance(val, list) or not val:
                continue
            if (all(isinstance(v, torch.Tensor) for v in val)
                    and len({v.shape for v in val}) == 1):
                setattr(self, col.summary_name, torch.stack(val))
            elif all(isinstance(v, (bool, int, float)) for v in val):
                setattr(self, col.summary_name, torch.tensor(val))
