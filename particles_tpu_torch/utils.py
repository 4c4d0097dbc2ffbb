"""Utilities: the parameter-merging base class and the ``timer`` decorator
(counterparts of ``particles_tpu.utils.struct.KwPytree`` and
``particles_tpu.utils.timer``)."""

from __future__ import annotations

import difflib
import functools
import time
import warnings

import torch

__all__ = ["KwParams", "timer"]


class KwParams:
    """Base class whose ``__init__`` merges class-level ``default_params``
    with keyword arguments; every parameter becomes an instance attribute.

    Unknown keywords are kept (users attach extra attributes), but a near
    miss of a declared parameter warns: it is almost certainly a typo that
    would otherwise leave the default silently in place.
    """

    default_params: dict = {}

    def __init__(self, **kwargs):
        params = dict(self.default_params)
        for k in kwargs:
            if params and k not in params:
                close = difflib.get_close_matches(k, params, n=1)
                if close:
                    warnings.warn(
                        f"{type(self).__name__}: parameter {k!r} is not in "
                        f"default_params — did you mean {close[0]!r}?",
                        stacklevel=2)
        params.update(kwargs)
        self.__dict__.update(params)


def timer(method):
    """Decorator: store the wall-clock time of ``method`` in
    ``self.cpu_time``.  When the result (or else ``self.logLt``) is a CUDA
    tensor, the clock stops only after the device has finished."""

    @functools.wraps(method)
    def timed_method(self, *args, **kwargs):
        start = time.perf_counter()
        out = method(self, *args, **kwargs)
        target = out if out is not None else getattr(self, "logLt", None)
        if isinstance(target, torch.Tensor) and target.is_cuda:
            torch.cuda.synchronize(target.device)
        self.cpu_time = time.perf_counter() - start
        return out

    return timed_method
