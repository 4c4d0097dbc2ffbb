"""Utilities: the parameter-merging base class, the ``timer`` decorator,
``cartesian_args`` (counterparts of ``particles_tpu.utils.struct.
KwPytree``, ``particles_tpu.utils.timer`` and ``cartesian_args``) and
``resolve_device``, the port's rule for where an entry point runs."""

from __future__ import annotations

import difflib
import functools
import itertools
import time
import warnings

import torch

__all__ = ["KwParams", "timer", "cartesian_args", "resolve_device"]


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


def resolve_device(device=None):
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA card.  With no card it raises: an entry point never falls
    back to the CPU unless asked with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card (torch.cuda.is_available() is False): pass "
                'device="cpu" to run on the CPU')
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def cartesian_args(args):
    """Expand dict/list-valued options into lists of flat option dicts:
    ``(labels_list, values_list)``.

    A list value gives one combination per element; a dict value one per
    (name, value) pair, with the *name* as the label.  Scalar values are
    broadcast.
    """
    fixed, varying = {}, {}
    for k, v in args.items():
        if isinstance(v, list):
            varying[k] = [(val, val) for val in v]
        elif isinstance(v, dict):
            varying[k] = list(v.items())
        else:
            fixed[k] = v
    names = list(varying)
    labels_list, values_list = [], []
    for combo in itertools.product(*(varying[k] for k in names)):
        labels, values = dict(fixed), dict(fixed)
        for k, (label, val) in zip(names, combo):
            labels[k] = label
            values[k] = val
        labels_list.append(labels)
        values_list.append(values)
    return labels_list, values_list
