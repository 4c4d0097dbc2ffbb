"""Utilities: the parameter-merging base class, the ``timer`` decorator,
the experiment helpers (``cartesian_args``, ``cartesian_lists``,
``add_to_dict``, ``worker``, ``distribute_work``, ``seeder``,
``multiplexer``; counterparts of ``particles_tpu.utils``) and
``resolve_device``, the port's rule for where an entry point runs.

Where the JAX package hands each run a key, these hand it a
``torch.Generator``, under the keyword ``gen``.  ``nprocs`` is accepted and
the work runs in this process, one call after another, as in the JAX
package."""

from __future__ import annotations

import difflib
import functools
import itertools
import time
import warnings

import torch

__all__ = ["KwParams", "timer", "cartesian_args", "cartesian_lists",
           "add_to_dict", "worker", "distribute_work", "seeder",
           "multiplexer", "resolve_device"]


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


def cartesian_lists(d):
    """The list of dicts of the cartesian product of a dict of lists:
    ``cartesian_lists({'a': [0, 2], 'b': [3, 4]})`` is ``[{'a': 0, 'b': 3},
    {'a': 0, 'b': 4}, {'a': 2, 'b': 3}, {'a': 2, 'b': 4}]``."""
    return [dict(zip(d.keys(), args)) for args in itertools.product(
        *d.values())]


def add_to_dict(d, obj, key="output"):
    """A copy of dict ``d`` with ``obj`` stored under ``key``."""
    d = dict(d)
    d[key] = obj
    return d


def worker(qin, qout, f):
    """Queue worker: pull ``(i, args)`` from ``qin`` and push ``(i,
    f(**args))`` to ``qout`` until a ``(None, None)`` sentinel arrives."""
    while True:
        i, args = qin.get()
        if i is None and args is None:
            break
        qout.put((i, f(**args)))


def distribute_work(f, inputs, outputs=None, nprocs=1, out_key="output"):
    """``f(**i)`` for each dict ``i`` of ``inputs``: a list of dicts, each
    input (or the matching entry of ``outputs``) with the result under
    ``out_key``, or merged in when the result is a dict.  Runs in this
    process; ``nprocs`` is accepted and ignored."""
    del nprocs
    if outputs is None:
        outputs = [dict(ip) for ip in inputs]
    res = []
    for ip, op in zip(inputs, outputs):
        out = f(**ip)
        op = dict(op)
        if isinstance(out, dict):
            op.update(out)
        else:
            op[out_key] = out
        res.append(op)
    return res


class seeder:
    """Wrap ``func`` so that a ``seed`` keyword becomes a generator: ``gen
    = torch.Generator(device).manual_seed(seed)``, unless the caller passed
    ``gen``.  ``device`` follows :func:`resolve_device`."""

    def __init__(self, func, device=None):
        self.func = func
        self.device = device
        functools.update_wrapper(self, func)

    def __call__(self, **kwargs):
        seed = kwargs.pop("seed", None)
        if seed is not None and "gen" not in kwargs:
            gen = torch.Generator(device=resolve_device(self.device))
            kwargs["gen"] = gen.manual_seed(seed)
        return self.func(**kwargs)


def multiplexer(f=None, nruns=1, seeding=None, seed=0, nprocs=0,
                protected_args=None, device=None, **args):
    """Run ``f`` over the cartesian product of the options (a list value
    gives one run per element, a dict value one per (name, value) pair,
    labelled by the name) times ``nruns`` replicates.

    Each call receives ``gen``, a generator on ``device`` (by
    :func:`resolve_device`); replicate ``r`` of every combination is seeded
    from ``seed`` and ``r`` alone, so the combinations share their random
    streams, as in the JAX package.  ``seeding`` and ``nprocs`` are
    accepted and ignored.  Returns a list of dicts with the varying
    options, ``'run'`` and ``'output'``."""
    del seeding, nprocs
    if f is None:
        raise ValueError("multiplexer: you must provide a function f")
    protected = protected_args or {}
    device = resolve_device(device)
    labels_list, values_list = cartesian_args(args)
    run_seeds = torch.randint(0, 2 ** 62, (nruns,), generator=torch.Generator(
        ).manual_seed(seed)).tolist()
    varying = [k for k, v in args.items() if isinstance(v, (list, dict))]
    results = []
    for labels, values in zip(labels_list, values_list):
        for r, run_seed in enumerate(run_seeds):
            gen = torch.Generator(device=device).manual_seed(run_seed)
            entry = {k: labels[k] for k in varying}
            entry["run"] = r
            entry["output"] = f(gen=gen, **protected, **values)
            results.append(entry)
    return results
