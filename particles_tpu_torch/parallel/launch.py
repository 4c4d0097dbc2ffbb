"""Start D ranks of a function and bring back what each returns.

The counterpart of building a JAX ``Mesh`` and calling under the single
controller: :func:`spawn` starts D processes with
``torch.multiprocessing.start_processes`` (the ``spawn`` method), joins
them in one ``torch.distributed`` process group through a ``FileStore`` in
a fresh temporary directory (so that concurrent launches never share a
port or a store), calls ``fn(device, *args)`` on every rank and returns
the ranks' results, in rank order.

A launch never hangs its caller.  ``init_process_group`` gets
``collective_timeout``, after which a collective whose peers are gone
raises in the ranks still waiting.  The caller waits at most ``timeout``
seconds in all.  The first rank that raises, or exits without a result,
ends the launch: ``torch.multiprocessing`` kills every rank still running
and the caller gets a ``RuntimeError`` with the traceback of every rank
that failed (or the exit code); past the deadline every rank is killed and
the caller gets a ``TimeoutError``.

``fn`` must be importable by name (a module-level function, pickled by
reference) from a module whose import is cheap, since every rank imports
it; ``fn`` and ``args`` are pickled once into the launch's directory and
read there by each rank (a process's own arguments go through a pipe that
its parent fills while the child imports torch, so large ones would start
the ranks one after another).  Tensors in a result come back as numpy
arrays.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from datetime import timedelta

import torch
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

__all__ = ["spawn"]


def _rank_device(device, rank):
    """The device of rank ``rank`` for a launch on ``device`` (``"cpu"`` or
    ``"cuda"``): the CPU, or CUDA card ``rank % torch.cuda.device_count()``
    (so several ranks may share one card)."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _to_host(obj):
    """``obj`` with every tensor as a numpy array (dicts, lists, tuples)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank, D, tmp, backend, device, collective_timeout, results):
    """A rank's body: join the group, call ``fn``, put the result."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "payload"), "rb") as f:
        fn, args = pickle.load(f)
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), D),
        rank=rank, world_size=D,
        timeout=timedelta(seconds=collective_timeout))
    try:
        out = _to_host(fn(dev, *args))
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


def _failure(name, ctx, exc):
    """The ``RuntimeError`` of a failed launch: the traceback of every rank
    that wrote one (a rank whose peer died fails too, in its collective, so
    the first to fail need not be the cause), else ``exc``'s exit code."""
    tbs = {}
    for r, path in enumerate(ctx.error_files):
        if os.path.exists(path):
            with open(path, "rb") as f:
                tbs[r] = pickle.load(f)
            os.remove(path)
    ranks = sorted(tbs) or [exc.error_index]
    text = "\n".join(f"--- rank {r} ---\n{tbs[r]}" for r in sorted(tbs))
    return RuntimeError(f"spawn: {name} failed on rank(s) {ranks}:\n"
                        f"{text or exc}")


def spawn(fn, D, args=(), backend="gloo", device="cpu", timeout=300.0,
          collective_timeout=60.0):
    """Run ``fn(device, *args)`` on ``D`` ranks of one process group and
    return the list of their results, rank 0's first.

    ``backend`` is ``"gloo"`` or ``"nccl"``; ``device`` ``"cpu"`` or
    ``"cuda"`` (rank r takes the CPU, or CUDA card ``r % device_count``,
    made current).  ``timeout``: seconds the whole launch may take;
    ``collective_timeout``: seconds a collective may wait for its peers.
    Raises ``RuntimeError`` when a rank fails and ``TimeoutError`` past the
    deadline, after killing every rank."""
    if D < 1:
        raise ValueError(f"spawn: D must be >= 1, got {D}")
    deadline = time.monotonic() + timeout
    tmp = tempfile.mkdtemp(prefix="particles_tpu_torch_launch_")
    results = mp.get_context("spawn").SimpleQueue()
    ctx = None
    out = {}
    try:
        with open(os.path.join(tmp, "payload"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        ctx = mp.start_processes(
            _rank_main, args=(D, tmp, backend, device, collective_timeout,
                              results),
            nprocs=D, join=False, daemon=True, start_method="spawn")
        done = False
        while not done:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: {D} ranks of {fn.__name__} did not finish in "
                    f"{timeout} s; ranks {sorted(set(range(D)) - set(out))} "
                    "had not returned")
            try:
                done = ctx.join(timeout=min(left, 0.5))
            except ProcessException as exc:
                raise _failure(fn.__name__, ctx, exc) from None
            while not results.empty():     # a rank exits once it is read
                rank, payload = results.get()
                out[rank] = payload
        missing = sorted(set(range(D)) - set(out))
        if missing:
            raise RuntimeError(f"spawn: ranks {missing} of {fn.__name__} "
                               "exited with no result")
        return [out[r] for r in range(D)]
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
