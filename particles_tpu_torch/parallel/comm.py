"""The collectives of the particle-sharded engine on ``torch.distributed``.

Counterparts of the JAX package's ``lax.pmax``, ``lax.psum``,
``lax.all_gather`` and ``lax.ppermute`` over ``perm=[(i, (i + 1) % D)]``,
as plain functions on tensors over an explicit process group (None: the
default group).  Every rank of the group calls each function in the same
order, as with any collective.

Each function counts its calls in the counter ``comm.<name>`` of
:mod:`particles_tpu_torch.tracing`, beside the kernels' launches
(``launch.<kernel>``); :data:`COLLECTIVES` names them.  ``pmax`` and
``psum`` are one all-reduce each, ``all_gather`` one all-gather,
``ring_shift`` one hop of the ring and ``exchange`` one swap with a
partner (one ``batch_isend_irecv`` for every tensor either moves).

Where the operands live: under NCCL they stay on the device.  Under gloo
an operand on a CUDA device passes through host memory (copied out,
reduced or sent, copied back), as gloo reduces and sends host buffers.
The choice is read from ``dist.get_backend(group)``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from particles_tpu_torch import tracing

__all__ = ["COLLECTIVES", "pmax", "psum", "all_gather", "ring_shift",
           "exchange"]

# the collectives, each counted as ``comm.<name>``
COLLECTIVES = ("pmax", "psum", "all_gather", "ring_shift", "exchange")


def _to_wire(t, group):
    """``(buffer, device to copy the result back to or None)``: a CUDA
    tensor goes through the host when the group's backend is gloo."""
    if t.device.type == "cuda" and str(dist.get_backend(group)) == "gloo":
        return t.cpu(), t.device
    return t, None


def _from_wire(t, back):
    return t if back is None else t.to(back)


def _peer(group, rank):
    """The global rank of ``rank`` of ``group`` (what point-to-point
    operations take)."""
    return rank if group is None else dist.get_global_rank(group, rank)


def pmax(x, group=None):
    """The maximum of the 0-d tensor ``x`` over the group's ranks (one
    all-reduce)."""
    tracing.count("comm.pmax")
    buf, back = _to_wire(x.detach().reshape(1).clone(), group)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return _from_wire(buf, back).reshape(())


def psum(*xs, group=None):
    """The sums over the group's ranks of the tensors ``xs`` (one dtype),
    all in one all-reduce: a tuple of tensors shaped as ``xs``."""
    tracing.count("comm.psum")
    flat = torch.cat([x.detach().reshape(-1) for x in xs])
    buf, back = _to_wire(flat, group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    out = _from_wire(buf, back)
    sizes = [x.numel() for x in xs]
    return tuple(p.reshape(x.shape)
                 for p, x in zip(torch.split(out, sizes), xs))


def all_gather(x, group=None):
    """The ranks' ``x`` (one shape on every rank) joined in rank order
    along the first dimension; a 0-d ``x`` gives a (D,) tensor."""
    tracing.count("comm.all_gather")
    buf, back = _to_wire(x.detach().contiguous(), group)
    if buf.ndim == 0:
        buf = buf.reshape(1)
    parts = [torch.empty_like(buf)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return _from_wire(torch.cat(parts), back)


def _send_recv(tensors, to, frm, group):
    """Send each of ``tensors`` to group rank ``to`` and receive the
    same-shaped tensors of group rank ``frm``, in one
    ``batch_isend_irecv``; returns the received tensors, in order."""
    to, frm = _peer(group, to), _peer(group, frm)
    wired = [_to_wire(t.contiguous(), group) for t in tensors]
    recv = [torch.empty_like(buf) for buf, _ in wired]
    ops = ([dist.P2POp(dist.isend, buf, to, group, tag=i)
            for i, (buf, _) in enumerate(wired)]
           + [dist.P2POp(dist.irecv, r, frm, group, tag=i)
              for i, r in enumerate(recv)])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_from_wire(r, back) for r, (_, back) in zip(recv, wired)]


def ring_shift(tensors, group=None):
    """One hop of the ring: every rank sends each of ``tensors`` to rank
    ``(rank + 1) % D`` and receives the same-shaped tensors of rank
    ``(rank - 1) % D``, in one ``batch_isend_irecv``.  Returns the received
    tensors, in order."""
    tracing.count("comm.ring_shift")
    D = dist.get_world_size(group)
    rank = dist.get_rank(group)
    return _send_recv(tensors, (rank + 1) % D, (rank - 1) % D, group)


def exchange(tensors, partner, group=None):
    """Swap ``tensors`` with group rank ``partner``, which calls this with
    this rank as its partner and same-shaped tensors, in one
    ``batch_isend_irecv``.  Returns the partner's tensors, in order."""
    tracing.count("comm.exchange")
    return _send_recv(tensors, partner, partner, group)
