"""The Hilbert space-filling curve: indices of integer points and the
Hilbert sort of particles (PyTorch port).

Counterpart of ``particles_tpu/hilbert.py``: Skilling's transpose-to-axes
algorithm ("Programming the Hilbert curve", 2004), vectorised over the N
points, then the interleave of the bit planes into one key.  With d axes
of ``nbits`` bits each and d * nbits <= 62, the key is one int64 (the JAX
package splits it in two uint32 limbs), so one stable ``torch.sort``
gives the order of the JAX package's two-limb lexicographic sort.
Skilling's (nbits - 1) d rounds depend on each other and run one after
another; the Gray decode and the interleave, linear over GF(2), are a few
batched operations each.  The 1-d order is a sort of the points
themselves.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["hilbert_index", "hilbert_array", "hilbert_sort",
           "hilbert_sort_with", "sort_nbits", "invlogit", "Hilbert_to_int"]


@functools.lru_cache(maxsize=None)
def _interleave_shifts(d, nbits, device):
    """(d, nbits) int64: the key position of bit b of axis i, b d + d - 1 -
    i (bit planes MSB first, axis 0 most significant within a plane)."""
    b = torch.arange(nbits, dtype=torch.int64, device=device)
    i = torch.arange(d, dtype=torch.int64, device=device)
    return b[None, :] * d + (d - 1 - i)[:, None]


def hilbert_index(coords, nbits):
    """Hilbert indices of integer points: ``coords`` (N, d), entries in [0,
    2^nbits), d * nbits <= 62; returns (N,) int64 keys, equal to the JAX
    package's ``(hi << 32) | lo``."""
    N, d = coords.shape
    if d * nbits > 62:
        raise ValueError(f"hilbert_index: d * nbits = {d * nbits} > 62")
    X = [coords[:, i].to(torch.int64) for i in range(d)]
    # inverse undo, from the top bit plane down
    for q in range(nbits - 1, 0, -1):
        P = (1 << q) - 1
        X[0] = X[0] ^ (((X[0] >> q) & 1) * P)      # set: invert axis 0
        for i in range(1, d):
            # set: invert the low bits of axis 0; else exchange them with
            # axis i's
            t = (X[0] ^ X[i]) & P
            unset = ((X[i] >> q) & 1) ^ 1
            X[0] = X[0] ^ torch.where(unset.bool(), t, P)
            X[i] = X[i] ^ t * unset
    # Gray encode: a prefix XOR over the axes, then each axis XOR t, bit p
    # of t the parity of axis d - 1's bits above p
    for i in range(1, d):
        X[i] = X[i] ^ X[i - 1]
    t = X[d - 1] >> 1
    k = 1
    while k < nbits:
        t = t ^ (t >> k)
        k *= 2
    Xs = torch.stack(X, 1) ^ t.unsqueeze(1)             # (N, d)
    b = torch.arange(nbits, dtype=torch.int64, device=Xs.device)
    bits = (Xs.unsqueeze(-1) >> b) & 1                   # (N, d, nbits)
    return (bits << _interleave_shifts(d, nbits, Xs.device)).sum((1, 2))


def hilbert_array(xint, nbits=None):
    """Hilbert indices (int64 keys) of an (N, d) integer array, at the
    reference's full resolution by default (min(62 // d, 16) bits)."""
    d = xint.shape[1]
    if nbits is None:
        nbits = max(1, min(62 // d, 16))
    return hilbert_index(xint, nbits)


def sort_nbits(N, d):
    """Bits per coordinate of a sort key: ceil((log2 N + 4) / d), at most
    62 // d and 16.  The curve need only be fine enough that each cell of
    the 2^(d nbits) grid holds O(1) points."""
    total = max(1, (N - 1).bit_length()) + 4
    return max(1, min(-(-total // d), 62 // d, 16))


def invlogit(x):
    """The logistic CDF."""
    return torch.sigmoid(x)


def _integerise(x, m, sd, nbits):
    """Each coordinate of ``x`` standardised by the given mean ``m`` and sd
    ``sd`` (each (d,)), squashed by the logistic CDF and cut into 2^nbits
    integer cells.  The single-device sort and the distributed one
    (``parallel.dqmc``, whose m and sd are global) both call it, so that
    given the same m and sd they give the same cells."""
    u = torch.sigmoid((x - m) / sd)
    return torch.floor(u * (1 << nbits)).clamp_(0, (1 << nbits) - 1).to(
        torch.int64)


def _standardise_and_integerise(x, nbits):
    """Each coordinate standardised (mean 0, population sd 1, as
    ``jnp.std``), squashed by the logistic CDF and cut into 2^nbits
    integer cells."""
    return _integerise(x, x.mean(0), x.std(0, correction=0) + 1e-30, nbits)


def hilbert_sort(x, nbits=None):
    """(N,) int64 indices that sort the particles ``x`` ((N,) or (N, d))
    along the Hilbert curve (``nbits`` bits a coordinate, by default
    :func:`sort_nbits`); points in one cell keep their order.  In 1-d the
    key is the points themselves."""
    if x.ndim == 1 or x.shape[1] == 1:
        key = x if x.ndim == 1 else x[:, 0]
    else:
        if nbits is None:
            nbits = sort_nbits(x.shape[0], x.shape[1])
        key = hilbert_index(_standardise_and_integerise(x, nbits), nbits)
    return torch.sort(key, stable=True).indices


def hilbert_sort_with(x, payloads, nbits=None):
    """The tuple ``payloads`` ((N, ...) tensors) in the Hilbert order of
    ``x``."""
    order = hilbert_sort(x, nbits)
    return tuple(p.index_select(0, order) for p in payloads)


def Hilbert_to_int(coords, nbits=None):
    """Hilbert index of one d-dimensional integer point, a Python int."""
    c = torch.from_numpy(np.asarray(coords, dtype=np.int64).reshape(1, -1))
    return int(hilbert_array(c, nbits)[0])
