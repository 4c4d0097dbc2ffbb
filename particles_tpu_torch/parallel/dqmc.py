"""Distributed SQMC: the merge ring and the distributed Hilbert sort.

Counterpart of ``particles_tpu/parallel/dqmc.py``.  SQMC needs two global
orders a step that a rank's slice alone cannot give: the inverse-CDF
serve pairs the globally sorted first Sobol coordinate with the global
cumulative weights, and the particles are kept in the global Hilbert
order.  Here:

* each rank draws its rows ``[rank N_local, (rank + 1) N_local)`` of one
  globally sorted Sobol set (``rqmc.sobol_sorted0`` with ``start`` and
  ``count``, from the replicated generator): no communication;
* :func:`ring_merge_resample` serves them, rank d holding the d-th block
  of one globally sorted set of uniforms (the multinomial ring rides it
  too): the ancestor of each is the particle whose global normalised
  cumulative weight first reaches it;
* :func:`dist_sort_with` sorts (key, payloads) globally by odd-even block
  transposition: one stable local sort, then D merge-split rounds, each
  one :func:`comm.exchange` with a partner; :func:`dist_qmc_reorder`
  sorts the particles by their Hilbert keys (:func:`_dist_hilbert_keys`,
  standardised by global sums).

The key is the port's one int64 Hilbert index (``hilbert.hilbert_index``),
where the JAX package sorts by two uint32 words; the order is the same.
Every function is called on every rank of the group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from particles_tpu_torch import hilbert
from particles_tpu_torch import ops
from particles_tpu_torch.parallel import comm
from particles_tpu_torch.resampling import _monotone_nonnegative

__all__ = ["dist_sort_with", "dist_qmc_reorder", "ring_merge_resample"]


def _round_pairing(D, r):
    """The pairs of odd-even transposition round ``r`` over D ranks:
    ``(partner, keep_lower)``, ``partner[i]`` the rank that rank i merges
    with (None: it sits the round out) and ``keep_lower[i]`` whether it
    keeps the lower half (it is the lower rank of its pair)."""
    partner = [None] * D
    keep_lower = [False] * D
    for i in range(r % 2, D - 1, 2):
        partner[i], partner[i + 1] = i + 1, i
        keep_lower[i] = True
    return partner, keep_lower


def _take(order, tensors):
    return [t.index_select(0, order) for t in tensors]


def dist_sort_with(key, payloads, group=None):
    """Sort ``key`` ((N_local,), any sortable dtype) and the tensors
    ``payloads`` ((N_local, ...) each) globally by ``key``, leaving rank d
    with the d-th block of N_local: ``(key, payloads)`` sorted.

    Odd-even block transposition: one stable local sort, then D
    merge-split rounds (by the 0-1 principle D rounds sort D sorted
    blocks).  In a round the two partners swap their blocks (one
    :func:`comm.exchange`), both concatenate them with the LOWER rank's
    block first and sort stably, and the lower rank keeps the first half:
    tied keys split the same way on both, so every element is kept
    exactly once, and the result is that of one stable sort of the
    global arrays."""
    order = torch.sort(key, stable=True).indices
    key, *rest = _take(order, [key, *payloads])
    D, d = dist.get_world_size(group), dist.get_rank(group)
    n = key.shape[0]
    for r in range(D):
        partner, keep_lower = _round_pairing(D, r)
        if partner[d] is None:
            continue
        mine = [key, *rest]
        theirs = comm.exchange(mine, partner[d], group)
        lower, upper = (mine, theirs) if keep_lower[d] else (theirs, mine)
        both = [torch.cat([a, b]) for a, b in zip(lower, upper)]
        order = torch.sort(both[0], stable=True).indices
        key, *rest = _take(order[:n] if keep_lower[d] else order[n:], both)
    return key, tuple(rest)


def _dist_moments(X, group=None):
    """The global mean and population sd of each column of the rank's
    (N_local, d) ``X``, by one fused all-reduce of the sums of x and x^2,
    as the JAX package takes them: ``sd = sqrt(max(s2 / n - m^2, 0)) +
    1e-30``."""
    n = X.shape[0] * dist.get_world_size(group)
    s1, s2 = comm.psum(X.sum(0), (X * X).sum(0), group=group)
    m = s1 / n
    return m, torch.sqrt(torch.clamp(s2 / n - m * m, min=0.0)) + 1e-30


def _dist_hilbert_keys(X, group=None):
    """The Hilbert keys of the rank's particles ``X`` ((N_local,) or
    (N_local, d)), standardised by the GLOBAL mean and sd
    (:func:`_dist_moments`) with ``nbits = sort_nbits(N_local D, d)``, so
    that every rank cuts cells of one bounding box: given the same m and
    sd they are the keys a single device gives the joined particles
    (``hilbert._integerise``).  In 1-d the key is the particle itself."""
    if X.ndim == 1:
        return X
    if X.shape[1] == 1:
        return X[:, 0]
    nbits = hilbert.sort_nbits(X.shape[0] * dist.get_world_size(group),
                               X.shape[1])
    m, sd = _dist_moments(X, group)
    return hilbert.hilbert_index(hilbert._integerise(X, m, sd, nbits), nbits)


def dist_qmc_reorder(X, extras, group=None):
    """The rank's particles ``X`` ((N_local,) or (N_local, d)) and the
    (N_local, ...) tensors ``extras`` in the GLOBAL Hilbert order of the
    particles, rank d ending with the d-th block: ``(X, extras)``, the
    distributed counterpart of ``core._qmc_reorder``."""
    _, (X, *rest) = dist_sort_with(_dist_hilbert_keys(X, group),
                                   (X,) + tuple(extras), group)
    return X, tuple(rest)


def _merge_serve_z(su_loc, cs_blk, Mloc):
    """The z of one passing block for the rank's ``Mloc`` sorted uniforms:
    ``z_k = #{j: su_loc[j] <= cs_blk[k]}`` (B5; nondecreasing, as both its
    inputs are), the last entry pinned to ``Mloc``.  Served by z (B2), an
    output gets ``X[min{k: su_loc[j] <= cs_blk[k]}]``: the inverse-CDF rule
    restricted to the block, right for every output whose ancestor lies in
    it (the caller keeps only those)."""
    z = ops.merge_rank_counts(su_loc, cs_blk, Mloc)
    z[-1:].fill_(Mloc)
    return z


def ring_merge_resample(x_loc, su_loc, W_loc, group=None,
                        return_ancestors=False):
    """Inverse-CDF resampling of particles sharded over ``group``.

    Call on every rank.  ``x_loc``: the rank's particles (a tensor with
    leading dimension N_local, or a dict of such tensors); ``su_loc``:
    the rank's block (Mloc,) of one globally sorted set of uniforms;
    ``W_loc``: the rank's slice of the globally normalised weights.
    Returns the rank's Mloc served particles; with ``return_ancestors``
    also its (Mloc,) slice of the global ancestor vector (int64).

    The ring rotates each rank's (cs, x) block; the hop holding origin
    e's block serves the outputs whose uniform falls in ``(B[e], B[e +
    1]]``, B the shared table of the ranks' boundary cumulative weights,
    the same on every rank (each rank's cs is clamped to, and pinned at,
    its boundary), so the hops tile the outputs exactly even where float
    sums differ by association.  Communication: one (D,) all-gather and
    D - 1 ring shifts; the uniforms below B[0] = 0, which only a zero
    spacing makes, go to the first particle.

    B5 takes sorted uniforms and nondecreasing cumulative weights, and a
    float cumsum on the card can leave either an ulp out of order; so
    both are made monotone once, before the ring, by a running max (B6 on
    their bits; it changes nothing on inputs already in order).  The JAX
    package instead takes the running max of each hop's z.
    """
    from particles_tpu_torch.parallel.distributed import (_shard_table,
                                                          ring_serve)

    d = dist.get_rank(group)
    Mloc = su_loc.shape[0]
    Nloc = W_loc.shape[0]
    cum_loc, prefix, S = _shard_table(W_loc, group)
    B = torch.cat([prefix / S, prefix.new_ones(1)])    # (D + 1,)
    cs_loc = torch.minimum(_monotone_nonnegative((prefix[d] + cum_loc) / S),
                           B[d + 1])
    cs_loc[-1:].copy_(B[d + 1:d + 2])
    su_loc = _monotone_nonnegative(su_loc.contiguous())
    lower = B.clone()
    lower[:1].fill_(-torch.inf)
    return ring_serve(
        x_loc, cs_loc, Nloc, Mloc, group,
        served_of=lambda e: (su_loc > lower[e]) & (su_loc <= B[e + 1]),
        z_of=lambda cs_blk: _merge_serve_z(su_loc, cs_blk, Mloc),
        return_ancestors=return_ancestors)
