"""The merge ring: inverse-CDF resampling of sorted uniforms over ranks.

Counterpart of ``particles_tpu/parallel/dqmc.py``'s ``_merge_serve_fn``
and ``ring_merge_resample``, which the multinomial ring rides: rank d
holds the d-th block of one globally sorted set of uniforms, and the
ancestor of each is the particle whose global normalised cumulative
weight first reaches it.  The distributed Hilbert sort and sorted-Sobol
serve of distributed SQMC (``dist_sort_with``, ``_dist_hilbert_keys``,
``dist_qmc_reorder``) are not ported (ROADMAP A.11b).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from particles_tpu_torch import ops

__all__ = ["ring_merge_resample"]


def _monotone_nonnegative(v):
    """The running max of float32 ``v >= 0``, by B6 on its bit patterns
    (a nonnegative float's int32 bits order as its value): one launch."""
    return ops.running_max(v.view(torch.int32)).view(torch.float32)


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
