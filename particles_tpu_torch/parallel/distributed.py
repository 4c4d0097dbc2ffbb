"""The particle-sharded engine on ``torch.distributed``: ring resampling,
``run_shardmap_smc`` (filters, SQMC and the SMC samplers) and sharded
FFBS-MCMC.

Counterpart of ``particles_tpu/parallel/distributed.py``.  Every function
here is called on every rank of a process group (SPMD, one process a
rank; :func:`particles_tpu_torch.parallel.launch.spawn` starts them), each
rank holding global particles ``[rank * N_local, (rank + 1) * N_local)``.

* Per step, the only traffic is two scalar all-reduces, the global max
  and one fused pair of sums of :class:`resampling.Weights`.
* At a resampling step, the ring: each rank computes its slice of the
  global z-form from a (D,) table of the ranks' weight sums (one small
  all-gather), then each rank's (z, x) block travels around the ring, D
  hops and D - 1 shifts (:func:`comm.ring_shift`); at each hop a rank
  serves the outputs whose ancestors lie in the block it holds, by B2
  (``ops.repeat_cols``) on the block's z rebased to its own outputs.
  The running max that makes z nondecreasing is B6 (``ops.running_max``).
* The shared boundary table is the same on every rank, and each rank's z
  is clamped to its upper boundary AFTER the running max, its last entry
  pinned there, so the ranks' source ranges tile [0, M) exactly, with no
  gap and no output served twice, even where the float sums of two ranks
  differ by association.

Schemes: ``systematic`` (one shared uniform), ``stratified`` (counter-based
uniforms, a function of the global output index, :func:`counter_uniforms`)
and ``multinomial`` (one globally sorted set of uniforms made with no
communication: the boundary order statistics from the replicated
generator, each rank's interior from its own; served by the merge ring of
:mod:`particles_tpu_torch.parallel.dqmc`: B6 twice, then B5 and B2 a
hop).  Another scheme (``residual``, ``ssp``, ``killing``) has no ring:
:func:`run_sharded_smc <particles_tpu_torch.parallel.sharded.run_sharded_smc>`
serves it by :func:`gathered_resample` (the global weights gathered once,
the scheme's z-form on every rank, the z ring), while
:func:`run_shardmap_smc` refuses it, as the JAX package's does.
Distributed SQMC is in :mod:`particles_tpu_torch.parallel.dqmc`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from particles_tpu_torch import distctx
from particles_tpu_torch import ops
from particles_tpu_torch import resampling as rs
from particles_tpu_torch import smoothing
from particles_tpu_torch.parallel import comm

__all__ = ["RING_SCHEMES", "counter_uniforms", "ring_systematic_resample",
           "ring_stratified_resample", "ring_multinomial_resample",
           "gathered_resample", "ring_resample", "ring_serve",
           "run_shardmap_smc", "sharded_backward_mcmc"]

RING_SCHEMES = ("systematic", "stratified", "multinomial")


def _check_scheme(scheme):
    if scheme not in RING_SCHEMES:
        raise NotImplementedError(
            f"resampling scheme {scheme!r} is not supported under particle "
            "sharding (rings exist for systematic/stratified z-forms and the "
            "multinomial sorted-uniform merge; parallel.run_sharded_smc "
            "serves ssp/residual/killing by their gathered z-form)")


def _serve_z(z_blk, d, Mloc):
    """The z of a passing block on rank ``d``'s own outputs: ``clip(z_blk -
    d * Mloc, 0, Mloc)``, last entry pinned to ``Mloc``.  Served by it (B2),
    output ``j_loc`` gets ``X[#{k: z_blk_k <= d * Mloc + j_loc}]``, right
    for every output the block serves (the caller keeps only those)."""
    zp = (z_blk - d * Mloc).clamp_(0, Mloc)
    zp[-1:].fill_(Mloc)
    return zp


def ring_serve(x_loc, blk0, Nloc, Mloc, group, served_of, z_of,
               return_ancestors=False):
    """The D-hop ring of every resampler: rotate each rank's (``blk``,
    ``x``) around the ring; at hop s, holding origin e's block (``e = (rank
    - s) % D``), overwrite the outputs ``served_of(e)`` (a bool (Mloc,)
    mask) with the block served by ``z_of(blk)`` (B2, every leaf and the
    ancestors in one launch per eight leaves).  The callers' boundary
    tables tile the outputs, so each is served by exactly one hop.

    ``Nloc`` sources and ``Mloc`` outputs a rank.  Returns the served
    particles (as ``x_loc``: a tensor or a dict of tensors), and with
    ``return_ancestors`` also the rank's slice of the global ancestor
    vector (``e * Nloc`` plus the block's local ancestor; int64)."""
    D, d = dist.get_world_size(group), dist.get_rank(group)
    leaves = [v.contiguous() for v in smoothing._leaves(x_loc)]
    y = [v.new_zeros((Mloc,) + v.shape[1:]) for v in leaves]
    A = (torch.full((Mloc,), -1, dtype=torch.int64, device=blk0.device)
         if return_ancestors else None)
    blk = blk0
    for s in range(D):
        e = (d - s) % D
        served = served_of(e)
        vals, A_blk = ops.repeat_cols(z_of(blk), Mloc, leaves,
                                      want_anc=return_ancestors)
        y = [torch.where(served.reshape((-1,) + (1,) * (v.ndim - 1)), v, acc)
             for v, acc in zip(vals, y)]
        if return_ancestors:
            A = torch.where(served, A_blk + e * Nloc, A)
        if s < D - 1:
            blk, *leaves = comm.ring_shift([blk] + leaves, group)
    y = smoothing._rebuild(x_loc, y)
    return (y, A) if return_ancestors else y


def _shard_table(W_loc, group):
    """``(cum_loc, prefix, S)``: the rank's cumulative weights, the (D,)
    exclusive prefix of the ranks' sums and their total, from one (D,)
    all-gather; prefix and S are the same on every rank."""
    cum_loc = torch.cumsum(W_loc, 0)
    all_s = comm.all_gather(cum_loc[-1], group)
    S = all_s.sum()
    return cum_loc, torch.cumsum(all_s, 0) - all_s, S


def _tile(z_loc, zb, M, d):
    """The boundary table ``zb_ext`` ((D + 1,): ``zb`` with its first entry
    0, then M) and the rank's z made nondecreasing (B6), clamped to its
    upper boundary and pinned there."""
    zb[:1].fill_(0)
    zb_ext = torch.cat([zb, zb.new_full((1,), M)])
    z_loc = torch.minimum(ops.running_max(z_loc), zb_ext[d + 1])
    z_loc[-1:].copy_(zb_ext[d + 1:d + 2])
    return z_loc, zb_ext


def _z_ring(x_loc, z_loc, zb_ext, Nloc, M, group, return_ancestors):
    """Serve by the global z-form: hop e serves the outputs ``j`` in
    ``[zb_ext[e], zb_ext[e + 1])``."""
    D, d = dist.get_world_size(group), dist.get_rank(group)
    Mloc = M // D
    j = d * Mloc + torch.arange(Mloc, dtype=torch.int32, device=z_loc.device)
    return ring_serve(
        x_loc, z_loc, Nloc, Mloc, group,
        served_of=lambda e: (j >= zb_ext[e]) & (j < zb_ext[e + 1]),
        z_of=lambda z_blk: _serve_z(z_blk, d, Mloc),
        return_ancestors=return_ancestors)


def _check_M(M, D):
    if M % D:
        raise ValueError(f"M={M} not divisible by the group's size {D}")


def ring_systematic_resample(x_loc, W_loc, u, M, group=None,
                             return_ancestors=False):
    """Systematic resampling of M particles in all, sharded over ``group``.

    Call on every rank.  ``x_loc``: the rank's particles (leading
    dimension N_local; a tensor or a dict of tensors); ``W_loc``: its slice
    of the globally normalised weights (``Weights.W`` under a context);
    ``u``: the shared uniform (the same on every rank).  Returns the
    rank's M/D served particles, the global result of the single-device
    z-form (sorted ancestors); with ``return_ancestors`` also the rank's
    slice of the global ancestor vector.  The JAX package's ring takes the
    log-weights and normalises them itself; here the engine's ``Weights``
    has already done so, which saves an all-reduce."""
    D, d = dist.get_world_size(group), dist.get_rank(group)
    _check_M(M, D)
    cum_loc, prefix, S = _shard_table(W_loc, group)
    zb = (torch.floor(M * prefix / S - u).to(torch.int32) + 1).clamp_(0, M)
    z_loc = (torch.floor(M * (prefix[d] + cum_loc) / S - u).to(torch.int32)
             + 1).clamp_(0, M)
    z_loc, zb_ext = _tile(z_loc, zb, M, d)
    return _z_ring(x_loc, z_loc, zb_ext, W_loc.shape[0], M, group,
                   return_ancestors)


_GOLDEN_I64 = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX1_I64 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2_I64 = 0x94D049BB133111EB - (1 << 64)


def _srl(x, s):
    """Logical right shift of int64 ``x`` by ``s`` bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def counter_uniforms(seed, k):
    """Counter-based uniforms: ``u_k`` is the top 24 bits, over 2^24, of
    SplitMix64's first output from the state ``seed + (k + 1) *
    0x9E3779B97F4A7C15`` (int64 arithmetic, wrapping).  A function of
    (seed, k) alone, so every rank evaluates the same ``u_k`` at the same
    global index k, with no (M,) vector and no communication.  ``seed``: an
    int64 tensor (0-d) or int; ``k``: an integer tensor.  float32 in
    [0, 1).  (The JAX package's ``_counter_uniforms`` draws
    ``uniform(fold_in(key, k))`` by threefry; these are the port's own.)"""
    x = seed + (k.to(torch.int64) + 1) * _GOLDEN_I64
    x = (x ^ _srl(x, 30)) * _MIX1_I64
    x = (x ^ _srl(x, 27)) * _MIX2_I64
    x = x ^ _srl(x, 31)
    return _srl(x, 40).to(torch.float32) * 2.0 ** -24


def ring_stratified_resample(x_loc, W_loc, gen, M, group=None,
                             return_ancestors=False, uniforms=None):
    """Stratified resampling of M particles in all, sharded over
    ``group``: the ring of :func:`ring_systematic_resample` on the
    stratified z-form ``z_i = k_i + 1[u_{k_i} <= g_i - k_i]``, ``g_i = M
    cs_i``, ``k_i = floor(g_i)``, with per-output uniforms ``u_k =
    uniforms(k)`` (k an int32 tensor of global output indices).  By
    default they are :func:`counter_uniforms` with a seed drawn from
    ``gen``, the REPLICATED generator; tests pass the JAX package's
    table.  The boundary table, running max and clamp after it are the
    systematic ring's."""
    D, d = dist.get_world_size(group), dist.get_rank(group)
    _check_M(M, D)
    if uniforms is None:
        seed = torch.randint(0, 2 ** 62, (), generator=gen,
                             device=W_loc.device, dtype=torch.int64)
        uniforms = lambda k: counter_uniforms(seed, k)  # noqa: E731
    cum_loc, prefix, S = _shard_table(W_loc, group)
    gb = M * prefix / S
    kb = torch.floor(gb).to(torch.int32)
    ub = uniforms(kb.clamp(0, M - 1))
    zb = (kb + (ub <= gb - kb).to(torch.int32)).clamp_(0, M)
    g = M * (prefix[d] + cum_loc) / S
    kk = torch.floor(g).to(torch.int32)
    uk = uniforms(kk.clamp(0, M - 1))
    z_loc = torch.where(kk >= M, M, kk + (uk <= g - kk).to(torch.int32))
    z_loc, zb_ext = _tile(z_loc.clamp_(0, M), zb, M, d)
    return _z_ring(x_loc, z_loc, zb_ext, W_loc.shape[0], M, group,
                   return_ancestors)


def sorted_uniform_block(gen, rank_gen, M, D, d, device):
    """Rank ``d``'s block of M/D of one globally sorted set of M uniforms,
    made with no communication by the order-statistics decomposition:

    * the D - 1 boundaries ``V_e = U_(e M/D)`` come from the REPLICATED
      generator ``gen`` (the same on every rank), the Beta chain
      ``(V_{e+1} - V_e) / (1 - V_e) ~ Beta(M/D, M - (e + 1) M/D + 1)``, each
      Beta a ratio of gammas, in float64;
    * given them, a block's interior points are sorted uniforms on (V_d,
      V_{d+1}) from the rank's own generator ``rank_gen``, the block's
      last point the boundary itself; the top rank's M/D points all lie
      in (V_{D-1}, 1).
    """
    Mloc = M // D
    V = torch.zeros(D + 1, dtype=torch.float64, device=device)
    V[-1:].fill_(1.0)
    if D > 1:
        e = torch.arange(D - 1, dtype=torch.float64, device=device)
        ga = torch._standard_gamma(torch.full_like(e, Mloc), generator=gen)
        gb = torch._standard_gamma(M - (e + 1) * Mloc + 1, generator=gen)
        V[1:D] = 1.0 - torch.cumprod(gb / (ga + gb), 0)
    V = V.to(torch.float32)
    lo, hi = V[d], V[d + 1]
    if d == D - 1:
        return lo + (1.0 - lo) * rs.uniform_spacings(rank_gen, Mloc)
    inner = rs.uniform_spacings(rank_gen, Mloc - 1)
    return torch.cat([lo + (hi - lo) * inner, hi.reshape(1)])


def ring_multinomial_resample(x_loc, W_loc, gen, rank_gen, M, group=None,
                              return_ancestors=False):
    """Multinomial (sorted-ancestor) resampling of M particles in all,
    sharded over ``group``: the rank's block of one globally sorted set of
    uniforms (:func:`sorted_uniform_block`: the boundaries from ``gen``,
    the replicated generator, the interior from ``rank_gen``, the rank's)
    served by the merge ring
    (:func:`particles_tpu_torch.parallel.dqmc.ring_merge_resample`)."""
    from particles_tpu_torch.parallel import dqmc

    D, d = dist.get_world_size(group), dist.get_rank(group)
    _check_M(M, D)
    su = sorted_uniform_block(gen, rank_gen, M, D, d, W_loc.device)
    return dqmc.ring_merge_resample(x_loc, su, W_loc, group,
                                    return_ancestors)


def gathered_resample(scheme, gen, x_loc, W_loc, M, group=None,
                      return_ancestors=False):
    """Resampling of M particles in all by a scheme with no ring
    (``residual``, ``ssp``, ``killing``, or any of ``resampling.rs_funcs``),
    sharded over ``group``: one all-gather of the weights, then on every
    rank the scheme's z-form of the global weights from ``gen`` (the
    REPLICATED generator, so that every rank computes the same z; a
    scheme without one, ``killing``, gives its ancestors, whose sorted
    order serves the same offspring counts), then the z ring
    (:func:`_z_ring`: D hops of B2, D - 1 shifts).  Returns what
    :func:`ring_systematic_resample` returns."""
    D, d = dist.get_world_size(group), dist.get_rank(group)
    _check_M(M, D)
    Nloc = W_loc.shape[0]
    W = comm.all_gather(W_loc, group)
    if scheme in rs.rs_counts_funcs:
        z = rs.resampling_z(scheme, gen, W, M)
    else:
        A = rs.resampling(scheme, gen, W, M)
        z = torch.cumsum(torch.bincount(A, minlength=W.shape[0]), 0).to(
            torch.int32)
    zb_ext = torch.cat([z.new_zeros(1), z[Nloc - 1::Nloc]])
    return _z_ring(x_loc, z[d * Nloc:(d + 1) * Nloc].contiguous(), zb_ext,
                   Nloc, M, group, return_ancestors)


def ring_resample(scheme, gen, x_loc, W_loc, M, return_ancestors=False):
    """The engine's resampling under a :mod:`particles_tpu_torch.distctx`
    context: the ring of ``scheme``, its shared draws from ``gen`` (the
    run's replicated generator), over the context's group; a scheme with
    no ring goes through :func:`gathered_resample`."""
    ctx = distctx.current()
    if scheme not in RING_SCHEMES:
        return gathered_resample(scheme, gen, x_loc, W_loc, M, ctx.group,
                                 return_ancestors)
    if scheme == "systematic":
        u = torch.rand((), generator=gen, device=W_loc.device)
        return ring_systematic_resample(x_loc, W_loc, u, M, ctx.group,
                                        return_ancestors)
    if scheme == "stratified":
        return ring_stratified_resample(x_loc, W_loc, gen, M, ctx.group,
                                        return_ancestors)
    return ring_multinomial_resample(x_loc, W_loc, gen, ctx.gen, M,
                                     ctx.group, return_ancestors)


def run_shardmap_smc(fk, N, seed=0, group=None, resampling="systematic",
                     ESSrmin=0.5, qmc=False, collect=None,
                     store_history=False):
    """Run the SMC engine with its N particles sharded over ``group``.

    Call on every rank of the group (an initialised ``torch.distributed``
    process group; None for the default one), with the same arguments.
    Each rank runs :class:`particles_tpu_torch.core.SMC` on its N/D
    particles under a :mod:`particles_tpu_torch.distctx` context, so every
    feature of the single-device engine behaves as there:

    * bootstrap, guided and auxiliary filters (an auxiliary filter's reset
      weights are recomputed from the served particles);
    * adaptive resampling through the ring of ``resampling``
      (``systematic``, ``stratified`` or ``multinomial``), on a decision
      that reads the all-reduced ESS, the same on every rank;
    * SQMC (``qmc=True``; the global N a power of two): the rank's rows of
      one globally sorted Sobol set, the merge ring, the distributed
      Hilbert sort (:mod:`particles_tpu_torch.parallel.dqmc`);
    * the SMC samplers (``fk.is_sampler``: IBIS, tempering, adaptive
      tempering, NS-SMC, SMC²), through the same ``SMC`` on the rank's
      slice: N is the global number of starting points, a rank carries
      ``fk.N0(N / D)`` particles (:func:`smc_samplers.sampler_next`);
    * the collectors that are ``dist_safe`` (the default ESSs, logLts and
      rs_flags, and ``Moments``, whose moments are global); a sampler
      takes any collector, and its history, on the step's gathered
      particles;
    * the history (``store_history``: full, rolling or partial) of the
      rank's slices, with GLOBAL ancestor indices (a sampler's
      ``SamplerHistory`` holds the global particles).

    The run's generator, seeded by ``seed``, is replicated: it draws the
    resampling uniforms and SQMC's points.  The model's and the moves'
    draws come from the rank's generator (:func:`distctx.rank_generator`
    of ``seed`` and the rank).

    Returns an :class:`particles_tpu_torch.core.SMCResult`: ``logLt`` and
    the collectors' records (the same on every rank), ``X`` and ``lw``,
    the rank's final particles and log-weights (for a sampler, its
    ``ThetaParticles`` slice, whose ``shared`` entries are the same on
    every rank), and ``hist``, the rank's history (feed a full one to
    :func:`sharded_backward_mcmc`).

    Raises ``NotImplementedError`` for another scheme (see
    :func:`particles_tpu_torch.parallel.sharded.run_sharded_smc`), for a
    filter's collector that is not ``dist_safe`` and for SQMC at a global
    N that is not a power of two, and ``ValueError`` when D does not
    divide N.
    """
    _check_scheme(resampling)
    return _run_sharded(fk, N, seed, group, resampling, ESSrmin, qmc,
                        collect, store_history)


def _run_sharded(fk, N, seed, group, resampling, ESSrmin, qmc, collect,
                 store_history):
    """:func:`run_shardmap_smc` with any scheme of ``resampling.rs_funcs``
    (one with no ring goes through :func:`gathered_resample`)."""
    from particles_tpu_torch import core

    D, d = dist.get_world_size(group), dist.get_rank(group)
    if N % D:
        raise ValueError(f"N={N} not divisible by the group's size {D}")
    pf = core.SMC(fk=fk, N=N // D, seed=seed, resampling=resampling,
                  ESSrmin=ESSrmin, qmc=qmc, collect=collect,
                  store_history=store_history)
    cols = [] if pf.summaries is None else pf.summaries._collectors
    bad = [type(c).__name__ for c in cols
           if not getattr(c, "dist_safe", False)]
    if bad and not pf.is_sampler:
        raise NotImplementedError(
            f"run_shardmap_smc: collector(s) {bad} are not supported under "
            "particle sharding (genealogy-walking / stateful collectors "
            "need cross-shard gathers); run them on a single device")
    with distctx.dist_context(group, distctx.rank_generator(seed, d,
                                                            pf.device)):
        pf.run()
    sm = {c.summary_name: getattr(pf.summaries, c.summary_name)
          for c in cols}
    return core.SMCResult(pf.logLt, sm, lw=pf.wgts.lw, cpu_time=pf.cpu_time,
                          hist=pf.hist, X=pf.X)


def sharded_backward_mcmc(hist, M, seed=0, group=None, nsteps=1):
    """FFBS-MCMC (independent Metropolis, Dau & Chopin 2022) over a history
    sharded over ``group``: ``hist`` is the rank's
    :class:`smoothing.ParticleHistory` of a :func:`run_shardmap_smc` run
    (its (T, N_local) slices, global ancestors).  Call on every rank.

    Each rank runs M/D trajectories.  A backward step all-gathers one
    frame (every leaf of X, ``lw_t`` and ``A_{t+1}``: L + 2 all-gathers
    for L leaves), and nothing else: no all-reduce, no ring.  The
    high-water mark a rank is its history plus O(N).  The iid proposals
    are drawn, with the acceptance uniforms, from the rank's generator
    (:func:`distctx.rank_generator` of ``seed`` and the rank); iid
    proposals are exchangeable across ranks, so the sharded pass targets
    the law of :meth:`smoothing.ParticleHistory.backward_sampling_mcmc`.

    Returns the rank's (T, M/D, ...) paths (a tensor or a dict of
    tensors).
    """
    D, d = dist.get_world_size(group), dist.get_rank(group)
    _check_M(M, D)
    Mloc = M // D
    fk, T = hist.fk, hist.T
    gen = distctx.rank_generator(seed, d, hist.lw.device)

    def frame(t):
        return smoothing._rebuild(hist.X, [comm.all_gather(v[t], group)
                                 for v in smoothing._leaves(hist.X)])

    xg_next = frame(T - 1)
    idx_next = rs.multinomial_iid(
        gen, rs.exp_and_normalise(comm.all_gather(hist.lw[-1], group)), Mloc)
    paths = [smoothing._take(xg_next, idx_next)]
    for t in range(T - 2, -1, -1):
        xg_t = frame(t)
        cs = rs.pinned_cdf(rs.exp_and_normalise(
            comm.all_gather(hist.lw[t], group)))
        A_g = comm.all_gather(hist.A[t + 1], group)
        xn = smoothing._take(xg_next, idx_next)
        idx_t = A_g.index_select(0, idx_next)
        lp_cur = fk.logpt(t + 1, smoothing._take(xg_t, idx_t), xn)
        for _ in range(nsteps):
            prop, vals = rs.draw_by_cdf(gen, cs, smoothing._leaves(xg_t), Mloc)
            lp_prop = fk.logpt(t + 1, smoothing._rebuild(xg_t, vals), xn)
            lu = torch.log(torch.rand(Mloc, generator=gen, device=cs.device))
            accept = lu < lp_prop - lp_cur
            idx_t = torch.where(accept, prop, idx_t)
            lp_cur = torch.where(accept, lp_prop, lp_cur)
        paths.append(smoothing._take(xg_t, idx_t))
        idx_next, xg_next = idx_t, xg_t
    paths.reverse()
    return smoothing._stack(paths)
