"""The mesh entry points: ``make_mesh``, ``particle_constrain``,
``run_sharded_smc`` and ``run_sharded_multismc``.

Counterpart of ``particles_tpu/parallel/sharded.py``.  The JAX package
builds a ``jax.sharding.Mesh`` and lets GSPMD partition the single-device
engine under sharding constraints.  PyTorch has no GSPMD, so here:

* a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
  of the initialised world, one process a rank (:func:`make_mesh`); every
  rank calls every function below, as with any collective;
* a mesh axis is the process group of that axis through this rank
  (``mesh.get_group(axis)``), and a particle axis runs
  :func:`particles_tpu_torch.parallel.run_shardmap_smc` over it: the
  engine on each rank's slice under a :mod:`particles_tpu_torch.distctx`
  context, with the collectives placed by hand;
* :func:`particle_constrain` is the hook of the JAX package's engine
  (``constrain(X, lw)``), which here changes nothing: a rank holds its own
  slice by construction.

Where GSPMD partitions any scheme, a scheme with no ring (``residual``,
``ssp``, ``killing``) is served by
:func:`particles_tpu_torch.parallel.distributed.gathered_resample`: one
all-gather of the weights, the scheme's z-form on every rank from the
replicated generator, then the z ring.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from particles_tpu_torch.parallel import comm, distributed

__all__ = ["make_mesh", "particle_constrain", "run_sharded_smc",
           "run_sharded_multismc"]


def make_mesh(n_devices=None, axis_names=("particles",), shape=None,
              device_type="cuda"):
    """A ``DeviceMesh`` over ranks ``0 .. n_devices - 1`` of the
    initialised world (all of them by default), laid out as ``shape``
    (``(n_devices,)`` by default) with the dimensions ``axis_names``, e.g.
    ``make_mesh(4, ("runs", "particles"), (2, 2))``.  ``device_type`` is
    ``"cuda"`` (one card a rank, as ``parallel.launch.spawn`` sets it) or
    ``"cpu"``.  Call it on every rank."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: n_devices={n}, the world has {world} "
                         "ranks")
    shape = (n,) if shape is None else tuple(shape)
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def particle_constrain(mesh, axis="particles", batch_axes=()):
    """The engine's layout hook: ``constrain(X, lw) -> (X, lw)`` on a
    rank's slices.  ``X`` (a tensor or a dict of tensors) and ``lw`` hold
    the rank's particles along the dimension after the ``batch_axes``
    leading ones; a rank already holds exactly its slice of ``axis``, so
    the hook returns them unchanged, after checking that every leaf of
    ``X`` has ``lw``'s leading shape up to that dimension (``ValueError``
    otherwise)."""
    del mesh, axis
    k = len(batch_axes) + 1

    def constrain(X, lw):
        for v in X.values() if isinstance(X, dict) else (X,):
            if tuple(v.shape[:k]) != tuple(lw.shape[:k]):
                raise ValueError(
                    f"particle_constrain: a leaf of X has shape "
                    f"{tuple(v.shape)}, lw {tuple(lw.shape)}")
        return X, lw

    return constrain


def run_sharded_smc(fk, N, seed=0, mesh=None, axis="particles", qmc=False,
                    resampling="systematic", ESSrmin=0.5, collect=None,
                    store_history=False):
    """One SMC run with its N particles sharded over the ``axis`` dimension
    of ``mesh`` (:func:`make_mesh`; None: every rank of the world).

    It is :func:`particles_tpu_torch.parallel.run_shardmap_smc` over that
    axis's group, except that every scheme of ``resampling.rs_funcs`` runs
    (a scheme with no ring through
    :func:`particles_tpu_torch.parallel.distributed.gathered_resample`).
    ``qmc=True`` runs distributed SQMC.  Returns ``(result, hist)`` as the
    JAX package does: ``result.hist`` is the rank's history object, and
    ``hist`` the rank's stacked ``(X, A, lw)`` frames for
    ``store_history=True`` (None otherwise)."""
    group = None if mesh is None else mesh.get_group(axis)
    res = distributed._run_sharded(fk, N, seed, group, resampling, ESSrmin,
                                   qmc, collect, store_history)
    raw = None
    if store_history is True and not getattr(fk, "is_sampler", False):
        raw = (res.hist.X, res.hist.A, res.hist.lw)
    return res, raw


def run_sharded_multismc(fk, N, nruns, seed=0, mesh=None, run_axis="runs",
                         particle_axis="particles", resampling="systematic",
                         ESSrmin=0.5):
    """``nruns`` independent runs on a 2-D (runs x particles) ``mesh``:
    the R ranks of the ``run_axis`` each take nruns / R runs (a row of the
    mesh takes runs ``[i nruns / R, (i + 1) nruns / R)``, i its coordinate
    on ``run_axis``), each run's N particles sharded over the row's
    ``particle_axis`` group.  Run r is seeded from ``seed`` and r alone (as
    in ``core.multiSMC``), so the results do not depend on the mesh.

    Returns ``(logLts, lws)``: ``logLts`` the (nruns,) log-likelihood
    estimates, the same on every rank (one all-gather over the run axis),
    and ``lws`` this rank's block of the final log-weights, (nruns / R,
    N / P) for P ranks on the particle axis.  ``ValueError`` when R does
    not divide nruns."""
    R = mesh.size(mesh.mesh_dim_names.index(run_axis))
    if nruns % R:
        raise ValueError(f"nruns={nruns} not divisible by the mesh's "
                         f"{run_axis!r} size {R}")
    row = mesh.get_local_rank(run_axis)
    seeder = torch.Generator().manual_seed(seed)
    run_seeds = torch.randint(0, 2 ** 62, (nruns,), generator=seeder)
    k = nruns // R
    group = mesh.get_group(particle_axis)
    logLts, lws = [], []
    for r in range(row * k, (row + 1) * k):
        res = distributed._run_sharded(fk, N, int(run_seeds[r]), group,
                                       resampling, ESSrmin, False, "off",
                                       False)
        logLts.append(res.logLt.reshape(()))
        lws.append(res.lw)
    return (comm.all_gather(torch.stack(logLts), mesh.get_group(run_axis)),
            torch.stack(lws))
