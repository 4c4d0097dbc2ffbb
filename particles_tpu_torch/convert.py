"""Carry model parameters and data, given as numpy arrays, into the port's
objects, so that the JAX package and this one can be fed the same model.

Pull the arrays from a JAX model with ``np.asarray(getattr(ssm, k))`` —
for each ``default_params`` key of a zoo model, a ``LinearGauss`` or a
``GaussianHMM``, or ``F``, ``G``, ``covX``, ``covY``, ``mu0``, ``cov0`` of
an ``MVLinearGauss`` — and pass them here.  ``history_from_numpy``
carries a run's stacked history (``np.asarray`` of a JAX ``pf.hist.X``,
``.A`` and ``.lw``) into the port's ``ParticleHistory``, and
``theta_particles_from_numpy`` a sampler's ``ThetaParticles`` state
(``np.asarray`` of each θ field, each other per-particle field and each
``shared`` entry), ``nested_logistic_from_numpy`` a binary sampler's
proposal (``coeffs``, ``edgy``) and ``nested_state_from_numpy`` a vanilla
nested-sampling state (``arr``, ``lprior``, ``llik``, ``lZ``).
``rank_slice`` cuts a global array into one rank's slice of the particles,
and ``join_slices`` joins the ranks' slices back, so that a sharded run
and a single-device one (or the JAX package) see the same arrays.  Tensors
go to ``device``, by default the current CUDA card (with no card, pass
``device="cpu"``).  This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from particles_tpu_torch import binary_smc, hmm, kalman
from particles_tpu_torch import smc_samplers
from particles_tpu_torch import smoothing
from particles_tpu_torch import state_space_models as ssms
from particles_tpu_torch.utils import resolve_device

__all__ = ["ssm_from_params", "bootstrap_from_numpy", "history_from_numpy",
           "theta_particles_from_numpy", "nested_logistic_from_numpy",
           "nested_state_from_numpy", "rank_slice", "join_slices"]

_MODELS = {cls.__name__: cls for cls in (
    kalman.LinearGauss, kalman.MVLinearGauss,
    kalman.MVLinearGauss_Guarniero_etal, ssms.StochVol,
    ssms.StochVolLeverage, ssms.Gordon_etal, ssms.BearingsOnly,
    ssms.DiscreteCox, ssms.MVStochVol, ssms.ThetaLogistic, hmm.GaussianHMM)}
# the models whose constructor places its own tensors
_TAKE_DEVICE = (kalman.MVLinearGauss, kalman.MVLinearGauss_Guarniero_etal)


def ssm_from_params(cls_name, params, device=None):
    """The port's model ``cls_name`` (a zoo model, ``GaussianHMM`` or a
    Kalman model) built from ``params`` (a dict of numpy arrays).  Scalar
    parameters become Python numbers (a float32 value exactly, an integer
    an int); arrays become float32 tensors on ``device``."""
    try:
        cls = _MODELS[cls_name]
    except KeyError:
        raise NotImplementedError(
            f"model {cls_name!r} is not ported to particles_tpu_torch yet "
            "(ROADMAP A.5)") from None
    device = resolve_device(device)
    kwargs = {}
    for k, v in params.items():
        if v is None:
            kwargs[k] = None
            continue
        a = np.asarray(v)
        if a.ndim == 0:
            kwargs[k] = a.item()
        else:
            kwargs[k] = torch.tensor(a, dtype=torch.float32, device=device)
    if cls in _TAKE_DEVICE:
        kwargs["device"] = device
    return cls(**kwargs)


def bootstrap_from_numpy(ssm, data, device=None):
    """``Bootstrap(ssm, data)`` with ``data`` (numpy, (T,) or (T, dy)) as a
    float32 tensor on ``device``."""
    return ssms.Bootstrap(ssm=ssm, data=np.asarray(data), device=device)


def _tensor(a, device):
    """A numpy array (or scalar) as a tensor on ``device``: floating values
    as float32, others keeping their type."""
    a = np.asarray(a)
    dtype = torch.float32 if np.issubdtype(a.dtype, np.floating) else None
    return torch.tensor(a, dtype=dtype, device=device)


def history_from_numpy(fk, X, A, lw, device=None):
    """``ParticleHistory(fk, X, A, lw)`` from numpy arrays: ``X`` (T, N, ...)
    or a dict of such arrays, ``A`` (T, N) as int64, ``lw`` (T, N) as
    float32, on ``device``.  Floating particles become float32, others keep
    their type."""
    device = resolve_device(device)
    X = ({k: _tensor(v, device) for k, v in X.items()} if isinstance(X, dict)
         else _tensor(X, device))
    return smoothing.ParticleHistory(
        fk, X, torch.tensor(np.asarray(A), dtype=torch.int64, device=device),
        _tensor(lw, device))


def theta_particles_from_numpy(theta, fields=None, shared=None, device=None):
    """A ``smc_samplers.ThetaParticles`` from numpy arrays: ``theta`` a dict
    of (N,) or (N, d) arrays, ``fields`` a dict of the other per-particle
    arrays (``lpost``, ``llik``, ...), ``shared`` a dict of scalars or small
    arrays, on ``device``.  Floating values become float32 (``shared``
    scalars 0-d tensors), others keep their type."""
    device = resolve_device(device)
    return smc_samplers.ThetaParticles(
        theta={k: _tensor(v, device) for k, v in theta.items()},
        shared={k: _tensor(v, device) for k, v in (shared or {}).items()},
        **{k: _tensor(v, device) for k, v in (fields or {}).items()})


def nested_logistic_from_numpy(coeffs, edgy, device=None):
    """A ``binary_smc.NestedLogistic`` from numpy arrays: ``coeffs`` (d, d)
    as float32, ``edgy`` (d,) as bool, on ``device``."""
    device = resolve_device(device)
    return binary_smc.NestedLogistic(
        torch.tensor(np.asarray(coeffs), dtype=torch.float32, device=device),
        torch.tensor(np.asarray(edgy), dtype=torch.bool, device=device))


def nested_state_from_numpy(arr, lprior, llik, lZ, device=None):
    """A vanilla nested-sampling state as the tensors that
    ``NestedSampling._chunk`` takes: ``(arr (N, d), lprior (N,), llik (N,),
    lZ 0-d)``, all float32, on ``device``."""
    device = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a), dtype=torch.float32,
                              device=device)
                 for a in (arr, lprior, llik, lZ))


def rank_slice(a, rank, D, device=None):
    """Rank ``rank``'s slice, of D, of the global array ``a`` (numpy, split
    along its first axis, which D must divide), as a tensor on ``device``
    (floating values as float32)."""
    a = np.asarray(a)
    if a.shape[0] % D:
        raise ValueError(f"rank_slice: {a.shape[0]} rows do not split into "
                         f"{D} ranks")
    n = a.shape[0] // D
    return _tensor(a[rank * n:(rank + 1) * n], resolve_device(device))


def join_slices(slices, axis=0):
    """The global numpy array from the ranks' slices (tensors or arrays, in
    rank order), joined along ``axis`` (1 for a history's (T, N_local)
    frames)."""
    return np.concatenate([s.detach().cpu().numpy()
                           if isinstance(s, torch.Tensor) else np.asarray(s)
                           for s in slices], axis=axis)
