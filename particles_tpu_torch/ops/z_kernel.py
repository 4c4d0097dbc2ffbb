"""Systematic z-form of normalised weights: CUDA kernel and plain version.

Replaces the TPU kernel ``particles_tpu/ops/z_kernel.py::_z_kernel``
(public function ``systematic_z_fused``).  The function, for weights
``W >= 0`` and a uniform ``u``::

    S = sum(W);  scale = 2^30 / max(S, 1e-37)          (f32)
    q = round(W * scale)  (half to even, int64);  Q = sum(q)
    z = clip(floor(f32(cumsum(q)) * (M / max(Q, 1)) - u) + 1, 0, M)
    z[-1] = M

``z`` is int32, nondecreasing by construction (the integer cumsum is
exact and every later stage is monotone), and within 1 of the float64
answer ``floor(M * cumsum(W) / sum(W) - u) + 1``.

On this card the kernel (``csrc/z_kernel.cu``) is bound by bytes: it
reads W three times and writes z, and at N = 2^20 the W re-reads come
from L2.  Its design, and how it differs from the TPU tiling, is in the
source's header.
"""

from __future__ import annotations

import ctypes

import torch

from particles_tpu_torch import _build

__all__ = ["systematic_z_fused", "systematic_z_plain"]

_SCALE = float(1 << 30)   # fixed-point grid

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("z_kernel")
        lib.pt_z_tile.argtypes = []
        lib.pt_z_tile.restype = ctypes.c_int
        lib.pt_systematic_z.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.pt_systematic_z.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(W, u, M):
    if not isinstance(W, torch.Tensor):
        raise TypeError("systematic_z: W must be a torch.Tensor")
    if W.dtype != torch.float32:
        raise TypeError(f"systematic_z: W must be float32, got {W.dtype}")
    if W.ndim != 1 or W.shape[0] < 1:
        raise ValueError(f"systematic_z: W must be (N,) with N >= 1, "
                         f"got shape {tuple(W.shape)}")
    if not W.is_contiguous():
        raise ValueError("systematic_z: W must be contiguous")
    if not (isinstance(M, int) and 1 <= M < 2**31):
        raise ValueError(f"systematic_z: M must be an int in [1, 2^31), "
                         f"got {M!r}")
    u = torch.as_tensor(u, dtype=torch.float32, device=W.device)
    if u.numel() != 1:
        raise ValueError("systematic_z: u must be one number")
    return u.reshape(())


def systematic_z_plain(W, u, M):
    """The same fixed-point algorithm in plain PyTorch (any device)."""
    u = torch.as_tensor(u, dtype=torch.float32, device=W.device)
    S = W.sum(dtype=torch.float64).to(torch.float32)
    scale = torch.tensor(_SCALE, dtype=torch.float32,
                         device=W.device) / S.clamp_min(1e-37)
    q = torch.round(W * scale).to(torch.int64)
    csq = torch.cumsum(q, 0)
    minv = torch.tensor(float(M), dtype=torch.float32,
                        device=W.device) / csq[-1].to(torch.float32).clamp_min(1.0)
    z = torch.floor(csq.to(torch.float32) * minv - u).to(torch.int64) + 1
    z = z.clamp_(0, M).to(torch.int32)
    z[-1] = M
    return z


def systematic_z_fused(W, u, M):
    """Systematic z-form of ``W`` ((N,) float32, >= 0) with uniform ``u``:
    (N,) int32, nondecreasing, ``z[-1] == M``.

    A CPU tensor goes to :func:`systematic_z_plain`; a CUDA tensor to the
    kernel, which raises if it cannot build or launch.  ``u`` may be a
    Python float or a one-element tensor; a device tensor is read by the
    kernel, with no host sync.
    """
    u = _check(W, u, M)
    if W.device.type == "cpu":
        return systematic_z_plain(W, u, M)
    if W.device.type != "cuda":
        raise ValueError(f"systematic_z: no kernel for device {W.device}")
    lib = _kernels()
    N = W.shape[0]
    nb = -(-N // lib.pt_z_tile())
    z = torch.empty(N, dtype=torch.int32, device=W.device)
    part = torch.empty(nb, dtype=torch.float64, device=W.device)
    bq = torch.empty(nb, dtype=torch.int64, device=W.device)
    scal = torch.empty(2, dtype=torch.float32, device=W.device)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.pt_systematic_z(W.data_ptr(), N, M, u.data_ptr(),
                                  z.data_ptr(), part.data_ptr(),
                                  bq.data_ptr(), scal.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"systematic_z kernel launch failed: CUDA error "
                           f"{err}")
    systematic_z_fused.launches += 1
    return z


systematic_z_fused.launches = 0   # kernel launches, for tracing the path
