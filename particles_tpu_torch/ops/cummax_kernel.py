"""Inclusive running maximum of int32 (B6): CUDA kernel and plain version.

Replaces the TPU kernel ``particles_tpu/ops/cummax_kernel.py::
_cummax_kernel`` (public function ``running_max``), which enforces the
nondecreasing z contract where a z-form is built from a float cumsum
(``resampling._monotone_z``).  Exact.

On this card the kernel (``csrc/cummax_kernel.cu``) is bound by bytes: a
scan across blocks in three launches (block maxima, a one-block scan of
them, each block's scan from its prefix).
"""

from __future__ import annotations

import ctypes

import torch

from particles_tpu_torch import _build
from particles_tpu_torch.ops._launch import on_device

__all__ = ["running_max", "running_max_plain"]

_lib = None
_tile = None   # elements per streaming block, read once at load


def _kernels():
    global _lib, _tile
    if _lib is None:
        lib = _build.load("cummax_kernel")
        lib.pt_cummax_tile.argtypes = []
        lib.pt_cummax_tile.restype = ctypes.c_int
        _tile = lib.pt_cummax_tile()
        lib.pt_running_max.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.pt_running_max.restype = ctypes.c_int
        _lib = lib
    return _lib


def running_max_plain(z):
    """Plain PyTorch version of :func:`running_max` (any device)."""
    return torch.cummax(z, 0).values


def running_max(z):
    """Inclusive running maximum of ``z`` ((N,) int32): (N,) int32.

    A CPU tensor goes to :func:`running_max_plain`; a CUDA tensor to the
    kernel, which raises if it cannot build or launch.  There ``y`` is a
    view of the start of one allocation whose tail held the block maxima.
    """
    if not isinstance(z, torch.Tensor) or z.dtype != torch.int32:
        raise TypeError("running_max: z must be an int32 tensor")
    if z.ndim != 1 or z.shape[0] < 1 or not z.is_contiguous():
        raise ValueError("running_max: z must be contiguous (N,) with N >= 1")
    if z.device.type == "cpu":
        return running_max_plain(z)
    if z.device.type != "cuda":
        raise ValueError(f"running_max: no kernel for device {z.device}")
    lib = _kernels()
    N = z.shape[0]
    buf = torch.empty(N + -(-N // _tile), dtype=torch.int32, device=z.device)
    err = on_device(z.device, lambda stream: lib.pt_running_max(
        z.data_ptr(), N, buf.data_ptr(), buf.data_ptr() + 4 * N, stream))
    if err != 0:
        raise RuntimeError(f"running_max kernel launch failed: CUDA error "
                           f"{err}")
    running_max.launches += 1
    return buf[:N]


running_max.launches = 0   # kernel launches, for tracing the path
