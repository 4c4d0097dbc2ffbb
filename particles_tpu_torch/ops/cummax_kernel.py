"""Inclusive running maximum of int32 (B6): CUDA kernel and plain version.

Replaces the TPU kernel ``particles_tpu/ops/cummax_kernel.py::
_cummax_kernel`` (public function ``running_max``), which enforces the
nondecreasing z contract where a z-form is built from a float cumsum
(``resampling._monotone_z``).  Exact.

On this card the kernel (``csrc/cummax_kernel.cu``) is bound by bytes, 8
a particle.  It is one persistent cooperative launch on B1's and B3's
skeleton: each block keeps its chunk of z in shared memory across one
grid-wide barrier (the blocks' maxima), so z is read once and y written
once up to about 6.5M particles on an H100 (:func:`running_max_geometry`);
above that a block reads its chunk again.  A refused cooperative launch
raises.
"""

from __future__ import annotations

import ctypes

import torch

from particles_tpu_torch import _build, tracing
from particles_tpu_torch.ops._launch import coop_geometry, on_device

__all__ = ["running_max", "running_max_plain", "running_max_geometry"]

# int32 words of scratch after the output for the blocks' maxima (one a
# block): a launch has at most 4096 blocks (an H100 takes 264)
_PARTIAL_WORDS = 4096

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("cummax_kernel")
        lib.pt_running_max.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.pt_running_max.restype = ctypes.c_int
        lib.pt_cummax_geometry.argtypes = [
            ctypes.c_longlong] + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.pt_cummax_geometry.restype = ctypes.c_int
        _lib = lib
    return _lib


def running_max_plain(z):
    """Plain PyTorch version of :func:`running_max` (any device)."""
    return torch.cummax(z, 0).values


def running_max(z):
    """Inclusive running maximum of ``z`` ((N,) int32): (N,) int32.

    A CPU tensor goes to :func:`running_max_plain`; a CUDA tensor to the
    kernel, one cooperative launch, which raises if it cannot build or
    launch.  There ``y`` is a view of the start of one allocation whose
    tail held the blocks' maxima.
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
    buf = torch.empty(N + _PARTIAL_WORDS, dtype=torch.int32, device=z.device)
    err = on_device(z.device, lambda stream: lib.pt_running_max(
        z.data_ptr(), N, buf.data_ptr(), buf.data_ptr() + 4 * N,
        _PARTIAL_WORDS, stream))
    if err != 0:
        raise RuntimeError(f"running_max kernel launch failed: CUDA error "
                           f"{err}")
    tracing.count("launch.running_max")
    return buf[:N]


def running_max_geometry(device=None):
    """B6's launch geometry on a CUDA device (default: the current one):
    ``(tile, cache_tiles, max_grid)``, as
    :func:`~particles_tpu_torch.ops.normalised_cumsum_geometry` describes
    it."""
    return coop_geometry(_kernels().pt_cummax_geometry, _PARTIAL_WORDS,
                         device, "running_max")
