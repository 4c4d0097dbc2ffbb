"""Fixed-point cumulative weights: the systematic z-form (B1) and the
monotone normalised cumsum (B3), CUDA kernels and plain versions.

Replace the TPU kernels ``particles_tpu/ops/z_kernel.py::_z_kernel``
(public function ``systematic_z_fused``) and ``::_cs_kernel`` (public
function ``normalised_cumsum_exact``).  Both quantise the weights
``W >= 0`` to a fixed-point grid and take an exact integer cumsum::

    S = sum(W);  scale = 2^30 / max(S, 1e-37)          (f32)
    q = round(W * scale)  (half to even, int64);  Q = sum(q)
    csq = cumsum(q)                                    (exact)

and then, for B1 with a uniform ``u``::

    z = clip(floor(f32(csq) * (M / max(Q, 1)) - u) + 1, 0, M);  z[-1] = M

``z`` is int32, within 1 of the float64 answer ``floor(M * cumsum(W) /
sum(W) - u) + 1``; and for B3::

    cs = f32(csq) * (1 / max(Q, 1))

within ``N * 2^-31 + 1e-6`` of the float64 CDF, with ``|cs[-1] - 1| <
1e-6``.  Every stage after the integer cumsum is monotone, so z and cs
are nondecreasing by construction, for any N >= 1.

On this card the kernels (``csrc/z_kernel.cu``) are bound by bytes, 8 a
particle.  Each is one persistent cooperative launch of the same kernel
body, instantiated for its epilogue: each block keeps its chunk of W in
shared memory across two grid-wide barriers (S, then the block sums of
q), so W is read once and the output written once up to about 6.5M
particles on an H100 (:func:`normalised_cumsum_geometry`,
:func:`systematic_z_geometry`); above that a block reads its chunk again.
A refused cooperative launch raises.  The design, and how it differs from
the TPU tiling, is in the source's header.
"""

from __future__ import annotations

import ctypes

import torch

from particles_tpu_torch import _build, tracing
from particles_tpu_torch.ops._launch import coop_geometry, on_device

__all__ = ["systematic_z_fused", "systematic_z_plain",
           "systematic_z_geometry", "normalised_cumsum_exact",
           "normalised_cumsum_plain", "normalised_cumsum_geometry"]

_SCALE = float(1 << 30)   # fixed-point grid
# 8-byte words of scratch after either kernel's output for its partials
# (two a block): a launch has at most 2048 blocks (an H100 takes 264)
_PARTIAL_WORDS = 4096

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("z_kernel")
        lib.pt_systematic_z.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.pt_systematic_z.restype = ctypes.c_int
        for query in (lib.pt_z_geometry, lib.pt_cs_geometry):
            query.argtypes = [
                ctypes.c_longlong] + [ctypes.POINTER(ctypes.c_int)] * 3
            query.restype = ctypes.c_int
        lib.pt_normalised_cumsum.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.pt_normalised_cumsum.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_weights(W, what):
    if not isinstance(W, torch.Tensor):
        raise TypeError(f"{what}: W must be a torch.Tensor")
    if W.dtype != torch.float32:
        raise TypeError(f"{what}: W must be float32, got {W.dtype}")
    if W.ndim != 1 or W.shape[0] < 1:
        raise ValueError(f"{what}: W must be (N,) with N >= 1, "
                         f"got shape {tuple(W.shape)}")
    if not W.is_contiguous():
        raise ValueError(f"{what}: W must be contiguous")


def _check(W, u, M):
    _check_weights(W, "systematic_z")
    if not (isinstance(M, int) and 1 <= M < 2**31):
        raise ValueError(f"systematic_z: M must be an int in [1, 2^31), "
                         f"got {M!r}")
    u = torch.as_tensor(u, dtype=torch.float32, device=W.device)
    if u.numel() != 1:
        raise ValueError("systematic_z: u must be one number")
    return u.reshape(())


def _fixed_point_cumsum(W):
    """csq = cumsum(round(W * 2^30 / S)), exact in int64, and f32(Q)."""
    S = W.sum(dtype=torch.float64).to(torch.float32)
    # constants by new_full: a fill on the device, not a host copy (a sync)
    scale = S.new_full((), _SCALE) / S.clamp_min(1e-37)
    csq = torch.cumsum(torch.round(W * scale).to(torch.int64), 0)
    return csq, csq[-1].to(torch.float32).clamp_min(1.0)


def systematic_z_plain(W, u, M):
    """The same fixed-point algorithm in plain PyTorch (any device)."""
    u = torch.as_tensor(u, dtype=torch.float32, device=W.device)
    csq, Q = _fixed_point_cumsum(W)
    minv = Q.new_full((), float(M)) / Q
    z = torch.floor(csq.to(torch.float32) * minv - u).to(torch.int64) + 1
    z = z.clamp_(0, M).to(torch.int32)
    z[-1:].fill_(M)
    return z


def normalised_cumsum_plain(W):
    """B3's fixed-point algorithm in plain PyTorch (any device)."""
    csq, Q = _fixed_point_cumsum(W)
    inv = Q.new_ones(()) / Q
    return csq.to(torch.float32) * inv


def systematic_z_fused(W, u, M):
    """Systematic z-form of ``W`` ((N,) float32, >= 0) with uniform ``u``:
    (N,) int32, nondecreasing, ``z[-1] == M``.

    A CPU tensor goes to :func:`systematic_z_plain`; a CUDA tensor to the
    kernel, one cooperative launch, which raises if it cannot build or
    launch.  There ``z`` is a view of the start of one allocation whose
    tail held the kernel's partials.  ``u`` may be a Python float or a one-element tensor; a device
    tensor is read by the kernel, with no host sync.
    """
    u = _check(W, u, M)
    if W.device.type == "cpu":
        return systematic_z_plain(W, u, M)
    if W.device.type != "cuda":
        raise ValueError(f"systematic_z: no kernel for device {W.device}")
    lib = _kernels()
    N = W.shape[0]
    head = N + N % 2                 # the partials start 8-byte aligned
    buf = torch.empty(head + 2 * _PARTIAL_WORDS, dtype=torch.int32,
                      device=W.device)
    part = buf.data_ptr() + 4 * head

    def launch(stream):
        return lib.pt_systematic_z(W.data_ptr(), N, M, u.data_ptr(),
                                   buf.data_ptr(), part, _PARTIAL_WORDS,
                                   stream)

    err = on_device(W.device, launch)
    if err != 0:
        raise RuntimeError(f"systematic_z kernel launch failed: CUDA error "
                           f"{err}")
    tracing.count("launch.systematic_z")
    return buf[:N]


def systematic_z_geometry(device=None):
    """B1's launch geometry on a CUDA device (default: the current one):
    ``(tile, cache_tiles, max_grid)``, as
    :func:`normalised_cumsum_geometry` describes it."""
    return coop_geometry(_kernels().pt_z_geometry, _PARTIAL_WORDS, device,
                         "systematic_z")


def normalised_cumsum_geometry(device=None):
    """B3's launch geometry on a CUDA device (default: the current one):
    ``(tile, cache_tiles, max_grid)``.  A launch over N particles has
    ``G = ceil(N / chunk)`` blocks of ``chunk = tile * ceil(ceil(N /
    max_grid) / tile)`` particles each, kept in shared memory when
    ``chunk <= cache_tiles * tile``."""
    return coop_geometry(_kernels().pt_cs_geometry, _PARTIAL_WORDS, device,
                         "normalised_cumsum")


def normalised_cumsum_exact(W):
    """Monotone normalised cumulative weights of ``W`` ((N,) float32,
    >= 0): (N,) float32, nondecreasing, ``cs[-1]`` within 1e-6 of 1 (callers
    that need an exact top pin it themselves).

    A CPU tensor goes to :func:`normalised_cumsum_plain`; a CUDA tensor to
    the kernel, one cooperative launch, which raises if it cannot build or
    launch.  There ``cs`` is a view of the start of one allocation whose
    tail held the kernel's partials.
    """
    _check_weights(W, "normalised_cumsum")
    dev = W.device
    if dev.type == "cpu":
        return normalised_cumsum_plain(W)
    if dev.type != "cuda":
        raise ValueError(f"normalised_cumsum: no kernel for device {dev}")
    lib = _kernels()
    N = W.shape[0]
    head = N + N % 2                 # the partials start 8-byte aligned
    buf = torch.empty(head + 2 * _PARTIAL_WORDS, dtype=torch.float32,
                      device=dev)
    part = buf.data_ptr() + 4 * head

    def launch(stream):
        return lib.pt_normalised_cumsum(W.data_ptr(), N, buf.data_ptr(),
                                        part, _PARTIAL_WORDS, stream)

    err = on_device(dev, launch)
    if err != 0:
        raise RuntimeError(f"normalised_cumsum kernel launch failed: CUDA "
                           f"error {err}")
    tracing.count("launch.normalised_cumsum")
    return buf[:N]

