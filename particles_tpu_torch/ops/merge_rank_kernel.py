"""Sorted-merge rank count (B5): CUDA kernel and plain version.

Replaces the TPU kernel ``particles_tpu/ops/merge_rank_kernel.py::
_merge_kernel`` (public function ``merge_rank_counts``).  For uniforms
``su`` ((L,) float32, sorted) and cumulative weights ``cs`` ((N,) float32,
nondecreasing)::

    z_i = min(#{j : su_j <= cs_i}, M)      (int32)

the counts' cumsum of every inverse-CDF resampling scheme.  The kernel
keeps three contracts, for any L, N >= 1 and 0 <= M < 2^31:

1. on sorted ``su`` it equals :func:`merge_rank_counts_plain`
   (``searchsorted(su, cs, right=True)`` clamped to M) exactly;
2. ``z`` is nondecreasing whenever ``cs`` is, on any ``su``, even where a
   float cumsum left it an ulp out of order (each z_i is then a binary
   search's answer: ``su[z_i - 1] <= cs_i < su[z_i]`` where those exist,
   before the clamp to M);
3. every output is written exactly once, whatever ``su`` holds.

On this card the kernel (``csrc/merge_rank_kernel.cu``) is bound by bytes.
A block owns ``MERGE_RANK_TILE`` consecutive ``cs``; two warps find the
block's window of ``su`` by 32-probe searches of all of it, the block
copies the window into shared memory (up to ``MERGE_RANK_WINDOW`` floats;
a larger one is searched in place) and each thread counts its first key
in the window and its other keys between that count and the next
thread's.  The design, and why it keeps the contracts, is in the
source's header.
"""

from __future__ import annotations

import ctypes

import torch

from particles_tpu_torch import _build, tracing
from particles_tpu_torch.ops._launch import on_device

__all__ = ["MERGE_RANK_TILE", "MERGE_RANK_WINDOW", "merge_rank_counts",
           "merge_rank_counts_plain"]

MERGE_RANK_TILE = 2048     # cs a block owns; kThreads * kItems in the source
MERGE_RANK_WINDOW = 8192   # su a block keeps in shared memory; kWindow

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("merge_rank_kernel")
        for name in ("pt_merge_rank_tile", "pt_merge_rank_window"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        lib.pt_merge_rank_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.pt_merge_rank_counts.restype = ctypes.c_int
        if (lib.pt_merge_rank_tile() != MERGE_RANK_TILE
                or lib.pt_merge_rank_window() != MERGE_RANK_WINDOW):
            raise RuntimeError("merge_rank_kernel.cu and merge_rank_kernel.py "
                               "disagree on the tile or the window")
        _lib = lib
    return _lib


def _check(su, cs, M):
    for name, v in (("su", su), ("cs", cs)):
        if not isinstance(v, torch.Tensor) or v.dtype != torch.float32:
            raise TypeError(f"merge_rank_counts: {name} must be a float32 "
                            f"tensor")
        if v.ndim != 1 or v.shape[0] < 1 or not v.is_contiguous():
            raise ValueError(f"merge_rank_counts: {name} must be contiguous "
                             f"(n,) with n >= 1")
    if su.device != cs.device:
        raise ValueError(f"merge_rank_counts: su on {su.device}, cs on "
                         f"{cs.device}")
    if not (isinstance(M, int) and 0 <= M < 2**31):
        raise ValueError(f"merge_rank_counts: M must be an int in [0, 2^31), "
                         f"got {M!r}")


def merge_rank_counts_plain(su, cs, M):
    """Plain PyTorch version of :func:`merge_rank_counts` (any device)."""
    z = torch.searchsorted(su, cs, right=True, out_int32=True)
    return z.clamp_(0, M)


def merge_rank_counts(su, cs, M):
    """``z_i = #{j: su_j <= cs_i}`` clipped to [0, M]: (N,) int32.

    A CPU tensor goes to :func:`merge_rank_counts_plain`; a CUDA tensor to
    the kernel, one launch, which raises if it cannot build or launch.
    """
    _check(su, cs, M)
    dev = cs.device
    if dev.type == "cpu":
        return merge_rank_counts_plain(su, cs, M)
    if dev.type != "cuda":
        raise ValueError(f"merge_rank_counts: no kernel for device {dev}")
    lib = _kernels()
    N = cs.shape[0]
    z = torch.empty(N, dtype=torch.int32, device=dev)
    err = on_device(dev, lambda stream: lib.pt_merge_rank_counts(
        su.data_ptr(), su.shape[0], cs.data_ptr(), N, M, z.data_ptr(),
        stream))
    if err != 0:
        raise RuntimeError(f"merge_rank_counts kernel launch failed: CUDA "
                           f"error {err}")
    tracing.count("launch.merge_rank_counts")
    return z

