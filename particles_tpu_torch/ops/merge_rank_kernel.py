"""Sorted-merge rank count (B5): CUDA kernel and plain version.

Replaces the TPU kernel ``particles_tpu/ops/merge_rank_kernel.py::
_merge_kernel`` (public function ``merge_rank_counts``).  For uniforms
``su`` ((L,) float32, sorted) and cumulative weights ``cs`` ((N,) float32,
nondecreasing)::

    z_i = min(#{j : su_j <= cs_i}, M)      (int32)

the counts' cumsum of every inverse-CDF resampling scheme, exact (float
compares), for any L and N.  ``z`` is nondecreasing whenever ``cs`` is,
even where a float cumsum left ``su`` an ulp out of order: a binary
search's result is monotone in its key whatever the array holds.

On this card the kernel (``csrc/merge_rank_kernel.cu``) is bound by bytes:
one thread per ``cs_i`` binary-searches ``su``, which stays in L2.
"""

from __future__ import annotations

import ctypes

import torch

from particles_tpu_torch import _build

__all__ = ["merge_rank_counts", "merge_rank_counts_plain"]

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("merge_rank_kernel")
        lib.pt_merge_rank_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.pt_merge_rank_counts.restype = ctypes.c_int
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
    the kernel, which raises if it cannot build or launch.
    """
    _check(su, cs, M)
    if cs.device.type == "cpu":
        return merge_rank_counts_plain(su, cs, M)
    if cs.device.type != "cuda":
        raise ValueError(f"merge_rank_counts: no kernel for device "
                         f"{cs.device}")
    lib = _kernels()
    N = cs.shape[0]
    z = torch.empty(N, dtype=torch.int32, device=cs.device)
    with torch.cuda.device(cs.device):
        stream = torch.cuda.current_stream(cs.device).cuda_stream
        err = lib.pt_merge_rank_counts(su.data_ptr(), su.shape[0],
                                       cs.data_ptr(), N, M, z.data_ptr(),
                                       stream)
    if err != 0:
        raise RuntimeError(f"merge_rank_counts kernel launch failed: CUDA "
                           f"error {err}")
    merge_rank_counts.launches += 1
    return z


merge_rank_counts.launches = 0   # kernel launches, for tracing the path
