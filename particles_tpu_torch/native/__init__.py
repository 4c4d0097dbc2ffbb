"""Host helpers in C++, loaded with ctypes (PyTorch port).

Counterpart of ``particles_tpu/native``: the same four functions of
``src/particles_native.cpp`` (the port's own copy of the source), with the
same names and contracts.  Arrays come in as numpy arrays or CPU tensors
and are read as float64 (``coords`` as uint32); the results are numpy
``int32`` (``uint64`` for :func:`hilbert_index`).

- :func:`ssp_counts` carries ``resampling.ssp_counts`` below
  ``resampling._SSP_BLOCKED_MIN`` particles: the sequential SSP pairing as
  one host loop, equal bit for bit to ``resampling._ssp_counts_sequential``
  on the same weights and uniforms.
- :func:`inverse_cdf`, :func:`systematic_counts` and :func:`hilbert_index`
  are held by the tests against ``resampling.inverse_cdf``, a float64
  formula and ``hilbert.hilbert_index``.

The library is built with g++ (``_build.build_host``) at the first call of
a helper, never at import, into ``particles_tpu_torch/_build/``, and again
when the source is newer.  A failed build raises RuntimeError with the
compiler's output; nothing falls back to a Python loop.  ``AVAILABLE`` is
True when the compiler ``_build.CXX`` is on the PATH (``shutil.which``,
read when ``AVAILABLE`` is read): it builds nothing.
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path

import numpy as np

from particles_tpu_torch import _build

__all__ = [
    "AVAILABLE",
    "inverse_cdf",
    "systematic_counts",
    "ssp_counts",
    "hilbert_index",
]

SRC = Path(__file__).resolve().parent / "src" / "particles_native.cpp"

_c_dp = ctypes.POINTER(ctypes.c_double)
_c_i32p = ctypes.POINTER(ctypes.c_int32)
_c_u32p = ctypes.POINTER(ctypes.c_uint32)
_c_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64, _i32 = ctypes.c_int64, ctypes.c_int32

# (argtypes, restype) of each C function
_SIGNATURES = {
    "pn_inverse_cdf": ([_c_dp, _c_dp, _i64, _i64, _c_i32p], None),
    "pn_systematic_counts": ([_c_dp, _i64, _i64, ctypes.c_double, _c_i32p],
                             None),
    "pn_ssp_counts": ([_c_dp, _i64, _i64, _c_dp, _c_i32p], _i32),
    "pn_hilbert_index": ([_c_u32p, _i64, _i32, _i32, _c_u64p], None),
}

_lib = None


def __getattr__(name):
    if name == "AVAILABLE":
        return shutil.which(_build.CXX) is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _load():
    """The library, built first if it is missing or stale."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build_host(SRC)))
        for fname, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
    return _lib


def _as_c(a, dtype, ndim, name):
    a = np.ascontiguousarray(np.asarray(a), dtype=dtype)
    if a.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dimension(s), got shape "
                         f"{a.shape}")
    return a


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def inverse_cdf(su, W):
    """Ancestors ``A[m]``, the least j with ``cumsum(W / sum(W))[j] >=
    su[m]`` (at most N - 1), by two pointers: ``su`` (M,) sorted, ``W``
    (N,), N >= 1, unnormalised allowed."""
    lib = _load()
    su = _as_c(su, np.float64, 1, "su")
    W = _as_c(W, np.float64, 1, "W")
    if W.shape[0] == 0:
        raise ValueError("inverse_cdf: W is empty")
    A = np.empty(su.shape[0], np.int32)
    lib.pn_inverse_cdf(_ptr(su, ctypes.c_double), _ptr(W, ctypes.c_double),
                       su.shape[0], W.shape[0], _ptr(A, ctypes.c_int32))
    return A


def systematic_counts(W, M, u):
    """Systematic offspring counts of ``W`` (N,) for M draws at the offset
    ``u`` in [0, 1): the differences of ``z_i = clip(floor(M cs_i - u) +
    1, 0, M)``, ``z[-1] = M``."""
    lib = _load()
    W = _as_c(W, np.float64, 1, "W")
    counts = np.empty(W.shape[0], np.int32)
    lib.pn_systematic_counts(_ptr(W, ctypes.c_double), W.shape[0], int(M),
                             float(u), _ptr(counts, ctypes.c_int32))
    return counts


def ssp_counts(W, M, u):
    """SSP offspring counts (the sequential pairwise rounding, with its
    round-off fix-up so that they sum to M) of ``W`` (N,); ``u`` holds at
    least N - 1 iid uniforms, of which the first N - 1 are read."""
    lib = _load()
    W = _as_c(W, np.float64, 1, "W")
    u = _as_c(u, np.float64, 1, "u")
    N = W.shape[0]
    if u.shape[0] < N - 1:
        raise ValueError(f"ssp_counts: {u.shape[0]} uniforms for N = {N}")
    counts = np.empty(N, np.int32)
    lib.pn_ssp_counts(_ptr(W, ctypes.c_double), N, int(M),
                      _ptr(u, ctypes.c_double), _ptr(counts, ctypes.c_int32))
    return counts


def hilbert_index(coords, nbits):
    """Hilbert indices (N,) uint64 of the points ``coords`` (N, d), entries
    in [0, 2^nbits), 1 <= nbits <= 32 and d * nbits <= 62."""
    lib = _load()
    coords = _as_c(coords, np.uint32, 2, "coords")
    N, d = coords.shape
    nbits = int(nbits)
    if not (d >= 1 and 1 <= nbits <= 32 and d * nbits <= 62):
        raise ValueError(f"hilbert_index: d = {d}, nbits = {nbits}")
    out = np.empty(N, np.uint64)
    lib.pn_hilbert_index(_ptr(coords, ctypes.c_uint32), N, d, nbits,
                         _ptr(out, ctypes.c_uint64))
    return out
