"""Resampling moves: by the z-form (B2) and by the inverse CDF of uniforms
(B4), CUDA kernels and plain versions.

Replace the TPU kernel ``particles_tpu/ops/repeat_kernel.py::
_make_visit_kernel`` in z-mode (public functions ``repeat_with_plan_cols``,
``serve_by_z``, ``ancestors_by_z``, ``repeat_by_z``) and in su-mode (plans
from ``make_repeat_plan_su``).  For ``z``, the inclusive cumsum of
offspring counts ((N,) int32, nondecreasing, ``z[-1] == M``), the z-move
is::

    Y[j] = X[A_j],   A_j = #{k : z_k <= j},   j < M

and for uniforms ``su`` ((M,) float32, sorted or not) and cumulative
weights ``cs`` ((N,) float32, nondecreasing, any range) the su-move
is::

    Y[j] = X[A_j],   A_j = #{i : cs_i < su_j}   (searchsorted side='left')

with ``A`` clipped to N - 1 (``cs`` may have any range: the JAX package
serves an integer ``cs`` at ``idx + 0.5``).

The kernels are in ``csrc/repeat_kernel.cu``.  The z-move walks the merge
of z with 0..M-1 (ties put z first): each block owns an equal slice of
that merge, so one particle with all the offspring or long runs of
childless ones cost the same, and z is read once.  The su-move is a
cutpoint (guide) table.  With a bucket function ``f(x) = clamp(floor(x
s), 0, K - 1)``, ``K = guide_buckets(N)`` (N/8) and ``s = K / cs[-1]``
computed and stored on the card, one launch writes for each bucket b the
16-byte entry ``{G[b], G[b+1], cs[G[b]], cs[G[b]+1]}``, ``G[b] = #{i:
f(cs_i) < b}``, and a second serves each query from the entry of
``f(su_j)``: one random load, then a search of ``cs[G[b]+2, G[b+1])`` only
when the two cs in the entry do not settle it (none on degenerate
weights).  That is exact for any monotone ``f`` computed alike in both
launches; a scale that is not a positive finite float (``cs[-1] <= 0``)
makes ``f`` constant and costs only speed.  On an H100 a query's random
load is what bounds the serve, where the first port's search of all of cs
made about ten; PERF.md has the times.  Both moves copy row ``A_j`` of
every payload as raw bits, so payloads of any dtype with 1-, 2-, 4- or
8-byte elements, (N,) or (N, d, ...), come back exact; up to
``MAX_PAYLOADS`` of them share one launch, and the ancestor vector ``A``
(int64) can ride the same launch.  There is no visit plan, no f32 round
trip, no sort around unsorted queries and no ``M % N`` gate: those
answered TPU limits.
"""

from __future__ import annotations

import ctypes

import torch

from particles_tpu_torch import _build, tracing
from particles_tpu_torch.ops._launch import on_device

__all__ = ["MAX_PAYLOADS", "MERGE_TILE", "GUIDE_SHIFT", "guide_buckets",
           "repeat_cols", "repeat_cols_plain", "repeat_by_z", "serve_by_z",
           "ancestors_by_z", "repeat_cols_su", "repeat_cols_su_plain",
           "ancestors_by_su"]

MAX_PAYLOADS = 8   # payloads per launch; kMaxPayloads in the CUDA source
MERGE_TILE = 4096  # items of the merge a block of the z-move owns; kMergeTile
GUIDE_SHIFT = 3    # the su-move's buckets: a 2^-GUIDE_SHIFT share of N

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("repeat_kernel")
        lib.pt_repeat_max_payloads.argtypes = []
        lib.pt_repeat_max_payloads.restype = ctypes.c_int
        lib.pt_repeat_merge_tile.argtypes = []
        lib.pt_repeat_merge_tile.restype = ctypes.c_int
        lib.pt_repeat_by_z.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.pt_repeat_by_z.restype = ctypes.c_int
        lib.pt_repeat_by_su.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.pt_repeat_by_su.restype = ctypes.c_int
        if (lib.pt_repeat_max_payloads() != MAX_PAYLOADS
                or lib.pt_repeat_merge_tile() != MERGE_TILE):
            raise RuntimeError("repeat_kernel.cu and repeat_kernel.py "
                               "disagree on the payloads per launch or the "
                               "merge tile")
        _lib = lib
    return _lib


def guide_buckets(N):
    """K, the buckets of the su-move's guide table for ``N`` particles: the
    least power of two >= N, over ``2^GUIDE_SHIFT``, in [1, 2^24] (every
    bucket index an exact float32)."""
    return min(1 << max((N - 1).bit_length() - GUIDE_SHIFT, 0), 1 << 24)


def _check_M(M, what):
    if not (isinstance(M, int) and 1 <= M < 2**31):
        raise ValueError(f"{what}: M must be an int in [1, 2^31), got {M!r}")


def _check_payloads(cols, N, device, what):
    for x in cols:
        if not isinstance(x, torch.Tensor) or x.ndim < 1 or x.shape[0] != N:
            raise ValueError(f"{what}: every payload must have leading "
                             f"dimension N={N}")
        if x.device != device:
            raise ValueError(f"{what}: payload on {x.device}, the move on "
                             f"{device}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: payloads must be contiguous")
        if x.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"{what}: no kernel for {x.dtype} "
                            f"({x.element_size()}-byte elements)")


def _check(z, M, cols):
    if not isinstance(z, torch.Tensor) or z.dtype != torch.int32:
        raise TypeError("repeat_by_z: z must be an int32 tensor")
    if (z.ndim != 1 or not 1 <= z.shape[0] < 2**31
            or not z.is_contiguous()):
        raise ValueError("repeat_by_z: z must be contiguous (N,) with "
                         "1 <= N < 2^31")
    _check_M(M, "repeat_by_z")
    _check_payloads(cols, z.shape[0], z.device, "repeat_by_z")


def _check_su(su, cs, M, cols):
    for name, v in (("su", su), ("cs", cs)):
        if not isinstance(v, torch.Tensor) or v.dtype != torch.float32:
            raise TypeError(f"repeat_by_su: {name} must be a float32 tensor")
        if v.ndim != 1 or v.shape[0] < 1 or not v.is_contiguous():
            raise ValueError(f"repeat_by_su: {name} must be contiguous (n,) "
                             f"with n >= 1")
    if su.device != cs.device:
        raise ValueError(f"repeat_by_su: su on {su.device}, cs on "
                         f"{cs.device}")
    _check_M(M, "repeat_by_su")
    if M != su.shape[0]:
        raise ValueError(f"repeat_by_su: M={M} but su has {su.shape[0]} "
                         f"entries")
    _check_payloads(cols, cs.shape[0], cs.device, "repeat_by_su")


def _launch_chunks(launch, N, M, cols, want_anc, device):
    """Serve ``cols`` in launches of up to ``MAX_PAYLOADS`` payloads, ``A``
    riding the first one (with no payload, one ancestors-only launch).
    ``launch(P, desc, anc_ptr, stream)`` starts one kernel and returns its
    CUDA error code; ``desc`` is the address of ``4 P`` int64: the payloads'
    pointers, their outputs' pointers, row widths and element sizes.
    Returns ``(served, A, launches)``."""
    served, A, launches = [], None, 0
    for s in range(0, max(len(cols), 1), MAX_PAYLOADS):
        chunk = cols[s:s + MAX_PAYLOADS]
        anc_here = want_anc and s == 0
        if not chunk and not anc_here:
            break
        ys = [torch.empty((M,) + x.shape[1:], dtype=x.dtype, device=device)
              for x in chunk]
        a = (torch.empty(M, dtype=torch.int64, device=device)
             if anc_here else None)
        P = len(chunk)
        desc = (ctypes.c_longlong * max(4 * P, 1))(
            *[x.data_ptr() for x in chunk], *[y.data_ptr() for y in ys],
            *[x.numel() // N for x in chunk],
            *[x.element_size() for x in chunk])
        anc = a.data_ptr() if a is not None else None
        err = on_device(device, lambda stream: launch(
            P, ctypes.addressof(desc), anc, stream))
        if err != 0:
            raise RuntimeError(f"resampling move kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1
        served.extend(ys)
        if anc_here:
            A = a
    return served, A, launches


def repeat_cols_plain(z, M, cols, want_anc=False):
    """Plain PyTorch version of :func:`repeat_cols` (any device)."""
    j = torch.arange(M, dtype=z.dtype, device=z.device)
    A = torch.searchsorted(z, j, right=True).clamp_(max=z.shape[0] - 1)
    return [x.index_select(0, A) for x in cols], (A if want_anc else None)


def repeat_cols(z, M, cols, want_anc=False):
    """Serve every payload in ``cols`` by ``z`` and optionally return the
    ancestor vector: ``([Y_p], A or None)``, ``A`` int64.

    Counterpart of ``repeat_with_plan_cols``: ``MAX_PAYLOADS`` payloads
    share a launch, and ``A`` rides the first one (with no payload, one
    ancestors-only launch).  A CPU ``z`` goes to
    :func:`repeat_cols_plain`; a CUDA ``z`` to the kernel, which raises if
    it cannot build or launch.
    """
    cols = list(cols)
    _check(z, M, cols)
    if z.device.type == "cpu":
        return repeat_cols_plain(z, M, cols, want_anc)
    if z.device.type != "cuda":
        raise ValueError(f"repeat_by_z: no kernel for device {z.device}")
    lib = _kernels()
    N = z.shape[0]

    def launch(P, desc, anc, stream):
        return lib.pt_repeat_by_z(z.data_ptr(), N, M, P, desc, anc, stream)

    served, A, n = _launch_chunks(launch, N, M, cols, want_anc, z.device)
    tracing.count("launch.repeat_by_z", n)
    return served, A


def repeat_by_z(x, z, M):
    """``Y[j] = X[#{k: z_k <= j}]`` for one payload."""
    return repeat_cols(z, M, [x])[0][0]


def serve_by_z(z, M):
    """Serve function for ``z``: maps a leading-dim-N payload to its
    resampled copy (one launch per call; batch with :func:`repeat_cols`)."""
    return lambda leaf: repeat_by_z(leaf, z, M)


def ancestors_by_z(z, M):
    """Sorted ancestor vector ``A[j] = #{k: z_k <= j}`` (int64)."""
    return repeat_cols(z, M, [], want_anc=True)[1]


def repeat_cols_su_plain(su, cs, M, cols, want_anc=False):
    """Plain PyTorch version of :func:`repeat_cols_su` (any device)."""
    A = torch.searchsorted(cs, su).clamp_(max=cs.shape[0] - 1)
    return [x.index_select(0, A) for x in cols], (A if want_anc else None)


def repeat_cols_su(su, cs, M, cols, want_anc=False):
    """Serve every payload in ``cols`` by the inverse CDF ``cs`` at the
    uniforms ``su`` ((M,), in any order) and optionally return the ancestor
    vector: ``([Y_p], A or None)``, ``A`` int64.

    Counterpart of ``repeat_with_plan_cols`` on a ``make_repeat_plan_su``
    plan, with the same launch rules as :func:`repeat_cols`; the first
    launch also builds the guide table (two CUDA kernels), in scratch
    allocated here with one ``torch.empty``.  A CPU ``cs`` goes to
    :func:`repeat_cols_su_plain`; a CUDA ``cs`` to the kernels, which raise
    if they cannot build or launch.
    """
    cols = list(cols)
    _check_su(su, cs, M, cols)
    if cs.device.type == "cpu":
        return repeat_cols_su_plain(su, cs, M, cols, want_anc)
    if cs.device.type != "cuda":
        raise ValueError(f"repeat_by_su: no kernel for device {cs.device}")
    lib = _kernels()
    N = cs.shape[0]
    K = guide_buckets(N)
    # K entries of 4 int32 (G[b], G[b+1], cs[G[b]], cs[G[b]+1]), then s
    guide = torch.empty(4 * K + 1, dtype=torch.int32, device=cs.device)
    built = False

    def launch(P, desc, anc, stream):
        nonlocal built
        err = lib.pt_repeat_by_su(su.data_ptr(), M, cs.data_ptr(), N,
                                  guide.data_ptr(), K, not built, P, desc,
                                  anc, stream)
        built = True
        return err

    served, A, n = _launch_chunks(launch, N, M, cols, want_anc, cs.device)
    tracing.count("launch.repeat_by_su", n)
    return served, A


def ancestors_by_su(su, cs):
    """Ancestor vector ``A[j] = #{i: cs_i < su_j}`` (int64), clipped to
    N - 1."""
    return repeat_cols_su(su, cs, su.shape[0], [], want_anc=True)[1]
