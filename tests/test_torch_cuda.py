"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips when ``torch.cuda.is_available()`` is
False (decided inside the fixture, never at import).  This file imports no
JAX, so on a machine with a card and no JAX it runs on its own::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` drives the same kernels at the main path's full size.
"""

import numpy as np
import pytest
import torch

from particles_tpu_torch import kalman, ops, tracing
from particles_tpu_torch import state_space_models as ssms
from particles_tpu_torch.core import SMC, multiSMC
from test_torch_kernel_models import (B2_KINDS, B3_KINDS, B4_KINDS,
                                      B5_DIP_KEYS, B5_GEOMETRIES, B5_KINDS,
                                      B6_KINDS, B6_SIZES, _counts, _dip_case,
                                      _guide_ancestors, _guide_case, _ints,
                                      _oracle_z, _rank_blocks, _rank_case,
                                      _weights)

pytestmark = pytest.mark.cuda


def _launches():
    """Each kernel's launches so far: ``tracing``'s ``launch.<kernel>``
    for every kernel of ``ops.KERNELS``."""
    counts = tracing.counts()
    return {k: counts.get("launch." + k, 0) for k in ops.KERNELS}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _weights_dirichlet(N, alpha=1.0, seed=0):
    g = np.random.default_rng(seed).standard_gamma(alpha, N)
    return (g / g.sum()).astype(np.float32)


@pytest.mark.parametrize("N", [1, 7, 1000, 65539])
@pytest.mark.parametrize("alpha", [1.0, 0.05])
def test_systematic_z_kernel_matches_plain(dev, N, alpha):
    """|dz| <= 1: the kernel and the plain version sum S in another
    order."""
    W = torch.from_numpy(_weights_dirichlet(N, alpha, N)).to(dev)
    for u in (0.0, 0.37, 0.999):
        ut = torch.tensor(u, dtype=torch.float32, device=dev)
        before = _launches()["systematic_z"]
        z = ops.systematic_z_fused(W, ut, N)
        assert _launches()["systematic_z"] == before + 1
        zp = ops.systematic_z_plain(W, ut, N)
        torch.cuda.synchronize()
        assert z.dtype == torch.int32 and z.shape == (N,)
        assert int((z.long() - zp.long()).abs().max()) <= 1
        assert bool((z[1:] >= z[:-1]).all()) and int(z[-1]) == N


@pytest.mark.parametrize("N,M", [(1, 1), (1000, 1000), (65539, 65539),
                                 (1000, 377)])
def test_repeat_kernel_matches_plain(dev, N, M):
    W = torch.from_numpy(_weights_dirichlet(N, 0.3, N + 1)).to(dev)
    z = ops.systematic_z_fused(W, 0.5, M)
    cols = [torch.randn(N, device=dev),
            torch.randint(2 ** 24, 2 ** 31 - 1, (N,), device=dev,
                          dtype=torch.int32),
            torch.randn(N, 2, device=dev, dtype=torch.float64),
            torch.randint(0, 2, (N,), device=dev).bool()]
    cols += [torch.randn(N, device=dev) for _ in range(ops.MAX_PAYLOADS)]
    before = _launches()["repeat_by_z"]
    served, A = ops.repeat_cols(z, M, cols, want_anc=True)
    assert _launches()["repeat_by_z"] == before + 2   # 12 payloads, 8 a launch
    ref, A_ref = ops.repeat_cols_plain(z, M, cols, want_anc=True)
    torch.cuda.synchronize()
    assert torch.equal(A, A_ref)
    for y, yp in zip(served, ref, strict=True):
        assert y.dtype == yp.dtype and torch.equal(y, yp)
    assert torch.equal(ops.ancestors_by_z(z, M), A_ref)


@pytest.mark.parametrize("kind", B2_KINDS)
def test_repeat_kernel_strained_counts(dev, kind):
    """Exact on the offspring counts that strain the merge path (the CPU
    models' cases at the card's block of MERGE_TILE items: N and M not
    multiples of it), with every payload dtype and width."""
    rng = np.random.default_rng(len(kind))
    counts, M = _counts(kind, ops.MERGE_TILE, rng)
    N = len(counts)
    z = torch.from_numpy(np.cumsum(counts).astype(np.int32)).to(dev)
    cols = [torch.randn(N, device=dev),
            torch.randn(N, 2, device=dev, dtype=torch.float64),
            torch.randint(2 ** 24, 2 ** 31 - 1, (N,), device=dev,
                          dtype=torch.int32),
            torch.randint(-2 ** 62, 2 ** 62, (N,), device=dev,
                          dtype=torch.int64),
            torch.randint(-128, 127, (N,), device=dev, dtype=torch.int8),
            torch.randn(N, 3, device=dev).to(torch.float16)]
    served, A = ops.repeat_cols(z, M, cols, want_anc=True)
    ref, A_ref = ops.repeat_cols_plain(z, M, cols, want_anc=True)
    torch.cuda.synchronize()
    assert torch.equal(A, A_ref) and torch.equal(ops.ancestors_by_z(z, M),
                                                 A_ref)
    for y, yp in zip(served, ref, strict=True):
        assert y.dtype == yp.dtype and torch.equal(y, yp)


def test_wrappers_check_before_launching(dev):
    before = (_launches()["systematic_z"], _launches()["repeat_by_z"])
    with pytest.raises(TypeError):
        ops.systematic_z_fused(torch.ones(8, device=dev, dtype=torch.float64),
                               0.5, 8)
    z = ops.systematic_z_fused(torch.full((8,), 0.125, device=dev), 0.5, 8)
    with pytest.raises(ValueError):
        ops.repeat_cols(z, 8, [torch.zeros(8)])   # payload on the CPU
    with pytest.raises(TypeError):
        ops.repeat_cols(z, 8, [torch.zeros(8, device=dev,
                                           dtype=torch.complex128)])
    assert _launches()["systematic_z"] == before[0] + 1
    assert _launches()["repeat_by_z"] == before[1]


@pytest.mark.parametrize("N", [1, 7, 1000, 65539])
@pytest.mark.parametrize("alpha", [1.0, 0.05])
def test_normalised_cumsum_kernel_matches_plain(dev, N, alpha):
    """Monotone, top within 1e-6 of 1, and within N 2^-31 + 1e-6 of the
    plain version (the sum S is taken in another order)."""
    W = torch.from_numpy(_weights_dirichlet(N, alpha, N + 2)).to(dev)
    before = _launches()["normalised_cumsum"]
    cs = ops.normalised_cumsum_exact(W)
    assert _launches()["normalised_cumsum"] == before + 1
    cp = ops.normalised_cumsum_plain(W)
    torch.cuda.synchronize()
    assert cs.dtype == torch.float32 and cs.shape == (N,)
    assert float((cs - cp).abs().max()) < N * 2**-31 + 1e-6
    assert bool((cs[1:] >= cs[:-1]).all()) and abs(float(cs[-1]) - 1) < 1e-6


def _check_cumsum(W_np, dev):
    """Monotone, top within 1e-6 of 1, and within N 2^-31 + 1e-6 of the
    plain version and of float64."""
    N = len(W_np)
    W = torch.from_numpy(W_np).to(dev)
    cs = ops.normalised_cumsum_exact(W)
    cp = ops.normalised_cumsum_plain(W)
    torch.cuda.synchronize()
    W64 = W_np.astype(np.float64)
    oracle = torch.from_numpy(np.cumsum(W64) / W64.sum())
    tol = N * 2 ** -31 + 1e-6
    assert float((cs - cp).abs().max()) < tol
    assert float((cs.cpu().double() - oracle).abs().max()) < tol
    assert bool((cs[1:] >= cs[:-1]).all()) and abs(float(cs[-1]) - 1) < 1e-6


@pytest.mark.parametrize("kind", B3_KINDS)
def test_normalised_cumsum_kernel_edges(dev, kind):
    """The CPU models' cases at the card's geometry: the edges of a tile,
    of the one-tile chunks and of shared memory, and degenerate weights."""
    tile, cache_tiles, max_grid = ops.normalised_cumsum_geometry()
    _check_cumsum(_weights(kind, (max_grid, tile, cache_tiles),
                           np.random.default_rng(7)), dev)


def test_normalised_cumsum_kernel_beyond_shared_memory(dev):
    """N = 2^24: each block reads its chunk again in passes 2 and 3."""
    _check_cumsum(_weights_dirichlet(2 ** 24), dev)


def _one_cooperative_launch(monkeypatch, mod, fn, call):
    """``call`` runs one CUDA kernel; with the library's ``fn`` refusing
    the launch (720, cudaErrorCooperativeLaunchTooLarge), it raises and
    counts nothing (no fallback to the plain version)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    assert kernels == 5
    monkeypatch.setattr(mod._kernels(), fn, lambda *a: 720)
    before = _launches()
    with pytest.raises(RuntimeError, match="error 720"):
        call()
    assert _launches() == before


def test_normalised_cumsum_is_one_cooperative_launch(dev, monkeypatch):
    """One CUDA kernel a call; a refused launch raises and counts nothing
    (no fallback to the plain version)."""
    from particles_tpu_torch.ops import z_kernel

    W = torch.from_numpy(_weights_dirichlet(2 ** 20, 1.0, 3)).to(dev)
    _one_cooperative_launch(monkeypatch, z_kernel, "pt_normalised_cumsum",
                            lambda: ops.normalised_cumsum_exact(W))


def test_systematic_z_is_one_cooperative_launch(dev, monkeypatch):
    """B1 on B3's design: one CUDA kernel a call; a refused launch raises
    and counts nothing."""
    from particles_tpu_torch.ops import z_kernel

    W = torch.from_numpy(_weights_dirichlet(2 ** 20, 1.0, 3)).to(dev)
    u = torch.tensor(0.37, device=dev)
    _one_cooperative_launch(monkeypatch, z_kernel, "pt_systematic_z",
                            lambda: ops.systematic_z_fused(W, u, 2 ** 20))


def test_running_max_is_one_cooperative_launch(dev, monkeypatch):
    """B6 on the same skeleton with one grid barrier: one CUDA kernel a
    call; a refused launch raises and counts nothing."""
    from particles_tpu_torch.ops import cummax_kernel

    z = torch.randint(-2 ** 31, 2 ** 31 - 1, (2 ** 20,), device=dev,
                      dtype=torch.int32)
    _one_cooperative_launch(monkeypatch, cummax_kernel, "pt_running_max",
                            lambda: ops.running_max(z))


def test_one_launch_scans_share_a_geometry(dev):
    """B1, B3 and B6 cut their input alike (coop_chunks.cuh), so the
    chunk-edge sizes of one are those of the others."""
    g = ops.normalised_cumsum_geometry()
    assert g == ops.systematic_z_geometry() == ops.running_max_geometry()
    assert g[:2] == (4096, 6) and g[2] >= 1


def _check_systematic_z(W_np, M, dev):
    """Within 1 of the plain version (S is summed in another order), and
    no further from the float64 oracle than the plain version is, plus 1:
    the fixed-point grid (2^-30 of the total a weight) is the function's
    own error, which passes 1 above N = 2^20 and at M = 4N; nondecreasing,
    ``z[-1] == M``."""
    N = len(W_np)
    W = torch.from_numpy(W_np).to(dev)
    for u in (0.0, 0.37, 0.999):
        ut = torch.tensor(u, dtype=torch.float32, device=dev)
        z = ops.systematic_z_fused(W, ut, M)
        zp = ops.systematic_z_plain(W, ut, M)
        torch.cuda.synchronize()
        assert z.dtype == torch.int32 and z.shape == (N,)
        zc = z.cpu().numpy().astype(np.int64)
        zpc = zp.cpu().numpy().astype(np.int64)
        zo = _oracle_z(W_np, np.float32(u), M)
        assert np.abs(zc - zpc).max() <= 1
        assert np.abs(zc - zo).max() <= max(1, np.abs(zpc - zo).max() + 1)
        assert np.all(np.diff(zc) >= 0)
        assert zc[-1] == M and zc.min() >= 0 and zc.max() <= M


def _exact_sum_weights(N, seed):
    """W_i = k_i 2^-24 with k_i < 256: every partial sum is a multiple of
    2^-24 below 2^32, exact in double in any order."""
    k = np.random.default_rng(seed).integers(0, 256, N)
    k[-1] = 1 + k[-1]                       # S > 0
    return (k * 2.0 ** -24).astype(np.float32)


@pytest.mark.parametrize("N", [1, 4097, 2 ** 20 - 513, 2 ** 24])
def test_fixed_point_kernels_are_exact_on_exact_sums(dev, N):
    """Where S is summed exactly, S, scale, q and Q are the same bits in the
    kernels as in the plain versions, so z (u in three values, M = N and
    4N) and cs equal the plain versions bit for bit."""
    W = torch.from_numpy(_exact_sum_weights(N, N)).to(dev)
    assert torch.equal(ops.normalised_cumsum_exact(W),
                       ops.normalised_cumsum_plain(W))
    for M in (N, 4 * N):
        for u in (0.0, 0.37, 0.999):
            ut = torch.tensor(u, dtype=torch.float32, device=dev)
            assert torch.equal(ops.systematic_z_fused(W, ut, M),
                               ops.systematic_z_plain(W, ut, M))


@pytest.mark.parametrize("M_of", ["N", "4N"])
@pytest.mark.parametrize("kind", B3_KINDS)
def test_systematic_z_kernel_edges(dev, kind, M_of):
    """The CPU models' cases at the card's geometry: the edges of a tile,
    of the one-tile chunks and of shared memory, and degenerate weights."""
    tile, cache_tiles, max_grid = ops.systematic_z_geometry()
    W_np = _weights(kind, (max_grid, tile, cache_tiles),
                    np.random.default_rng(7))
    _check_systematic_z(W_np, {"N": 1, "4N": 4}[M_of] * len(W_np), dev)


@pytest.mark.parametrize("M_of", ["N", "4N"])
def test_systematic_z_kernel_beyond_shared_memory(dev, M_of):
    """N = 2^24: each block reads its chunk again in passes 2 and 3."""
    N = 2 ** 24
    _check_systematic_z(_weights_dirichlet(N), {"N": 1, "4N": 4}[M_of] * N,
                        dev)


def _cdf(W):
    cs = ops.normalised_cumsum_exact(W)
    cs[-1] = 1.0
    return cs


def _su_payloads(N, dev):
    return [torch.randn(N, device=dev),
            torch.randn(N, 2, device=dev, dtype=torch.float64),
            torch.randint(2 ** 24, 2 ** 31 - 1, (N,), device=dev,
                          dtype=torch.int32),
            torch.randint(-128, 127, (N,), device=dev, dtype=torch.int8),
            torch.randn(N, 3, device=dev).to(torch.float16)]


def _check_su_move(su, cs, dev, cols=None):
    """The kernel against its plain version, exact: ancestors with the
    payloads, and ancestors alone."""
    N, M = cs.shape[0], su.shape[0]
    cols = _su_payloads(N, dev) if cols is None else cols
    before = _launches()["repeat_by_su"]
    served, A = ops.repeat_cols_su(su, cs, M, cols, want_anc=True)
    A_only = ops.ancestors_by_su(su, cs)
    assert _launches()["repeat_by_su"] == before + 2
    ref, A_ref = ops.repeat_cols_su_plain(su, cs, M, cols, want_anc=True)
    torch.cuda.synchronize()
    assert A.dtype == torch.int64
    assert torch.equal(A, A_ref) and torch.equal(A_only, A_ref)
    for y, yp in zip(served, ref, strict=True):
        assert y.dtype == yp.dtype and torch.equal(y, yp)


@pytest.mark.parametrize("N,k", [(1, 1), (1000, 1), (65539, 1), (1000, 4),
                                 (2 ** 20 - 513, 4)])
@pytest.mark.parametrize("order", ["sorted", "unsorted", "tied"])
def test_repeat_su_kernel_matches_plain(dev, N, k, order):
    """Exact: sorted, unsorted and tied queries (equal to cs values), M =
    k N, several dtypes, the fused form with ancestors and the
    ancestors-only form."""
    cs = _cdf(torch.from_numpy(_weights_dirichlet(N, 0.3, N + 3)).to(dev))
    u = torch.rand(k * N, device=dev)
    if order == "sorted":
        u = u.sort().values
    elif order == "tied":
        u[::2] = cs[torch.randint(0, N, (u[::2].shape[0],), device=dev)]
    _check_su_move(u, cs, dev)


@pytest.mark.parametrize("N", [7, 4093, 2 ** 20 - 513])
@pytest.mark.parametrize("kind", B4_KINDS)
def test_repeat_su_kernel_strained(dev, kind, N):
    """Exact on the CPU model's cases at the card's guide table: one
    particle with all the weight, ties, queries on cs values, at 0, an ulp
    below the top, negative and past the top, an integer cs served at idx
    + 0.5, cs[-1] = 0, negative, tiny, huge or infinite cs, M = 1, N/2 + 1
    and 4N; and element for element the model's answer."""
    su, cs = _guide_case(kind, N, np.random.default_rng(len(kind) + N))
    want, _, _ = _guide_ancestors(su, cs, ops.guide_buckets(N))
    su_t, cs_t = torch.from_numpy(su).to(dev), torch.from_numpy(cs).to(dev)
    _check_su_move(su_t, cs_t, dev, cols=_su_payloads(N, dev)[:2])
    np.testing.assert_array_equal(
        ops.ancestors_by_su(su_t, cs_t).cpu().numpy(), want)


def test_repeat_su_is_a_build_and_a_serve(dev):
    """A build and a serve a call; a call with more payloads than one
    launch takes builds once and serves twice, and is exact.  The profiler
    now and then misses one kernel of a window, so the counts are held by
    kernel name to within one."""
    from torch.profiler import ProfilerActivity, profile

    N = 2 ** 20
    cs = _cdf(torch.from_numpy(_weights_dirichlet(N, 1.0, 5)).to(dev))
    u = torch.rand(N, device=dev)
    cols = [torch.randn(N, device=dev) for _ in range(ops.MAX_PAYLOADS + 1)]
    served, _ = ops.repeat_cols_su(u, cs, N, cols)
    ref, _ = ops.repeat_cols_su_plain(u, cs, N, cols)
    assert all(torch.equal(y, yp) for y, yp in zip(served, ref, strict=True))
    calls = 10
    for call, serves in ((lambda: ops.ancestors_by_su(u, cs), 1),
                         (lambda: ops.repeat_cols_su(u, cs, N, cols), 2)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.key] = by_name.get(e.key, 0) + e.count
        builds = sum(n for k, n in by_name.items() if "k_guide_build" in k)
        serve = sum(n for k, n in by_name.items() if "k_serve_guide" in k)
        assert sum(by_name.values()) == builds + serve, by_name
        assert calls - 1 <= builds <= calls, by_name
        assert serves * calls - 1 <= serve <= serves * calls, by_name


@pytest.mark.parametrize("N,L,M", [(1000, 1000, 1000), (65539, 65539, 65539),
                                   (1000, 3000, 2000), (1000, 10, 10)])
def test_merge_rank_kernel_matches_plain(dev, N, L, M):
    """Exact, M != N included, with ties (su holding cs values) and, for
    the kernel, a nondecreasing z on an su one ulp out of order."""
    cs = _cdf(torch.from_numpy(_weights_dirichlet(N, 0.3, N + 4)).to(dev))
    su = torch.rand(L, device=dev)
    tied = torch.cat([su[: L // 2], cs[torch.randint(0, N, (L - L // 2,),
                                                     device=dev)]])
    for s in (su.sort().values, tied.sort().values):
        before = _launches()["merge_rank_counts"]
        z = ops.merge_rank_counts(s, cs, M)
        assert _launches()["merge_rank_counts"] == before + 1
        zp = ops.merge_rank_counts_plain(s, cs, M)
        torch.cuda.synchronize()
        assert z.dtype == torch.int32 and torch.equal(z, zp)
    dip = su.sort().values
    if L > 2:
        dip[1::7] = torch.nextafter(dip[0:-1:7], torch.zeros(()).to(dev))
        z = ops.merge_rank_counts(dip, cs, M)
        assert bool((z[1:] >= z[:-1]).all())


@pytest.mark.parametrize("kind", B5_KINDS)
def test_merge_rank_kernel_strained(dev, kind):
    """Exact on the CPU model's cases at the card's tile and window: all
    weight on one particle, a block's window at and one past shared
    memory, residual's 2.0 tail, L = 1, M below L, ties."""
    su, cs, M = _rank_case(kind, ops.MERGE_RANK_TILE, ops.MERGE_RANK_WINDOW,
                           np.random.default_rng(len(kind)))
    su, cs = torch.from_numpy(su).to(dev), torch.from_numpy(cs).to(dev)
    z = ops.merge_rank_counts(su, cs, M)
    zp = ops.merge_rank_counts_plain(su, cs, M)
    torch.cuda.synchronize()
    assert z.dtype == torch.int32 and torch.equal(z, zp)


@pytest.mark.parametrize("keys", B5_DIP_KEYS)
def test_merge_rank_kernel_on_a_dip(dev, keys):
    """On uniforms that dip by an ulp the kernel gives its CPU model's
    answer element for element (nondecreasing, each a binary search's)."""
    threads, items, window, lanes = B5_GEOMETRIES[-1]   # the card's
    assert (threads * items, window) == (ops.MERGE_RANK_TILE,
                                         ops.MERGE_RANK_WINDOW)
    su, cs = _dip_case(keys, ops.MERGE_RANK_TILE, np.random.default_rng(9))
    N = len(cs)
    want, _, _ = _rank_blocks(su, cs, N, threads, items, window, lanes)
    z = ops.merge_rank_counts(torch.from_numpy(su).to(dev),
                              torch.from_numpy(cs).to(dev), N)
    np.testing.assert_array_equal(z.cpu().numpy(), want)


def test_trimmed_wrappers_raise_on_a_refused_launch(dev, monkeypatch):
    """B1, B4, B5 and B6 launch through on_device with one allocation; a
    refused launch raises and counts nothing (no fallback)."""
    from particles_tpu_torch.ops import cummax_kernel, merge_rank_kernel
    from particles_tpu_torch.ops import repeat_kernel, z_kernel

    W = torch.full((1000,), 1e-3, device=dev)
    cs = ops.normalised_cumsum_exact(W)
    zi = torch.arange(1000, device=dev, dtype=torch.int32)
    calls = [(z_kernel, "pt_systematic_z",
              lambda: ops.systematic_z_fused(W, 0.5, 1000)),
             (merge_rank_kernel, "pt_merge_rank_counts",
              lambda: ops.merge_rank_counts(cs, cs, 1000)),
             (repeat_kernel, "pt_repeat_by_su",
              lambda: ops.ancestors_by_su(cs, cs)),
             (cummax_kernel, "pt_running_max",
              lambda: ops.running_max(zi))]
    for mod, fn, call in calls:
        call()
        lib = mod._kernels()
        monkeypatch.setattr(lib, fn, lambda *a: 720)
        before = _launches()
        with pytest.raises(RuntimeError, match="error 720"):
            call()
        assert _launches() == before
        monkeypatch.undo()


@pytest.mark.parametrize("N", [1, 7, 1000, 1025, 65539])
def test_running_max_kernel_matches_plain(dev, N):
    """Exact on negative values and unaligned N."""
    z = torch.randint(-2 ** 31, 2 ** 31 - 1, (N,), device=dev,
                      dtype=torch.int32)
    before = _launches()["running_max"]
    y = ops.running_max(z)
    assert _launches()["running_max"] == before + 1
    torch.cuda.synchronize()
    assert y.dtype == torch.int32
    assert torch.equal(y, ops.running_max_plain(z))
    w = torch.randint(-5, 0, (N,), device=dev, dtype=torch.int32)
    assert torch.equal(ops.running_max(w), torch.cummax(w, 0).values)


@pytest.mark.parametrize("size", B6_SIZES)
@pytest.mark.parametrize("kind", B6_KINDS)
def test_running_max_kernel_edges(dev, kind, size):
    """The CPU model's cases at the card's geometry, exact: all INT_MIN,
    the whole int32 range, descending, spikes on both sides of every chunk
    boundary."""
    tile, cache_tiles, max_grid = ops.running_max_geometry()
    z_np = _ints(kind, size, (max_grid, tile, cache_tiles),
                 np.random.default_rng(5))
    z = torch.from_numpy(z_np).to(dev)
    y = ops.running_max(z)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(y.cpu().numpy(), np.maximum.accumulate(z_np))


def test_running_max_kernel_beyond_shared_memory(dev):
    """N = 2^24: each block reads its chunk again in pass 2."""
    z = torch.randint(-2 ** 31, 2 ** 31 - 1, (2 ** 24,), device=dev,
                      dtype=torch.int32)
    assert torch.equal(ops.running_max(z), ops.running_max_plain(z))


def test_bootstrap_filter_on_the_card(dev):
    """Small filter on the card: logLt within 0.5 of the float64 Kalman
    logLt, and each kernel launched once per resampling step."""
    rng = np.random.default_rng(0)
    T, N = 50, 2 ** 14
    xs = np.zeros(T)
    for t in range(1, T):
        xs[t] = 0.9 * xs[t - 1] + rng.normal()
    y = (xs + 0.2 * rng.normal(size=T)).astype(np.float32)
    ssm = kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    kf = float(kalman.Kalman(ssm=ssm,
                             data=torch.from_numpy(y.astype(np.float64))).logLt)
    tracing.reset()
    pf = SMC(fk=ssms.Bootstrap(ssm=ssm, data=torch.from_numpy(y).to(dev)),
             N=N, seed=0)
    pf.run()
    n_rs = int(pf.summaries.rs_flags.sum())
    assert _launches()["systematic_z"] == _launches()["repeat_by_z"] == n_rs
    assert pf.X.device.type == "cuda"
    assert abs(float(pf.logLt) - kf) < 0.5


def test_every_scheme_on_the_card(dev):
    """multiSMC over every scheme with numpy data and no device: each run
    on the card, logLt within 0.5 of Kalman, and each kernel launched once
    per resampling step, in the scheme's combination."""
    rng = np.random.default_rng(1)
    T, N = 30, 2 ** 14
    xs = np.zeros(T)
    for t in range(1, T):
        xs[t] = 0.9 * xs[t - 1] + rng.normal()
    y = (xs + 0.2 * rng.normal(size=T)).astype(np.float32)
    ssm = kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    kf = float(kalman.Kalman(ssm=ssm,
                             data=torch.from_numpy(y.astype(np.float64))).logLt)
    fk = ssms.Bootstrap(ssm=ssm, data=y)
    assert fk.data.device.type == "cuda"
    expected = {"systematic": {"systematic_z", "repeat_by_z"},
                "stratified": {"normalised_cumsum", "repeat_by_z"},
                "multinomial": {"running_max", "normalised_cumsum",
                                "merge_rank_counts", "repeat_by_z"},
                "residual": {"running_max", "normalised_cumsum",
                             "merge_rank_counts", "repeat_by_z"},
                "ssp": {"repeat_by_z"},
                "killing": {"normalised_cumsum", "repeat_by_su"}}
    seen = []

    def out(res):
        seen.append(_launches())
        return res

    tracing.reset()
    seen.append(_launches())
    runs = multiSMC(fk=fk, N=N, resampling=list(expected), nruns=1,
                    out_func=out)
    for k, entry in enumerate(runs):
        res = entry["output"]
        n_rs = int(res.rs_flags.sum())
        assert n_rs > 0 and res.lw.device.type == "cuda"
        assert abs(float(res.logLt) - kf) < 0.5, entry["resampling"]
        for name in ops.KERNELS:
            n = seen[k + 1][name] - seen[k][name]
            want = n_rs if name in expected[entry["resampling"]] else 0
            assert n == want, (entry["resampling"], name, n, n_rs)


def test_step_syncs_only_on_the_decision(dev):
    """The step's one host sync is the resampling decision: with the
    decision returned as a host bool, whole resampling steps of every
    scheme run with synchronising operations made errors, and so does the
    end of the run (the summaries and the history stacked).  Storing the
    history (all of it, or a window of k frames) and a collector of the
    genealogy add no sync.  The sequential SSP below 8192 particles is the
    stated exception, so N is above it (the tree pairing)."""
    from particles_tpu_torch import collectors as col
    from particles_tpu_torch import resampling as rs
    from particles_tpu_torch import smoothing
    from particles_tpu_torch import variance_estimators as ve

    class Always(ssms.Bootstrap):
        def time_to_resample(self, smc):
            return True

    y = torch.randn(4, device=dev)
    fk = Always(ssm=kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2),
                data=y)
    options = [{}, {"store_history": True}, {"store_history": 2},
               {"collect": [col.Fixed_lag_smooth(lag=2), ve.Var()]}]
    for scheme in rs.rs_funcs:
        for opts in options:
            pf = SMC(fk=fk, N=3 * rs._SSP_BLOCKED_MIN, resampling=scheme,
                     seed=0, **opts)
            next(pf)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in pf:
                    pass
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert pf.t == 4 and pf.rs_flag is True, (scheme, opts)
            if opts.get("store_history") is True:
                assert isinstance(pf.hist, smoothing.ParticleHistory)
                assert pf.hist.A.shape == (4, pf.N)
                assert pf.hist.A.dtype == torch.int64
            elif "store_history" in opts:
                assert pf.hist.T == 2
            else:
                assert pf.A is not None or "collect" not in opts


def test_smoothers_draw_through_the_kernels(dev):
    """The history, the backward passes and PaRIS on the card: B2 returns
    the ancestors the history holds, each set of weights drawn from is one
    B3 launch (its CDF), and each draw from it one B4 launch."""
    from particles_tpu_torch import collectors as col
    from particles_tpu_torch import resampling as rs

    class LGsmooth(kalman.LinearGauss):
        def add_func(self, t, xp, x):
            return x

    ssm = LGsmooth(rho=0.9, sigmaX=1.0, sigmaY=0.3)
    y = torch.from_numpy(np.random.default_rng(0).normal(size=12)
                         .astype(np.float32)).to(dev)
    fk = ssms.Bootstrap(ssm=ssm, data=y)
    N = 4096
    b2 = _launches()["repeat_by_z"]
    pf = SMC(fk=fk, N=N, seed=1, store_history=True,
             collect=[col.Paris(Nparis=2, max_trials=8)])
    pf.run()
    n_rs = int(pf.summaries.rs_flags.sum())
    assert _launches()["repeat_by_z"] - b2 == n_rs
    A = pf.hist.A
    assert A.device == dev and A.dtype == torch.int64 and A.shape == (12, N)
    for t in range(1, 12):
        if pf.summaries.rs_flags[t]:
            assert bool((A[t, 1:] >= A[t, :-1]).all())
    assert torch.isfinite(pf.summaries.paris).all()
    gen = torch.Generator(device=dev).manual_seed(2)
    for name, call, cdfs, draws in (
            ("mcmc", lambda: pf.hist.backward_sampling_mcmc(gen, N),
             lambda: 12, lambda: 12),
            ("reject", lambda: pf.hist.backward_sampling_reject(
                gen, N, max_trials=8), lambda: 12,
             lambda: 1 + sum(pf.hist.rounds)),
            ("ON2", lambda: pf.hist.backward_sampling_ON2(gen, 512),
             lambda: 1, lambda: 1)):
        b3 = _launches()["normalised_cumsum"]
        b4 = _launches()["repeat_by_su"]
        paths = call()
        n3 = _launches()["normalised_cumsum"] - b3
        n4 = _launches()["repeat_by_su"] - b4
        assert (n3, n4) == (cdfs(), draws()), (name, n3, n4)
        assert paths.device == dev and torch.isfinite(paths).all(), name
    W = pf.hist.wgts.W
    A1, (v,) = rs.multinomial_iid_values(gen, W, [pf.hist.X[-1]], N)
    assert torch.equal(v, pf.hist.X[-1][A1])


@pytest.mark.parametrize("fk_cls", ["AuxiliaryBootstrap", "GuidedPF",
                                    "AuxiliaryPF"])
def test_guided_and_auxiliary_steps_sync_only_on_the_decision(dev, fk_cls):
    """A guided or auxiliary step syncs only on the resampling decision,
    as the bootstrap step does: the auxiliary weights, the resampling on
    them and the reset from logeta on the served particles read no device
    value on the host, by the z-form (B1 + B2) and by a gather
    (``killing``)."""
    class Always(getattr(ssms, fk_cls)):
        def time_to_resample(self, smc):
            return True

    y = torch.randn(5, device=dev)
    fk = Always(ssm=kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2),
                data=y)
    for scheme in ("systematic", "killing"):
        b1 = _launches()["systematic_z"]
        pf = SMC(fk=fk, N=2 ** 15, resampling=scheme, seed=0)
        next(pf)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in pf:
                pass
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert pf.t == 5 and pf.rs_flag is True
        assert torch.isfinite(pf.logLt)
        assert (_launches()["systematic_z"] - b1
                == (4 if scheme == "systematic" else 0))


def test_b1_on_the_auxiliary_weights_matches_plain(dev):
    """B1 on the weights an auxiliary filter resamples on (lw + logeta, at
    three steps of a run) within 1 of its plain version, and B2 equal to
    its plain version on the particles it moves."""
    rng = np.random.default_rng(3)
    T, N = 12, 2 ** 16
    xs = np.zeros(T)
    for t in range(1, T):
        xs[t] = 0.9 * xs[t - 1] + rng.normal()
    y = torch.from_numpy((xs + 0.2 * rng.normal(size=T))
                         .astype(np.float32)).to(dev)
    fk = ssms.AuxiliaryBootstrap(
        ssm=kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2), data=y)
    pf = SMC(fk=fk, N=N, seed=4)
    checked = 0
    while pf.t < T:
        X = pf.X
        next(pf)
        if pf.t - 1 in (1, T // 2, T - 1):
            W = pf.aux.W
            u = torch.tensor(0.37, device=dev)
            z = ops.systematic_z_fused(W, u, N)
            zp = ops.systematic_z_plain(W, u, N)
            assert int((z.long() - zp.long()).abs().max()) <= 1
            assert bool((z[1:] >= z[:-1]).all()) and int(z[-1]) == N
            (Xs,), A = ops.repeat_cols(z, N, [X], want_anc=True)
            (Xq,), Aq = ops.repeat_cols_plain(z, N, [X], want_anc=True)
            assert torch.equal(Xs, Xq) and torch.equal(A, Aq)
            checked += 1
    assert checked == 3


def test_betainc_quantiles_read_no_device_value(dev):
    """``betainc`` runs a fixed number of terms, so the quantiles that
    bisect it (``Beta``, ``Student``, ``Binomial``) make no host sync, and
    agree with the same functions on the CPU (rtol 1e-5, atol 1e-6)."""
    from particles_tpu_torch import distributions as dists
    u = torch.linspace(0.01, 0.99, 257)
    laws = (dists.Beta(a=2.5, b=300.0), dists.Student(df=6.5, loc=0.2),
            dists.Binomial(n=12, p=0.3))
    on_cpu = [law.ppf(u) for law in laws]
    u_dev = u.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        on_dev = [law.ppf(u_dev) for law in laws]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for got, want in zip(on_dev, on_cpu):
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fk_cls,dx", [("Bootstrap", 1), ("AuxiliaryPF", 1),
                                       ("Bootstrap", 2)])
def test_sqmc_steps_sync_never(dev, fk_cls, dx):
    """An SQMC step reads no device value on the host: whole steps after
    the first, with and without the history (the ancestors riding B4), run
    with synchronising operations made errors.  Each step launches B3 once
    and B4 once, and no other kernel; N = 2^14 takes the closed-form
    sorted points, N = 3000 the sort."""
    if dx == 1:
        ssm = kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
        y = torch.randn(6, device=dev)
    else:
        ssm = kalman.MVLinearGauss_Guarniero_etal(alpha=0.4, dx=dx,
                                                  device=dev)
        y = torch.randn(6, dx, device=dev)
    fk = getattr(ssms, fk_cls)(ssm=ssm, data=y)
    for N, opts in ((2 ** 14, {}), (2 ** 14, {"store_history": True}),
                    (3000, {"store_history": 2})):
        pf = SMC(fk=fk, N=N, qmc=True, seed=0, **opts)
        next(pf)
        torch.cuda.synchronize()
        before = _launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in pf:
                pass
        finally:
            torch.cuda.set_sync_debug_mode("default")
        after = _launches()
        n = {k: after[k] - before[k] for k in ops.KERNELS}
        want = {k: 5 if k in ("normalised_cumsum", "repeat_by_su") else 0
                for k in ops.KERNELS}
        assert n == want, (N, opts, n)
        assert pf.t == 6 and bool(torch.isfinite(pf.logLt))
        if opts.get("store_history") is True:
            assert pf.hist.hilbert_ordered and pf.hist.A.device == dev


def test_sobol_and_hilbert_keys_on_the_card_equal_the_cpu(dev):
    """For the same scramble words, the points of every scramble and of the
    sorted set, and the Hilbert keys of the same integers, are the CPU's
    bit for bit."""
    from particles_tpu_torch import hilbert, rqmc
    gen = torch.Generator().manual_seed(9)
    for scramble in ("lms_shift", "shift", "owen"):
        words = rqmc.scramble_words(gen, 5, scramble)
        on_dev = {k: v.to(dev) for k, v in words.items()}
        for start, count in ((0, None), (1000, 333)):
            want = rqmc.sobol_from_words(words, 4096, 5, scramble, start,
                                         count)
            got = rqmc.sobol_from_words(on_dev, 4096, 5, scramble, start,
                                        count)
            assert torch.equal(got.cpu(), want), (scramble, start)
        if scramble == "lms_shift":
            assert torch.equal(
                rqmc.sobol_sorted0_from_words(on_dev, 2 ** 16, 5).cpu(),
                rqmc.sobol_sorted0_from_words(words, 2 ** 16, 5))
    for d, nbits in ((2, 12), (3, 8), (4, 15)):
        c = torch.randint(0, 2 ** nbits, (10000, d), generator=gen)
        assert torch.equal(hilbert.hilbert_index(c.to(dev), nbits).cpu(),
                           hilbert.hilbert_index(c, nbits))


def test_qmc_ffbs_on_the_card(dev):
    """A QMC FFBS pass on an SQMC history builds the last CDF once (B3) and
    serves the last column from it once (B4); the paths are finite and
    their means near the Kalman smoother's."""
    rng = np.random.default_rng(5)
    T = 10
    xs = np.zeros(T)
    for t in range(1, T):
        xs[t] = 0.9 * xs[t - 1] + rng.normal()
    y = (xs + 0.2 * rng.normal(size=T)).astype(np.float32)
    ssm = kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    kf = kalman.Kalman(ssm=ssm, data=torch.from_numpy(y).double())
    kf.smoother()
    pf = SMC(fk=ssms.Bootstrap(ssm=ssm, data=torch.from_numpy(y).to(dev)),
             N=2 ** 12, qmc=True, store_history=True, seed=1)
    pf.run()
    b3 = _launches()["normalised_cumsum"]
    b4 = _launches()["repeat_by_su"]
    paths = pf.hist.backward_sampling_qmc(
        torch.Generator(device=dev).manual_seed(2), 2 ** 10)
    assert _launches()["normalised_cumsum"] - b3 == 1
    assert _launches()["repeat_by_su"] - b4 == 1
    assert paths.device == dev and bool(torch.isfinite(paths).all())
    np.testing.assert_allclose(paths.mean(1).cpu().numpy(),
                               kf.smth.mean[:, 0].numpy(), atol=0.15)


def _conjugate_sampler_model(dev, T=30):
    """The conjugate Gaussian mean model of tests/test_torch_samplers.py,
    its data on the card, and its exact log-evidence."""
    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import smc_samplers as ssp

    class GaussianMean(ssp.StaticModel):
        def logpyt(self, theta, t):
            return dists.Normal(loc=theta["mu"]).logpdf(self.data[t])

    y = np.random.default_rng(0).normal(loc=1.5, size=T).astype(np.float32)
    model = GaussianMean(data=torch.from_numpy(y).to(dev),
                         prior=dists.StructDist({"mu": dists.Normal()}))
    # y ~ N(0, I + 11^T): log det = log(1 + T), inverse I - 11^T / (1 + T)
    s = float(y.astype(np.float64).sum())
    q = float((y.astype(np.float64) ** 2).sum()) - s * s / (1 + T)
    exact = -0.5 * (T * np.log(2 * np.pi) + np.log(1 + T) + q)
    return model, exact


@pytest.mark.parametrize("cls", ["IBIS", "Tempering", "AdaptiveTempering"])
def test_sampler_steps_sync_only_on_the_declared_read(dev, cls):
    """A sampler step reads one device value on the host: the resampling
    decision (IBIS, Tempering; returned here as a host bool) or none
    (AdaptiveTempering, whose read is ``done``'s exponent test).  With
    synchronising operations made errors, resample-move steps run
    through B1 and B2: calibration, the waste-free move, the bisection
    and the path sampling stay on the card."""
    from particles_tpu_torch import smc_samplers as ssp

    model, _ = _conjugate_sampler_model(dev)
    kw = {"exponents": np.linspace(0.1, 1.0, 5)} if cls == "Tempering" else {}
    fk = getattr(ssp, cls)(model=model, len_chain=4, **kw)
    declared = fk.time_to_resample

    def host_decision(view):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return bool(declared(view))
        finally:
            torch.cuda.set_sync_debug_mode("error")

    fk.time_to_resample = host_decision
    N = 256
    gen = torch.Generator(device=dev).manual_seed(0)
    carry, _ = ssp._sampler_step0(fk, gen, N)
    torch.cuda.synchronize()
    b1, b2 = _launches()["systematic_z"], _launches()["repeat_by_z"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(1, 4):
            carry, view = ssp._sampler_step(fk, gen, carry, t, N,
                                            "systematic", 1.1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert view.rs_flag is True and carry.X.N == 4 * N
    assert _launches()["systematic_z"] - b1 == 3
    assert _launches()["repeat_by_z"] - b2 == 3
    assert bool(torch.isfinite(carry.logLt))


def test_adaptive_move_reads_once_a_chain_step(dev):
    """AdaptiveMCMCSequence(adaptive=True) reads its stopping test once a
    chain step and nothing else."""
    import warnings

    from particles_tpu_torch import smc_samplers as ssp

    model, _ = _conjugate_sampler_model(dev)
    move = ssp.AdaptiveMCMCSequence(len_chain=20, adaptive=True)
    fk = ssp.AdaptiveTempering(model=model, wastefree=False, move=move)
    gen = torch.Generator(device=dev).manual_seed(1)
    carry, _ = ssp._sampler_step0(fk, gen, 4096)
    steps = []
    step_with = move.mcmc.step_with

    def counted(*a, **kw):
        steps.append(1)
        return step_with(*a, **kw)

    move.mcmc.step_with = counted
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            carry, _ = ssp._sampler_step(fk, gen, carry, 1, 4096,
                                         "systematic", 0.5)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    assert 1 <= len(steps) <= move.nsteps
    assert syncs == min(len(steps), move.nsteps - 1)
    assert 0.0 < float(carry.X.shared["acc_rate"]) <= 1.0


def test_wastefree_resample_kernels_match_plain(dev):
    """B1 and B2 at the waste-free shape, M starting points of N0 = 64 M:
    z within 1 of the plain version, every leaf served exactly, and
    ceil(leaves / 8) launches of B2."""
    from particles_tpu_torch import smc_samplers as ssp

    M = 2 ** 10
    N0 = 64 * M
    W = torch.from_numpy(_weights_dirichlet(N0, 0.5, 3)).to(dev)
    u = torch.tensor(0.61, device=dev)
    z = ops.systematic_z_fused(W, u, M)
    zp = ops.systematic_z_plain(W, u, M)
    assert int((z.long() - zp.long()).abs().max()) <= 1
    assert int(z[-1]) == M
    gen = torch.Generator(device=dev).manual_seed(4)
    theta = {f"b{j}": torch.randn(N0, device=dev, generator=gen)
             for j in range(9)}
    x = ssp.ThetaParticles(theta=theta, lpost=torch.randn(N0, device=dev),
                           lprior=torch.randn(N0, device=dev),
                           llik=torch.randn(N0, device=dev))
    before = _launches()["repeat_by_z"]
    served = x.subset_by_z(z, M)
    assert _launches()["repeat_by_z"] - before == 2      # 12 leaves
    leaves, _ = x._leaves()
    want, _ = ops.repeat_cols_plain(z, M, leaves)
    got, _ = served._leaves()
    for g, w in zip(got, want, strict=True):
        assert g.shape == (M,) and torch.equal(g, w)


def test_samplers_on_the_card(dev):
    """IBIS and waste-free AdaptiveTempering on the card (the default
    device of the model's data) within 0.5 of the exact evidence; B1 and
    B2 once a resampling step, no other kernel."""
    from particles_tpu_torch import smc_samplers as ssp

    model, exact = _conjugate_sampler_model(dev)
    for fk in (ssp.IBIS(model=model, len_chain=8),
               ssp.AdaptiveTempering(model=model, len_chain=8)):
        before = _launches()
        pf = SMC(fk=fk, N=2 ** 11, seed=0)
        pf.run()
        n_rs = int(pf.summaries.rs_flags.sum())
        assert pf.X.theta["mu"].device == dev and n_rs > 0
        assert abs(float(pf.logLt) - exact) < 0.5
        after = _launches()
        for k in ops.KERNELS:
            want = n_rs if k in ("systematic_z", "repeat_by_z") else 0
            assert after[k] - before[k] == want, (type(fk), k)


# ---------------------------------------------------------------------------
# the outer loops: PMMH, CSMC, SMC², the checkpoint
# ---------------------------------------------------------------------------

def _sync_count():
    return sum(v for k, v in tracing.counts().items()
               if k.startswith("sync."))


def _count_syncs(fn):
    """(fn(), host syncs under set_sync_debug_mode("warn")); ``tracing``
    counted each of them as one ``sync.<site>``."""
    import warnings

    counted = _sync_count()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    assert _sync_count() - counted == syncs
    return out, syncs


def test_pmmh_chain_loop_syncs_never(dev):
    """The PMMH chain loop (4 batched chains of StochVol filters) with
    synchronising operations made errors; the host reads the accept
    counts only after it."""
    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import mcmc

    rng = np.random.default_rng(0)
    y = (0.5 * rng.normal(size=30)).astype(np.float32)
    prior = dists.StructDist({"mu": dists.Normal(scale=2.0),
                              "rho": dists.Uniform(a=-0.99, b=0.99),
                              "sigma": dists.Gamma(a=2.0, b=4.0)})
    m = mcmc.PMMH(ssm_cls=ssms.StochVol, prior=prior,
                  data=torch.from_numpy(y).to(dev), Nx=64, niter=20,
                  nchains=4, seed=1)
    before = _launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m._chain()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    m._finish()
    assert m.chain.theta["rho"].shape == (20, 4)
    assert torch.isfinite(m.chain.lpost).all()
    assert _launches() == before


def test_csmc_steps_sync_never(dev):
    """CSMC steps with synchronising operations made errors: B6 (the
    sorted spacings), B3, B5 and B2 once a step (the multinomial
    ancestors), particle 0 pinned."""
    from particles_tpu_torch import mcmc

    T, N = 20, 2 ** 12
    ssm = kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    _, y = ssm.simulate(torch.Generator(device=dev).manual_seed(0), T)
    xstar = torch.linspace(-1.0, 1.0, T, device=dev)
    cpf = mcmc.CSMC(fk=ssms.Bootstrap(ssm=ssm, data=y), N=N, xstar=xstar,
                    seed=2)
    before = _launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cpf._run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = _launches()
    for k in ops.KERNELS:
        want = T - 1 if k in ("running_max", "normalised_cumsum",
                              "merge_rank_counts", "repeat_by_z") else 0
        assert after[k] - before[k] == want, k
    assert torch.equal(cpf.hist.X[:, 0], xstar)
    assert bool((cpf.hist.A[:, 0] == 0).all())


def test_smc2_step_syncs_once_plus_the_exchange_read(dev):
    """An SMC² step reads the resampling decision; after a resample-move
    the exchange step reads the acceptance rate too (here it always
    doubles Nx).  B1 and B2 once a resampling step, no other kernel."""
    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import smc_samplers as ssp

    class LGfixed(kalman.LinearGauss):
        default_params = {"sigmaY": 0.5, "rho": 0.9, "sigmaX": 1.0,
                          "sigma0": None}

    true = kalman.LinearGauss(rho=0.8, sigmaX=1.0, sigmaY=0.5)
    _, y = true.simulate(torch.Generator(device=dev).manual_seed(0), 15)
    fk = ssp.SMC2(ssm_cls=LGfixed,
                  prior=dists.StructDist({"rho": dists.Uniform(a=-0.99,
                                                               b=0.99)}),
                  data=y, init_Nx=32, len_chain=3, ar_to_increase_Nx=1.5)
    pf = SMC(fk=fk, N=512, seed=3)
    next(pf)
    torch.cuda.synchronize()
    before = _launches()

    def rest():
        for _ in pf:
            pass

    _, syncs = _count_syncs(rest)
    flags = [bool(f) for f in pf.summaries.rs_flags]
    n_rs = sum(flags)
    assert n_rs > 0 and len(fk.exchanges) == sum(flags[1:-1])
    assert syncs == (len(flags) - 1) + sum(flags[1:-1])
    after = _launches()
    for k in ops.KERNELS:
        want = n_rs if k in ("systematic_z", "repeat_by_z") else 0
        assert after[k] - before[k] == want, k
    assert torch.isfinite(pf.logLt)


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """The bootstrap filter at 2^14 saved at t = 20 and loaded into a new
    SMC (another seed) runs on bit for bit; a CUDA generator's state does
    not load into a CPU run."""
    ssm = kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    _, y = ssm.simulate(torch.Generator(device=dev).manual_seed(0), 50)
    fk = ssms.Bootstrap(ssm=ssm, data=y)
    ref = SMC(fk=fk, N=2 ** 14, seed=7, store_history=4)
    for _ in ref:
        pass
    pf1 = SMC(fk=fk, N=2 ** 14, seed=7, store_history=4)
    for _ in range(20):
        next(pf1)
    path = tmp_path / "ckpt.pt"
    pf1.save_state(path)
    pf2 = SMC(fk=fk, N=2 ** 14, seed=99, store_history=4)
    pf2.load_state(path)
    for _ in pf2:
        pass
    assert float(pf2.logLt) == float(ref.logLt)
    assert torch.equal(pf2.X, ref.X)
    assert all(torch.equal(a, b) for a, b in zip(pf2.hist.X, ref.hist.X))
    fk_cpu = ssms.Bootstrap(ssm=ssm, data=y.cpu())
    with pytest.raises(ValueError, match="generator"):
        SMC(fk=fk_cpu, N=2 ** 14, store_history=4).load_state(path)


def test_repeat_kernel_serves_bool_rows(dev):
    """B2 serving a bool (N0, 103) leaf (1-byte elements, 103-byte rows)
    beside float columns, at binary SMC's waste-free shape (N0 = 30,000,
    M = 100), exact against its plain version."""
    rng = np.random.default_rng(14)
    N0, M = 30000, 100
    gamma = torch.from_numpy(rng.uniform(size=(N0, 103)) < 0.3).to(dev)
    cols = [gamma, torch.randn(N0, device=dev), torch.randn(N0, device=dev)]
    z = torch.from_numpy(np.cumsum(rng.multinomial(
        M, rng.dirichlet(np.ones(N0)))).astype(np.int32)).to(dev)
    before = _launches()["repeat_by_z"]
    served, _ = ops.repeat_cols(z, M, cols)
    assert _launches()["repeat_by_z"] == before + 1
    plain, _ = ops.repeat_cols_plain(z, M, cols)
    torch.cuda.synchronize()
    assert served[0].dtype == torch.bool and served[0].shape == (M, 103)
    for a, b in zip(served, plain):
        assert torch.equal(a, b)


def test_binary_sampler_on_the_card(dev):
    """Binary adaptive tempering on the card: numpy data placed there, the
    bool state served by B2, B1 and B2 the only kernels, done's read the
    only host sync a step, the inclusion probabilities within 0.1 of
    enumeration, and chol_and_friends equal to the CPU's within 1e-4."""
    from particles_tpu_torch import binary_smc as bs
    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import smc_samplers as ssp

    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 6)).astype(np.float32)
    y = (X @ np.array([1.5, -1.0, 0, 0, 0.8, 0], np.float32)
         + 0.5 * rng.normal(size=40)).astype(np.float32)
    prior = dists.StructDist({"gamma": dists.IID(bs.Bernoulli(0.5), 6)})
    model = bs.BayesianVS(data=(X, y), prior=prior)
    assert model.xtx.device.type == "cuda"
    gammas, lp = model.complete_enum()
    exact = (gammas.double() * torch.softmax(lp.double(), 0)[:, None]).sum(0)
    move = ssp.MCMCSequenceWF(mcmc=bs.BinaryMetropolis(), len_chain=20)
    pf = SMC(fk=ssp.AdaptiveTempering(model=model, len_chain=20, move=move),
             N=100, seed=1)
    next(pf)
    torch.cuda.synchronize()
    before = _launches()

    def rest():
        for _ in pf:
            pass

    _, syncs = _count_syncs(rest)
    n_rs = int(pf.summaries.rs_flags.sum())
    assert syncs == pf.t and n_rs == pf.t - 1
    after = _launches()
    for k in ops.KERNELS:
        want = n_rs if k in ("systematic_z", "repeat_by_z") else 0
        assert after[k] - before[k] == want, k
    assert pf.X.theta["gamma"].dtype == torch.bool
    W = pf.wgts.W.double()
    est = (W[:, None] * pf.X.theta["gamma"].double()).sum(0)
    assert float((est - exact).abs().max()) < 0.1
    g = pf.X.theta["gamma"]
    card = bs.chol_and_friends(g, model.xtx, model.xty, model.iv2)
    cpu = bs.chol_and_friends(g.cpu(), model.xtx.cpu(), model.xty.cpu(),
                              model.iv2.cpu())
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_nested_sampling_on_the_card(dev):
    """Vanilla NS: a chunk of contractions with synchronising operations
    made errors, then a whole run within 1.5 of the exact evidence; NS-SMC:
    done's read the one host sync a level, B1 and B2 once a level."""
    import scipy.stats as st

    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import nested
    from particles_tpu_torch import smc_samplers as ssp

    class GaussianMean(ssp.StaticModel):
        def logpyt(self, theta, t):
            return dists.Normal(loc=theta["mu"]).logpdf(self.data[t])

    T = 20
    y = np.random.default_rng(1).normal(loc=1.0, size=T).astype(np.float32)
    exact = st.multivariate_normal(np.zeros(T), np.eye(T) + 1.0).logpdf(y)
    model = GaussianMean(data=y, prior=dists.StructDist(
        {"mu": dists.Normal()}))
    ns = nested.Nested_RWmoves(model=model, N=50, nsteps=3, seed=0)
    ns.setup()
    lZ = torch.full((), -torch.inf, device=dev)
    draws = ns.draws(ns.gen, 25)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lZ, pll, _, _ = ns._chunk(ns.arr, ns.lprior, ns.llik, lZ, 0, 25,
                                  draws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(lZ) and bool((pll[1:] >= pll[:-1]).all())
    ns = nested.Nested_RWmoves(model=model, N=200, nsteps=5, seed=1)
    ns.run()
    assert abs(ns.lZhats[-1] - exact) < 1.5
    pf = SMC(fk=nested.NestedSamplingSMC(model=model, len_chain=16,
                                         ESSrmin=0.3), N=256, seed=2)
    next(pf)
    torch.cuda.synchronize()
    before = _launches()

    def rest():
        for _ in pf:
            pass

    _, syncs = _count_syncs(rest)
    assert syncs == pf.t and float(pf.X.shared["lt"]) == np.inf
    after = _launches()
    for k in ops.KERNELS:
        want = pf.t - 1 if k in ("systematic_z", "repeat_by_z") else 0
        assert after[k] - before[k] == want, k
    assert abs(float(pf.X.shared["log_evid"]) - exact) < 1.0


def _card_ring_inputs():
    rng = np.random.default_rng(5)
    N = 2 ** 16
    k = rng.integers(0, 256, N)
    k[-1] += 1
    # observations of LinearGauss(rho=0.9, sigmaX=1, sigmaY=0.2)
    x = np.empty(50)
    x[0] = rng.normal() / np.sqrt(1 - 0.81)
    for t in range(1, 50):
        x[t] = 0.9 * x[t - 1] + rng.normal()
    y = (x + 0.2 * rng.normal(size=50)).astype(np.float32)
    return {"x": rng.normal(size=N).astype(np.float32),
            "w": (k * 2.0 ** -24).astype(np.float32),   # exact sums
            "su": np.sort(rng.random(N)).astype(np.float32),
            "u": np.float32(0.37), "y": y, "N_run": 2 ** 16}


def _card_ring_checks(inp, ranks, D):
    """The joined rings against the single-device serves of the same
    arrays (exact: every sum is exact), the runs against Kalman, and
    each ring kernel launched on every rank."""
    from particles_tpu_torch import convert, kalman, ops

    x, w = torch.from_numpy(inp["x"]), torch.from_numpy(inp["w"])
    N = x.shape[0]
    cs = torch.cumsum(w, 0)
    z = (torch.floor(N * cs / cs[-1] - torch.tensor(inp["u"])).to(
        torch.int32) + 1).clamp_(0, N)
    z[-1:].fill_(N)
    (want,), A = ops.repeat_cols_plain(ops.running_max(z), N, [x],
                                       want_anc=True)
    got = convert.join_slices([r["systematic"][0] for r in ranks])
    got_A = convert.join_slices([r["systematic"][1] for r in ranks])
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got_A, A.numpy())
    A_merge = torch.searchsorted(cs / cs[-1], torch.from_numpy(inp["su"]))
    np.testing.assert_array_equal(
        convert.join_slices([r["merge"][1] for r in ranks]),
        A_merge.clamp(max=N - 1).numpy())
    kf = kalman.Kalman(ssm=kalman.LinearGauss(rho=0.9, sigmaX=1.0,
                                              sigmaY=0.2),
                       data=torch.from_numpy(inp["y"]).double())
    for scheme, run in ranks[0]["runs"].items():
        assert abs(run["logLt"] - float(kf.logLt)) < 0.5, scheme
        for r in ranks:
            la = r["runs"][scheme]["launches"]
            assert la["repeat_by_z"] == D * run["rs"] > 0, (scheme, la)
            assert la["running_max"] > 0, (scheme, la)
            assert (la["merge_rank_counts"] > 0) == (
                scheme == "multinomial"), (scheme, la)


def test_rings_on_gloo_ranks_sharing_the_card(dev):
    """Two gloo ranks on card 0 (the collectives through the host): the
    rings equal the single-device serves, B2, B5 and B6 launch."""
    import torch_dist_ranks as ranks
    from particles_tpu_torch.parallel import launch

    inp = _card_ring_inputs()
    out = launch.spawn(ranks.card_rings, 2, args=(inp,), backend="gloo",
                       device="cuda", timeout=300)
    _card_ring_checks(inp, out, 2)


def test_rings_on_nccl_one_rank_a_card(dev):
    import torch_dist_ranks as ranks
    from particles_tpu_torch.parallel import launch

    inp = _card_ring_inputs()
    D = torch.cuda.device_count()
    out = launch.spawn(ranks.card_rings, D, args=(inp,), backend="nccl",
                       device="cuda", timeout=300)
    _card_ring_checks(inp, out, D)
