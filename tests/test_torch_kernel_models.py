"""Numpy models of how the port's CUDA kernels B1 to B6 cut up their
work, held against the kernels' plain PyTorch versions on the CPU.

A CUDA kernel cannot run here, so these models repeat, step by step, the
index arithmetic of ``particles_tpu_torch/csrc/repeat_kernel.cu``
(``warp_split``, ``k_merge_serve``), ``csrc/z_kernel.cu`` and
``csrc/cummax_kernel.cu`` on ``csrc/coop_chunks.cuh`` (``coop_shape``,
``k_fixed_point`` with its two epilogues, ``k_running_max``),
``csrc/merge_rank_kernel.cu`` (``warp_upper_bound``, ``window_counts``,
``k_merge_rank``) and B4's guide table in ``csrc/repeat_kernel.cu``
(``guide_scale``, ``guide_bucket``, ``k_guide_build``, ``k_serve_guide``),
over tile, grid and table sizes far smaller and larger than the card's,
so that an off-by-one in a split, a tile edge, a prefix or a bucket shows
up where no card is.  Nothing in the package uses them.

B2 is held exactly: the merge path gives ``A_j = #{k: z_k <= j}`` with
every j served once.  B3 is held bit for bit wherever the model's f32 sum
S equals the plain version's (everything after S is exact integer or
IEEE-rounded f32 arithmetic), and always to B3's tolerance: nondecreasing,
``|cs[-1] - 1| < 1e-6``, within ``N 2^-31 + 1e-6`` of float64.  B1, the
same passes with the z epilogue, is held likewise: equal to the plain
version where S is the same float, else within 1 of it and of float64,
nondecreasing with ``z[-1] == M``; and within 1 of the JAX package's
kernel.  B6 is held exactly against ``np.maximum.accumulate``.  B5 is held
exactly on sorted uniforms, and on uniforms that dip to its other two
contracts: z nondecreasing, every output written once, each a binary
search's answer.  B4 is held exactly against ``np.searchsorted(cs, su,
side="left")`` clipped to N - 1, on any ``cs`` range and any scale.
"""

import numpy as np
import pytest
import torch

from particles_tpu_torch import ops

# -- B2: the merge path -------------------------------------------------------


def _warp_split(c, d, lo, hi, lanes):
    """``warp_split``: the first a in [lo, hi) with ``a + c[a] >= d`` (hi if
    none), ``lanes`` evenly spaced probes a round."""
    while hi > lo:
        n = hi - lo
        step = -(-n // lanes)
        below = []
        for lane in range(lanes):
            pr = lo + min(step * (lane + 1), n) - 1
            below.append(pr + c[pr] < d)
        nb = sum(below)
        assert below == [True] * nb + [False] * (lanes - nb)   # a prefix
        if nb == lanes:
            return hi
        hi = lo + min(step * (nb + 1), n) - 1
        if nb > 0:
            lo += step * nb
    return lo


def _merge_path(z, M, threads, items, lanes, extra_blocks=0):
    """``k_merge_serve``'s ancestors: blocks of ``threads * items`` items of
    the merge of z with 0..M-1, each thread merging ``items`` of them."""
    N = len(z)
    c = np.clip(z.astype(np.int64), 0, M)
    tile = threads * items
    total = N + M
    A = np.full(M, -1, dtype=np.int64)
    for blk in range(-(-total // tile) + extra_blocks):
        d0 = min(blk * tile, total)
        d1 = min(d0 + tile, total)
        a0 = _warp_split(c, d0, max(0, d0 - M), min(d0, N), lanes)
        a1 = _warp_split(c, d1, max(0, d1 - M), min(d1, N), lanes)
        b0 = d0 - a0
        na, nb = a1 - a0, (d1 - a1) - b0
        assert 0 <= na <= tile and 0 <= nb <= tile
        sz = c[a0:a1]
        sa = np.full(nb, -1, dtype=np.int64)
        n = na + nb
        for t in range(threads):
            dl = min(t * items, n)
            lo, hi = max(0, dl - nb), min(dl, na)
            while lo < hi:
                mid = (lo + hi) // 2
                if sz[mid] <= b0 + (dl - 1 - mid):
                    lo = mid + 1
                else:
                    hi = mid
            a, b = lo, dl - lo
            for _ in range(dl, min(dl + items, n)):
                if a < na and (b >= nb or sz[a] <= b0 + b):
                    a += 1
                else:
                    assert sa[b] == -1
                    sa[b] = a0 + a
                    b += 1
        assert (sa >= 0).all()
        assert (A[b0:b0 + nb] == -1).all()        # every j served once
        A[b0:b0 + nb] = np.minimum(sa, N - 1)
    assert (A >= 0).all()
    return A


def _counts(kind, tile, rng):
    """Offspring counts (N,) and M for one adversarial case."""
    N = 3 * tile + 5                       # not a multiple of the tile
    if kind in ("all_on_first", "all_on_middle", "all_on_last"):
        k = {"all_on_first": 0, "all_on_middle": N // 2,
             "all_on_last": N - 1}[kind]
        counts = np.zeros(N, dtype=np.int64)
        counts[k] = N
        return counts, N
    if kind == "all_ones":
        return np.ones(N, dtype=np.int64), N
    if kind == "zero_runs_longer_than_a_block":
        N = 9 * tile + 3
        counts = np.zeros(N, dtype=np.int64)
        burst = np.arange(0, N, 3 * tile + 2)    # 3 tiles of zeros between
        counts[burst] = rng.multinomial(N, np.full(len(burst),
                                                   1.0 / len(burst)))
        return counts, N
    if kind == "N1_M1":
        return np.array([1]), 1
    if kind == "N1_M5":
        return np.array([5]), 5
    M = {"M1": 1, "M_half_plus_1": N // 2 + 1, "M_4N": 4 * N,
         "unaligned": 2 * tile + 7}[kind]
    return rng.multinomial(M, rng.dirichlet(np.full(N, 0.3))), M


B2_KINDS = ["all_on_first", "all_on_middle", "all_on_last", "all_ones",
            "zero_runs_longer_than_a_block", "N1_M1", "N1_M5", "M1",
            "M_half_plus_1", "M_4N", "unaligned"]
# (threads, items, lanes): the card's is (256, 16, 32)
B2_GEOMETRIES = [(1, 1, 2), (4, 2, 4), (8, 3, 32), (256, 16, 32)]


@pytest.mark.parametrize("extra_blocks", [0, 2])
@pytest.mark.parametrize("geometry", B2_GEOMETRIES)
@pytest.mark.parametrize("kind", B2_KINDS)
def test_merge_path_model_matches_plain(kind, geometry, extra_blocks):
    threads, items, lanes = geometry
    rng = np.random.default_rng(len(kind) + threads)
    counts, M = _counts(kind, threads * items, rng)
    assert counts.sum() == M
    z = np.cumsum(counts).astype(np.int32)
    A = _merge_path(z, M, threads, items, lanes, extra_blocks)
    x = torch.from_numpy(rng.standard_normal((len(z), 2)))
    (y,), A_plain = ops.repeat_cols_plain(torch.from_numpy(z), M, [x],
                                          want_anc=True)
    np.testing.assert_array_equal(A, A_plain.numpy())
    assert torch.equal(x[torch.from_numpy(A)], y)


@pytest.mark.parametrize("lanes", [2, 3, 32])
def test_warp_split_model_is_the_merge_split(lanes):
    """Every diagonal d of the merge, on z with values below 0 and above M
    (the kernel clamps them): the split equals the count of z entries in
    the first d items of the merge."""
    rng = np.random.default_rng(lanes)
    for N, M in [(1, 1), (5, 40), (40, 5), (97, 97)]:
        z = np.sort(rng.integers(-3, M + 4, N))
        c = np.clip(z, 0, M)
        pos = np.arange(N) + c                  # where z_k sits in the merge
        for d in range(N + M + 1):
            got = _warp_split(c, d, max(0, d - M), min(d, N), lanes)
            assert got == int((pos < d).sum()), (N, M, d)


# -- B3: one cooperative launch ---------------------------------------------


def _cs_geometry(N, max_grid, tile, cache_tiles):
    """``pt_normalised_cumsum``'s launch: (blocks, chunk, cached)."""
    per = -(-N // max_grid)
    chunk = -(-per // tile) * tile
    return -(-N // chunk), chunk, chunk <= cache_tiles * tile


def _chunked_csq(W, max_grid, tile, cache_tiles, threads):
    """``k_fixed_point``'s passes: per-block partials of W (float64) and of
    q (int64), S in a fixed order, each block's exclusive prefix, and the
    scan of each tile, ``tile // threads`` consecutive elements a thread.
    Returns the inclusive csq (int64), Q and S, for either epilogue."""
    N = len(W)
    G, chunk, _ = _cs_geometry(N, max_grid, tile, cache_tiles)
    assert G <= max_grid and chunk % tile == 0
    assert (G - 1) * chunk < N <= G * chunk     # every block owns >= 1
    items = tile // threads
    blocks = [W[b * chunk:(b + 1) * chunk] for b in range(G)]
    part_s = [float(np.sum(w.astype(np.float64))) for w in blocks]
    S = np.float32(sum(part_s))
    scale = np.float32(2.0 ** 30) / max(S, np.float32(1e-37))
    part_q = [int(np.rint(w * scale).astype(np.int64).sum()) for w in blocks]
    csq = np.empty(N, dtype=np.int64)
    for b, w in enumerate(blocks):
        carry = sum(part_q[:b])
        for base in range(0, len(w), tile):
            q = np.zeros(tile, dtype=np.int64)
            part = w[base:base + tile]
            q[:len(part)] = np.rint(part * scale)
            q = q.reshape(threads, items)
            mine = q.sum(axis=1)
            ex = np.cumsum(mine) - mine              # the block scan
            run = carry + ex[:, None] + np.cumsum(q, axis=1)
            carry += int(mine.sum())
            csq[b * chunk + base:b * chunk + base + len(part)] = \
                run.reshape(-1)[:len(part)]
        assert carry == sum(part_q[:b + 1])
    return csq, sum(part_q), S


def _cs_epilogue(csq, Q):
    """``CsOut``: cs = f32(csq) * (1 / max(Q, 1)), every stage in f32."""
    inv = np.float32(1.0) / max(np.float32(Q), np.float32(1.0))
    return (csq.astype(np.float32) * inv).astype(np.float32)


def _z_epilogue(csq, Q, u, M):
    """``ZOut``: z = clip(floor(f32(csq) * (M / max(Q, 1)) - u) + 1, 0, M),
    z[-1] = M, every stage rounded to f32 (no fused multiply-subtract)."""
    minv = np.float32(M) / max(np.float32(Q), np.float32(1.0))
    f = (csq.astype(np.float32) * minv).astype(np.float32) - np.float32(u)
    z = np.clip(np.floor(f.astype(np.float32)).astype(np.int64) + 1, 0, M)
    z[-1] = M
    return z


def _chunked_cs(W, max_grid, tile, cache_tiles, threads):
    """B3's kernel: the chunked passes, then the cs epilogue."""
    csq, Q, S = _chunked_csq(W, max_grid, tile, cache_tiles, threads)
    return _cs_epilogue(csq, Q), S


def _weights(kind, geometry, rng):
    max_grid, tile, cache_tiles = geometry
    N = {"N1": 1, "tile_plus_1": tile + 1,
         "two_tile_chunks": max_grid * tile + 1,
         "beyond_the_cache": max_grid * cache_tiles * tile + 1}.get(kind, 777)
    if kind.startswith("one_hot"):
        W = np.zeros(N, dtype=np.float32)
        W[{"one_hot_first": 0, "one_hot_middle": N // 2,
           "one_hot_last": N - 1}[kind]] = 1.0
        return W
    if kind == "mostly_zero":
        W = np.zeros(N, dtype=np.float32)
        W[rng.choice(N, 5, replace=False)] = rng.random(5)
        return W
    g = rng.standard_gamma(0.05 if kind == "dirichlet0.05" else 1.0, N)
    W = (g / g.sum()).astype(np.float32)
    if kind == "S_near_the_overflow_edge":
        # the least S for which 2^30 / S stays a finite f32 is ~3.2e-30
        W = (W * np.float32(4e-30)).astype(np.float32)
    return W


B3_KINDS = ["N1", "tile_plus_1", "two_tile_chunks", "beyond_the_cache",
            "one_hot_first", "one_hot_middle", "one_hot_last", "mostly_zero",
            "S_near_the_overflow_edge", "dirichlet0.05"]
# (max_grid, tile, cache_tiles, threads): the card's is (264, 4096, 6, 512);
# a max_grid of 264 with small tiles is a grid larger than the data
B3_GEOMETRIES = [(1, 4, 1, 2), (3, 8, 2, 4), (5, 32, 3, 8),
                 (264, 64, 2, 8), (2, 4096, 1, 512)]


@pytest.mark.parametrize("geometry", B3_GEOMETRIES)
@pytest.mark.parametrize("kind", B3_KINDS)
def test_chunked_cumsum_model_matches_plain(kind, geometry):
    rng = np.random.default_rng(len(kind) + geometry[1])
    W = _weights(kind, geometry[:3], rng)
    N = len(W)
    cs, S = _chunked_cs(W, *geometry)
    Wt = torch.from_numpy(W)
    plain = ops.normalised_cumsum_plain(Wt).numpy()
    if S == Wt.sum(dtype=torch.float64).to(torch.float32).item():
        np.testing.assert_array_equal(cs, plain)
    W64 = W.astype(np.float64)
    oracle = np.cumsum(W64) / W64.sum()
    tol = N * 2.0 ** -31 + 1e-6
    assert np.all(np.diff(cs) >= 0)
    assert abs(float(cs[-1]) - 1.0) < 1e-6
    assert np.abs(cs - plain).max() < tol
    assert np.abs(cs - oracle).max() < tol


@pytest.mark.parametrize("N", [1, 4096, 4097, 264 * 4096, 264 * 4096 + 1,
                               264 * 6 * 4096, 264 * 6 * 4096 + 1, 2 ** 24])
def test_cumsum_geometry_covers_the_data(N):
    """The card's geometry (264 blocks of at most 6 cached tiles of 4096):
    at most max_grid blocks, each owning whole tiles and at least one
    element; chunks stay cached up to 264 * 6 * 4096 elements."""
    G, chunk, cached = _cs_geometry(N, 264, 4096, 6)
    assert 1 <= G <= 264 and chunk % 4096 == 0
    assert (G - 1) * chunk < N <= G * chunk
    assert cached == (N <= 264 * 6 * 4096)


# -- B1: the same passes, the z epilogue --------------------------------------


def _oracle_z(W, u, M):
    W64 = W.astype(np.float64)
    cs = np.cumsum(W64) / W64.sum()
    z = np.clip(np.floor(M * cs - np.float64(u)) + 1, 0, M).astype(np.int64)
    z[-1] = M
    return z


def _check_z(z, plain, W, u, M, same_S):
    """B1's contract: nondecreasing, in [0, M], ``z[-1] == M``; equal to
    the plain version where S is the same float, else within 1 of it;
    within 1 of the float64 oracle."""
    if same_S:
        np.testing.assert_array_equal(z, plain)
    assert np.abs(z - plain).max() <= 1
    assert np.abs(z - _oracle_z(W, u, M)).max() <= 1
    assert np.all(np.diff(z) >= 0)
    assert z[-1] == M and z.min() >= 0 and z.max() <= M


@pytest.mark.parametrize("M_of", ["N", "501", "4N"])
@pytest.mark.parametrize("geometry", B3_GEOMETRIES)
@pytest.mark.parametrize("kind", B3_KINDS)
def test_chunked_z_model_matches_plain(kind, geometry, M_of):
    rng = np.random.default_rng(len(kind) + geometry[1])
    W = _weights(kind, geometry[:3], rng)
    N = len(W)
    M = {"N": N, "501": 501, "4N": 4 * N}[M_of]
    csq, Q, S = _chunked_csq(W, *geometry)
    Wt = torch.from_numpy(W)
    same_S = S == Wt.sum(dtype=torch.float64).to(torch.float32).item()
    for u in (0.0, 0.37, 0.999):
        u32 = np.float32(u)
        z = _z_epilogue(csq, Q, u32, M)
        plain = ops.systematic_z_plain(Wt, float(u32), M).numpy()
        _check_z(z, plain.astype(np.int64), W, u32, M, same_S)


@pytest.fixture
def interpret(monkeypatch):
    """Route the JAX package's Pallas kernels through interpret mode (JAX
    is imported here, not at the top: the card's tests import this module
    where there is no JAX)."""
    from jax.experimental import pallas as pl

    import particles_tpu.ops.z_kernel as zk

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(zk, "_on_tpu", lambda: True)
    yield zk
    zk._z_pallas.clear_cache()


@pytest.mark.parametrize("geometry", [(264, 4096, 6, 512), (264, 64, 2, 8)])
@pytest.mark.parametrize("N", [8192, 65536])
def test_chunked_z_model_matches_jax_kernel(interpret, N, geometry):
    """The chunked model of B1 against the JAX package's kernel: |dz| <= 1
    (S is a float sum taken in another order)."""
    import jax.numpy as jnp

    zk = interpret
    rng = np.random.default_rng(N + geometry[1])
    W = rng.dirichlet(np.full(N, 0.3)).astype(np.float32)
    csq, Q, _ = _chunked_csq(W, *geometry)
    for u in (0.0, 0.37, 0.999):
        u32 = np.float32(u)
        zj = np.asarray(zk.systematic_z_fused(jnp.asarray(W), jnp.float32(u32),
                                              N)).astype(np.int64)
        z = _z_epilogue(csq, Q, u32, N)
        assert np.abs(z - zj).max() <= 1
        assert np.all(np.diff(z) >= 0) and z[-1] == zj[-1] == N


# -- B6: one grid barrier, a max-scan --------------------------------------

INT_MIN = np.iinfo(np.int32).min


def _chunked_cummax(z, max_grid, tile, cache_tiles, threads):
    """``k_running_max``: each block's maximum, the maximum of the blocks
    before it, then the max-scan of each tile, ``tile // threads``
    consecutive elements a thread, INT_MIN past the chunk's end."""
    N = len(z)
    G, chunk, _ = _cs_geometry(N, max_grid, tile, cache_tiles)
    items = tile // threads
    blocks = [z[b * chunk:(b + 1) * chunk] for b in range(G)]
    part = [int(w.max()) for w in blocks]
    y = np.empty(N, dtype=np.int32)
    for b, w in enumerate(blocks):
        carry = max(part[:b], default=INT_MIN)
        for base in range(0, len(w), tile):
            seg = w[base:base + tile]
            v = np.full(tile, INT_MIN, dtype=np.int64)
            v[:len(seg)] = seg
            v = v.reshape(threads, items)
            mine = v.max(axis=1)
            ex = np.concatenate([[INT_MIN], np.maximum.accumulate(mine)[:-1]])
            run = np.maximum(np.maximum(carry, ex)[:, None],
                             np.maximum.accumulate(v, axis=1))
            carry = max(carry, int(mine.max()))
            y[b * chunk + base:b * chunk + base + len(seg)] = \
                run.reshape(-1)[:len(seg)]
        assert carry == max(part[:b + 1])
    return y


def _ints(kind, size, geometry, rng):
    """B6's inputs: (N,) int32 of one kind at one of B3's chunk-edge
    sizes."""
    max_grid, tile, cache_tiles = geometry
    N = {"N1": 1, "tile_plus_1": tile + 1,
         "two_tile_chunks": max_grid * tile + 1,
         "beyond_the_cache": max_grid * cache_tiles * tile + 1}[size]
    if kind == "all_int_min":
        return np.full(N, INT_MIN, dtype=np.int32)
    if kind == "whole_range":
        return rng.integers(INT_MIN, 2 ** 31, N, dtype=np.int64).astype(
            np.int32)
    if kind == "descending":
        return np.linspace(2 ** 31 - 1, INT_MIN, N).astype(np.int64).clip(
            INT_MIN, 2 ** 31 - 1).astype(np.int32)
    # spikes, each above the last, on both sides of every chunk boundary
    _, chunk, _ = _cs_geometry(N, max_grid, tile, cache_tiles)
    z = rng.integers(-1000, 0, N, dtype=np.int64).astype(np.int32)
    edges = sorted({i for c in range(chunk, N, chunk) for i in (c - 1, c)}
                   | {0, N - 1})
    z[edges] = np.arange(1, len(edges) + 1, dtype=np.int32) * 7
    return z


B6_KINDS = ["all_int_min", "whole_range", "descending",
            "spikes_at_chunk_edges"]
B6_SIZES = ["N1", "tile_plus_1", "two_tile_chunks", "beyond_the_cache"]


@pytest.mark.parametrize("geometry", B3_GEOMETRIES)
@pytest.mark.parametrize("size", B6_SIZES)
@pytest.mark.parametrize("kind", B6_KINDS)
def test_chunked_cummax_model_is_exact(kind, size, geometry):
    rng = np.random.default_rng(len(kind) + len(size) + geometry[1])
    z = _ints(kind, size, geometry[:3], rng)
    y = _chunked_cummax(z, *geometry)
    np.testing.assert_array_equal(y, np.maximum.accumulate(z))
    np.testing.assert_array_equal(
        y, ops.running_max_plain(torch.from_numpy(z)).numpy())


# -- B5: block windows of su ------------------------------------------------


def _warp_upper_bound(su, c, lanes):
    """``warp_upper_bound``: #{j: su_j <= c} by rounds of ``lanes`` evenly
    spaced probes, each round keeping the gap before the first probe above
    c."""
    lo, hi = 0, len(su)
    while hi > lo:
        n = hi - lo
        step = -(-n // lanes)
        above = [not su[lo + min(step * (lane + 1), n) - 1] <= c
                 for lane in range(lanes)]
        if not any(above):
            return hi
        f = above.index(True)
        hi = lo + min(step * (f + 1), n) - 1
        lo += step * f
    return lo


def _window_counts(win, keys):
    """``window_counts``: #{j: win_j <= key} for every key, by the
    branch-free binary search (powers of two, largest first)."""
    w = len(win)
    cnt = np.zeros(len(keys), dtype=np.int64)
    step = 1 << (w.bit_length() - 1) if w else 0
    while step:
        p = cnt + step
        ok = p <= w
        ok[ok] = win[p[ok] - 1] <= keys[ok]
        cnt[ok] = p[ok]
        step >>= 1
    return cnt


def _rank_blocks(su, cs, M, threads, items, window, lanes):
    """``k_merge_rank``: z, and how many blocks searched su in place (a
    window over ``window``) and the furthest window end."""
    N = len(cs)
    tile = threads * items
    z = np.full(N, -1, dtype=np.int64)
    written = np.zeros(N, dtype=np.int64)
    in_place, last_end = 0, 0
    for i0 in range(0, N, tile):
        i1 = min(i0 + tile, N)
        lo = _warp_upper_bound(su, cs[i0], lanes)
        hi = _warp_upper_bound(su, cs[i1 - 1], lanes)
        assert 0 <= lo <= hi <= len(su)
        w = hi - lo
        win = su[lo:hi]
        last_end = max(last_end, hi)
        keys = cs[i0:i1]
        if w > window:       # in place: the tile's end keys take the ends
            in_place += 1
            got = np.where(keys == cs[i0], 0, np.where(
                keys == cs[i1 - 1], w, _window_counts(win, keys)))
        else:
            # each thread's first key in the whole window, its other keys
            # between that count and the next thread's first key's
            heads = keys[::items]
            first = np.concatenate([
                _window_counts(win, heads),
                np.full(threads - len(heads), w, dtype=np.int64)])
            got = np.empty(len(keys), dtype=np.int64)
            for t in range(len(heads)):
                r = first[t]
                top = first[t + 1] if t + 1 < threads else w
                assert r <= top <= w                # inside the window
                mine = keys[t * items:(t + 1) * items]
                got[t * items] = r
                got[t * items + 1:(t + 1) * items] = r + _window_counts(
                    win[r:top], mine[1:])
        written[i0:i1] += 1
        z[i0:i1] = np.minimum(lo + got, M)
    assert (written == 1).all()
    return z, in_place, last_end


def _rank_case(kind, tile, window, rng):
    """(su, cs, M) of one case, ``tile`` and ``window`` the geometry's."""
    N = max(3 * tile + 5, 65 + tile // 2)   # not a multiple of the tile
    L, M = N, N
    cs = np.cumsum(rng.dirichlet(np.ones(N))).astype(np.float32)
    if kind in ("all_on_first", "all_on_middle", "all_on_last"):
        k = {"all_on_first": 0, "all_on_middle": N // 2,
             "all_on_last": N - 1}[kind]
        cs = (np.arange(N) >= k).astype(np.float32)
        assert kind == "all_on_first" or k % tile   # the step inside a tile
    elif kind == "dirichlet0.05":
        cs = np.cumsum(rng.dirichlet(np.full(N, 0.05))).astype(np.float32)
    L = {"L_2N_plus_1": 2 * N + 1, "L_half_plus_1": N // 2 + 1,
         "L1": 1}.get(kind, L)
    M = {"M_below_L": N // 3, "M0": 0}.get(kind, M)
    su = np.sort(rng.uniform(size=L)).astype(np.float32)
    if kind == "ties":
        su = np.sort(np.concatenate([su[: L // 2],
                                     rng.choice(cs, L - L // 2)]))
    elif kind == "residual_tail":                 # draws, then 2.0
        su[L // 3:] = 2.0
    elif kind in ("window_at_cap", "window_past_cap"):
        # block 1's window, su in (cs[tile], cs[2 tile - 1]], holds exactly
        # `window` uniforms, or one more
        a, b = cs[tile], cs[2 * tile - 1]
        k = window + (kind == "window_past_cap")
        mid = np.linspace(a, b, k + 1)[1:].astype(np.float32)
        rest = rng.uniform(size=L).astype(np.float32)
        su = np.sort(np.concatenate([mid, rest[(rest <= a) | (rest > b)]]))
        assert ((su > a) & (su <= b)).sum() == k
    return su.astype(np.float32), cs, M


B5_KINDS = ["dirichlet1", "dirichlet0.05", "L_2N_plus_1", "L_half_plus_1",
            "L1", "ties", "M_below_L", "M0", "all_on_first", "all_on_middle",
            "all_on_last", "residual_tail", "window_at_cap",
            "window_past_cap"]
# (threads, items, window, lanes): the card's is (256, 8, 8192, 32)
B5_GEOMETRIES = [(2, 1, 1, 2), (2, 3, 4, 3), (4, 2, 16, 4), (8, 4, 64, 32),
                 (256, 8, 8192, 32)]


@pytest.mark.parametrize("geometry", B5_GEOMETRIES)
@pytest.mark.parametrize("kind", B5_KINDS)
def test_merge_rank_model_matches_plain(kind, geometry):
    threads, items, window, lanes = geometry
    tile = threads * items
    rng = np.random.default_rng(len(kind) + tile)
    su, cs, M = _rank_case(kind, tile, window, rng)
    z, in_place, last_end = _rank_blocks(su, cs, M, *geometry)
    ref = np.minimum(np.searchsorted(su, cs, side="right"), M)
    np.testing.assert_array_equal(z, ref)
    plain = ops.merge_rank_counts_plain(torch.from_numpy(su),
                                        torch.from_numpy(cs), M)
    np.testing.assert_array_equal(z, plain.numpy())
    edges = np.searchsorted(su, cs, side="right")
    ends = np.minimum(np.arange(0, len(cs), tile) + tile, len(cs)) - 1
    sizes = edges[ends] - edges[::tile]          # each block's window
    assert in_place == int((sizes > window).sum())
    if kind in ("window_at_cap", "window_past_cap"):
        assert sizes[1] == window + (kind == "window_past_cap")
    if kind in ("all_on_middle", "all_on_last") and len(su) > window:
        assert in_place == 1                     # the block of the step
    if kind == "residual_tail":
        assert last_end <= len(su) // 3          # no window holds the tail


def _dipped(rng, L, every):
    """Sorted uniforms with every ``every``-th one an ulp below the one
    before it, as a float cumsum can leave them, and the dipped indices."""
    su = np.sort(rng.uniform(size=L)).astype(np.float32)
    k = np.arange(1, L, every)
    su[k] = np.nextafter(su[k - 1], np.float32(0))
    assert (np.diff(su) < 0).any()
    return su, k


def _dip_case(keys, tile, rng):
    """(su, cs): N dipped uniforms and N sorted keys: uniform, equal to
    dipped uniforms, or half and half."""
    N = max(3 * tile + 5, 61)
    su, dips = _dipped(rng, N, 7)
    uni = rng.uniform(size=N).astype(np.float32)
    on = rng.choice(su[dips], N)
    cs = np.sort({"uniform": uni, "on_the_dips": on,
                  "mixed": np.where(rng.random(N) < 0.5, uni, on)}[keys])
    return su, cs


B5_DIP_KEYS = ["uniform", "on_the_dips", "mixed"]


@pytest.mark.parametrize("geometry", B5_GEOMETRIES)
@pytest.mark.parametrize("keys", B5_DIP_KEYS)
def test_merge_rank_model_on_a_dip(keys, geometry):
    """On uniforms that dip by an ulp: z nondecreasing, every output
    written once (asserted in the model), and each z_i a binary search's
    answer, su[z_i - 1] <= cs_i < su[z_i] where those exist.  Keys equal
    to a dipped uniform are where a round's probes above the key are not a
    prefix of its lanes."""
    threads, items, window, lanes = geometry
    su, cs = _dip_case(keys, threads * items, np.random.default_rng(
        threads * items + len(keys)))
    N = len(cs)
    z, _, _ = _rank_blocks(su, cs, N, *geometry)
    assert (np.diff(z) >= 0).all()
    below = np.concatenate([[-np.inf], su])[z]          # su[z - 1]
    above = np.concatenate([su, [np.inf]])[z]           # su[z]
    assert (below <= cs).all() and (cs < above).all()


@pytest.mark.parametrize("lanes", [2, 3, 32])
def test_warp_upper_bound_model(lanes):
    """Every key between and on the values of sorted su (ties and runs of
    equal values included) gives searchsorted's answer; on a dipped su the
    answer is nondecreasing in the key and a binary search's."""
    rng = np.random.default_rng(lanes)
    for L in (1, 2, 31, 33, 100, 1025):
        su = np.sort(rng.integers(0, L // 3 + 2, L)).astype(np.float32)
        keys = np.arange(-1, L // 3 + 3, 0.5, dtype=np.float32)
        got = [_warp_upper_bound(su, c, lanes) for c in keys]
        np.testing.assert_array_equal(
            got, np.searchsorted(su, keys, side="right"))
        if L > 2:
            dip, k = _dipped(rng, L, 3)
            keys = np.sort(np.concatenate([dip[k], rng.uniform(size=L)]))
            got = np.array([_warp_upper_bound(dip, c, lanes) for c in keys])
            assert (np.diff(got) >= 0).all()
            below = np.concatenate([[-np.inf], dip])[got]
            above = np.concatenate([dip, [np.inf]])[got]
            assert (below <= keys).all() and (keys < above).all()


# -- B4: the guide table ------------------------------------------------------

_F32_MAX = np.float32(np.finfo(np.float32).max)


def _guide_scale(cs, K):
    """``guide_scale``: K / cs[N-1] in float32, or 0 (a constant bucket
    function) where that is not a positive finite float."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        s = np.float32(K) / np.float32(cs[-1])
    return s if 0 < s <= _F32_MAX else np.float32(0)


def _guide_bucket(x, s, K):
    """``guide_bucket``: clamp(floor(x s), 0, K - 1) of the float32 product,
    0 where the product is not positive (NaN included)."""
    with np.errstate(invalid="ignore", over="ignore"):
        v = np.asarray(x, dtype=np.float32) * np.float32(s)
    b = np.zeros(v.shape, dtype=np.int64)
    pos = v > 0
    b[pos] = np.minimum(np.floor(v[pos].astype(np.float64)), K - 1)
    return b


def _lower_bound(lo, hi, below):
    """Binary searches, vectorised: for each query the first p in [lo, hi)
    with ``below(p, queries)`` False (hi if none)."""
    lo, hi = lo.astype(np.int64), hi.astype(np.int64)
    while True:
        act = lo < hi
        if not act.any():
            return lo
        mid = (lo + hi) >> 1
        go = np.zeros(len(lo), dtype=bool)
        go[act] = below(mid[act], act)
        lo = np.where(act & go, mid + 1, lo)
        hi = np.where(act & ~go, mid, hi)


def _guide_threshold(b, s):
    """``guide_threshold``, vectorised: the least float32 t with RN(t s) >=
    b, from b / s by ulp steps (for b in [1, K - 1] and s > 0 that is the
    least t with f(t) >= b)."""
    s = np.float32(s)
    fb = np.asarray(b).astype(np.float32)
    with np.errstate(over="ignore"):
        t = fb / s
        down = t * s >= fb
        while True:                          # down while the next is >= b
            d = np.nextafter(t, np.float32(-np.inf))
            m = down & (d * s >= fb)
            if not m.any():
                break
            t[m] = d[m]
        up = ~down
        while up.any():                      # up until t s >= b
            t[up] = np.nextafter(t[up], np.float32(np.inf))
            up &= ~(t * s >= fb)
    return t


def _count_below(cs, t, R):
    """``count_below<R>``, vectorised: #{i: cs_i < t} by a branch-free
    search in radix R (the count grows by each power of R, largest first,
    by as many steps as the R - 1 probes above it find entries < t)."""
    N = len(cs)
    step = 1
    while step * R <= N:
        step *= R
    pos = np.zeros(len(t), dtype=np.int64)
    while step:
        c = np.zeros(len(t), dtype=np.int64)
        for j in range(1, R):
            p = pos + step * j
            ok = p <= N
            ok[ok] = cs[p[ok] - 1] < t[ok]
            c += ok
        pos += step * c
        step //= R
    return pos


def _guide_count(cs, b, s, K, R):
    """``guide_count<R>``: G[b] = #{i: f(cs_i) < b}, 0 for b = 0, N for b >=
    K or s = 0, else the count of cs below the bucket's threshold."""
    N = len(cs)
    b = np.asarray(b, dtype=np.int64)
    g = np.where(b == 0, 0, N).astype(np.int64)
    inner = (b >= 1) & (b < K) & (s != 0)
    g[inner] = _count_below(cs, _guide_threshold(b[inner], s), R)
    return g


def _guide_build(cs, K, s, lanes, R):
    """``k_guide_build``: entries (K, 4), {G[b], G[b+1], cs[G[b]],
    cs[G[b]+1]} (cs as float32, its indices clamped to N - 1).  Warp w of
    ``lanes`` lanes owns the buckets [(lanes - 1) w, (lanes - 1) (w + 1)):
    each lane counts G of its bucket in radix ``R``, and every lane but the
    last writes its entry with G[b + 1] from the next lane."""
    N = len(cs)
    per = lanes - 1
    b = np.arange(-(-K // per))[:, None] * per + np.arange(lanes)
    g = _guide_count(cs, b.reshape(-1), s, K, R).reshape(b.shape)
    keys = _guide_bucket(cs, s, K)               # G by its definition
    np.testing.assert_array_equal(
        g, np.searchsorted(keys, np.minimum(b, K), side="left"))
    g1 = g[:, 1:]                                # the next lane's
    b, g = b[:, :-1], g[:, :-1]
    ok = b < K
    g, g1 = g[ok], g1[ok]
    E = np.stack([g, g1, cs[np.minimum(g, N - 1)],
                  cs[np.minimum(g + 1, N - 1)]], axis=1).astype(np.float64)
    assert len(E) == K and (b[ok] == np.arange(K)).all()
    return E


def _guide_serve(su, cs, E, s, K):
    """``k_serve_guide``: from the entry of f(u), lo if the range is empty
    or cs[lo] >= u, lo + 1 if it holds one or cs[lo + 1] >= u, else the
    search of cs[lo + 2, hi); clipped to N - 1.  Also the ranges' sizes."""
    su = np.asarray(su, dtype=np.float32)
    e = E[_guide_bucket(su, s, K)]
    lo, hi = e[:, 0].astype(np.int64), e[:, 1].astype(np.int64)
    c0, c1 = e[:, 2].astype(np.float32), e[:, 3].astype(np.float32)
    first = (lo == hi) | ~(c0 < su)
    second = ~first & ((hi - lo == 1) | ~(c1 < su))
    rest = ~first & ~second
    A = np.where(first, lo, lo + 1)
    ur = su[rest]
    A[rest] = _lower_bound(lo[rest] + 2, hi[rest],
                           lambda mid, act: cs[mid] < ur[act])
    return np.minimum(A, len(cs) - 1), hi - lo


def _guide_ancestors(su, cs, K, lanes=32, R=4):
    """The two launches of ``pt_repeat_by_su``, warps of ``lanes`` lanes
    and counts in radix ``R`` (32 and 4 on the card): (A, ranges' sizes,
    E)."""
    s = _guide_scale(cs, K)
    E = _guide_build(cs, K, s, lanes, R)
    G = np.append(E[:, 0], E[-1, 1]).astype(np.int64)
    assert G[0] == 0 and G[K] == len(cs) and (np.diff(G) >= 0).all()
    assert (E[:-1, 1] == E[1:, 0]).all()         # hi of b is lo of b + 1
    A, width = _guide_serve(su, cs, E, s, K)
    return A, width, E


def _guide_case(kind, N, rng):
    """(su, cs) of one case: ``cs`` (N,) float32 nondecreasing."""
    def cdf(w):
        return np.cumsum(w / w.sum()).astype(np.float32)

    cs = cdf(rng.dirichlet(np.ones(N)))
    M = {"M1": 1, "M_half_plus_1": N // 2 + 1, "M_4N": 4 * N}.get(kind, N)
    su = rng.uniform(size=M).astype(np.float32)
    if kind == "dirichlet0.05":
        cs = cdf(rng.dirichlet(np.full(N, 0.05)))
    elif kind in ("all_on_first", "all_on_middle", "all_on_last"):
        w = np.zeros(N)
        w[{"all_on_first": 0, "all_on_middle": N // 2,
           "all_on_last": N - 1}[kind]] = 1.0
        cs = cdf(w)
    elif kind == "zero_runs":             # ties in cs
        w = rng.uniform(size=N) * (rng.uniform(size=N) < 0.2)
        w[N // 2] = 1.0
        cs = cdf(w)
    elif kind == "su_on_cs":              # queries equal to cs values
        su = rng.choice(cs, M)
    elif kind == "su_edges":              # 0, an ulp below the top, the
        edges = np.array([0.0, np.nextafter(cs[-1], np.float32(0)), cs[-1],
                          -0.5, -np.inf, 1.5, np.inf], dtype=np.float32)
        su = np.concatenate([edges, su])[:max(M, len(edges))]
    elif kind == "integer_cs":            # the JAX package's take_sorted
        cs = np.cumsum(rng.multinomial(N, np.full(N, 1.0 / N))).astype(
            np.float32)
        su = rng.permutation(N).astype(np.float32) + np.float32(0.5)
    elif kind == "cs_top_zero":           # cs[-1] = 0: f is constant
        cs = np.sort(-rng.uniform(size=N)).astype(np.float32)
        cs[-1] = 0.0
        su = rng.uniform(-1.0, 1.0, size=M).astype(np.float32)
    elif kind == "cs_negative":
        cs = np.sort(-1.0 - rng.uniform(size=N)).astype(np.float32)
        su = rng.uniform(-2.5, 0.5, size=M).astype(np.float32)
    elif kind == "cs_tiny":               # K / cs[-1] overflows: s = 0
        cs = (cs * np.float32(1e-38)).astype(np.float32)
        su = (su * np.float32(1e-38)).astype(np.float32)
    elif kind == "cs_huge":
        cs = (cs * np.float32(1e30)).astype(np.float32)
        su = (su * np.float32(1e30)).astype(np.float32)
    elif kind == "cs_top_inf":            # s = 0 and inf * 0 = NaN
        cs[-1] = np.inf
        su[:1] = np.inf
    return su.astype(np.float32), cs


B4_KINDS = ["dirichlet1", "dirichlet0.05", "all_on_first", "all_on_middle",
            "all_on_last", "zero_runs", "su_on_cs", "su_edges", "integer_cs",
            "cs_top_zero", "cs_negative", "cs_tiny", "cs_huge", "cs_top_inf",
            "M1", "M_half_plus_1", "M_4N"]
# N: one, seven, and one that is no power of two nor a multiple of a block
B4_SIZES = [1, 7, 4093]
# (K, lanes of a warp of the build, radix of its counts): the card's, and
# others
B4_GEOMETRIES = ["card", "K1", "K2N_lanes3_R2", "K_eighth_lanes2_R3"]


def _guide_geometry(which, N):
    K = {"card": ops.guide_buckets(N), "K1": 1,
         "K2N_lanes3_R2": 1 << N.bit_length(),
         "K_eighth_lanes2_R3": max(1, (1 << N.bit_length()) // 16)}[which]
    lanes, R = {"K2N_lanes3_R2": (3, 2),
                "K_eighth_lanes2_R3": (2, 3)}.get(which, (32, 4))
    return K, lanes, R


@pytest.mark.parametrize("geometry", B4_GEOMETRIES)
@pytest.mark.parametrize("N", B4_SIZES)
@pytest.mark.parametrize("kind", B4_KINDS)
def test_guide_model_matches_plain(kind, N, geometry):
    rng = np.random.default_rng(len(kind) * 31 + N)
    su, cs = _guide_case(kind, N, rng)
    K, lanes, R = _guide_geometry(geometry, N)
    A, width, _ = _guide_ancestors(su, cs, K, lanes, R)
    ref = np.minimum(np.searchsorted(cs, su, side="left"), N - 1)
    np.testing.assert_array_equal(A, ref)
    (y,), A_plain = ops.repeat_cols_su_plain(
        torch.from_numpy(su), torch.from_numpy(cs), len(su),
        [torch.arange(N)], want_anc=True)
    np.testing.assert_array_equal(A, A_plain.numpy())
    np.testing.assert_array_equal(y.numpy(), ref)
    if geometry == "card" and N > 1000:   # what the table is for
        if kind == "dirichlet1":
            assert width.mean() <= 2.0 * N / K
        elif kind.startswith("all_on"):
            assert (width == 0).mean() > 0.99


@pytest.mark.parametrize("kind", ["dirichlet1", "all_on_middle",
                                  "integer_cs", "su_on_cs"])
def test_guide_model_at_the_card_size(kind):
    """N = 2^20 - 513 and, on Dirichlet(1), M = 4N, at the card's K."""
    N = 2 ** 20 - 513
    su, cs = _guide_case(kind, N, np.random.default_rng(3))
    if kind == "dirichlet1":
        su = np.random.default_rng(4).uniform(size=4 * N).astype(np.float32)
    K = ops.guide_buckets(N)
    A, width, _ = _guide_ancestors(su, cs, K)
    np.testing.assert_array_equal(
        A, np.minimum(np.searchsorted(cs, su, side="left"), N - 1))
    if kind == "dirichlet1":
        assert width.mean() <= 2.0 * N / K


@pytest.mark.parametrize("K", [2, 1024, 2 ** 18, 2 ** 24])
def test_guide_threshold_model(K):
    """The threshold of every bucket b in [1, K - 1] is the least float t
    with f(t) >= b, at scales from tiny to huge: f(t) >= b and f of the
    float below t is < b."""
    rng = np.random.default_rng(K)
    b = np.unique(np.concatenate([[1, K - 1], rng.integers(1, K, 500)]))
    b = b[(b >= 1) & (b < K)]
    for top in (1.0, 3.0, 1e-30, 7e30, 0.1, np.float32(K) / 3):
        s = _guide_scale(np.array([top], dtype=np.float32), K)
        t = _guide_threshold(b, s)
        below = np.nextafter(t, np.float32(-np.inf))
        assert (_guide_bucket(t, s, K) >= b).all()
        assert (_guide_bucket(below, s, K) < b).all()


@pytest.mark.parametrize("R", [2, 3, 4, 8])
def test_count_below_model(R):
    """``count_below<R>`` on sorted cs with runs and ties, at every N up to
    a few powers of R, gives searchsorted's count of entries below t."""
    rng = np.random.default_rng(R)
    for N in (1, 2, 3, 4, 5, 15, 16, 17, 63, 64, 65, 1000):
        cs = np.sort(rng.integers(0, N // 2 + 2, N)).astype(np.float32)
        t = np.arange(-1, N // 2 + 3, 0.5).astype(np.float32)
        np.testing.assert_array_equal(_count_below(cs, t, R),
                                      np.searchsorted(cs, t, side="left"))


def test_guide_bucket_is_monotone_and_constant_on_a_bad_scale():
    """f is nondecreasing in x for every scale the card can store, and
    constant (0) for s = 0, on infinities and signed zeros too."""
    x = np.sort(np.concatenate([
        np.array([-np.inf, -1e30, -1.0, -0.0, 0.0, 1e-45, 1e-38, 0.5, 1.0,
                  1e30, np.inf], dtype=np.float32),
        np.random.default_rng(0).uniform(-2, 2, 1000).astype(np.float32)]))
    for K in (1, 2, 2 ** 18, 2 ** 24):
        for s in (np.float32(0), np.float32(1e-30), np.float32(1.0),
                  np.float32(K), np.float32(3e38)):
            b = _guide_bucket(x, s, K)
            assert (np.diff(b) >= 0).all() and b.min() >= 0
            assert b.max() <= K - 1
        assert (_guide_bucket(x, np.float32(0), K) == 0).all()
    for top in (0.0, -1.0, 1e-40, np.inf, np.nan):
        assert _guide_scale(np.array([top], dtype=np.float32), 1024) == 0


@pytest.mark.parametrize("N", [1, 2, 3, 7, 8, 9, 4093, 2 ** 20 - 513, 2 ** 20,
                               2 ** 20 + 1, 2 ** 31 - 1])
def test_guide_buckets_are_a_power_of_two_near_n(N):
    """K: a power of two in [1, 2^24] (every bucket index an exact
    float32), N / 2^GUIDE_SHIFT rounded up to one."""
    K = ops.guide_buckets(N)
    assert 1 <= K <= 2 ** 24 and K & (K - 1) == 0
    top = 1 << (N - 1).bit_length()        # the least power of two >= N
    assert K == min(max(top >> ops.GUIDE_SHIFT, 1), 2 ** 24)
