"""The port's point sets (``particles_tpu_torch.rqmc``) and Hilbert curve
(``particles_tpu_torch.hilbert``) against the JAX package.

Every deterministic function is held bit for bit: the direction numbers,
the unscrambled points, the three scrambles and the first-coordinate
sorted set fed the JAX package's own random words (``jax.random.bits`` of
the key splits ``rqmc.sobol`` makes), the Hilbert indices of integer
points, and the Hilbert order of float points.  The randomised sets
drawn from a ``torch.Generator`` are held by their laws (one point per
dyadic cell; distinct draws for distinct seeds), as are ``halton`` and
``latin``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particles_tpu import hilbert as jhilbert
from particles_tpu import rqmc as jrqmc
from particles_tpu_torch import hilbert, rqmc


def _jax_words(key, d, scramble):
    """The words ``rqmc.sobol`` draws from ``key`` (its key splits), as the
    port's int64 tensors."""
    if scramble == "lms_shift":
        k_lms, k_shift = jax.random.split(key)
        words = {"rb": jax.random.bits(k_lms, (d, 32), dtype=jnp.uint32),
                 "shift": jax.random.bits(k_shift, (d,), dtype=jnp.uint32)}
    elif scramble == "shift":
        words = {"shift": jax.random.bits(key, (d,), dtype=jnp.uint32)}
    else:
        words = {"seeds": jax.random.bits(key, (d,), dtype=jnp.uint32)}
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64))
            for k, v in words.items()}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("d", [1, 2, 7, 300])
def test_direction_numbers_match_jax(d):
    ours = rqmc._direction_numbers(d)
    assert ours.dtype == np.uint32
    np.testing.assert_array_equal(ours, jrqmc._direction_numbers(d))


def test_direction_table_is_capped():
    with pytest.raises(ValueError, match="21201"):
        rqmc._direction_numbers(30000)


@pytest.mark.parametrize("d", [1, 5, 64])
def test_sobol_unscrambled_matches_jax(d):
    ours = rqmc.sobol_unscrambled(256, d, device="cpu").numpy()
    theirs = np.asarray(jrqmc.sobol_unscrambled(256, d))
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("N,d,seed", [(1024, 5, 0), (1000, 3, 1),
                                      (64, 30, 2)])
@pytest.mark.parametrize("scramble", ["lms_shift", "shift", "owen"])
def test_scrambled_sobol_matches_jax(scramble, N, d, seed):
    """The same words give the same float32 points, bit for bit, and
    ``start``/``count`` the same rows."""
    key = jax.random.key(seed)
    words = _jax_words(key, d, scramble)
    ours = rqmc.sobol_from_words(words, N, d, scramble).numpy()
    theirs = np.asarray(jrqmc.sobol(key, N, d, scramble=scramble))
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    part = rqmc.sobol_from_words(words, N, d, scramble, start=300,
                                 count=57).numpy()
    np.testing.assert_array_equal(part, np.asarray(jrqmc.sobol(
        key, N, d, scramble=scramble, start=300, count=57)))


@pytest.mark.parametrize("N,d,seed", [(1, 2, 4), (256, 5, 2), (4096, 2, 1),
                                      (2 ** 14, 3, 3)])
def test_sobol_sorted0_matches_jax(N, d, seed):
    key = jax.random.key(seed)
    words = _jax_words(key, d, "lms_shift")
    np.testing.assert_array_equal(
        rqmc.sobol_sorted0_from_words(words, N, d).numpy(),
        np.asarray(jrqmc.sobol_sorted0(key, N, d)))
    start, count = N // 2, max(N // 4, 1)
    np.testing.assert_array_equal(
        rqmc.sobol_sorted0_from_words(words, N, d, start=start,
                                      count=count).numpy(),
        np.asarray(jrqmc.sobol_sorted0(key, N, d, start=start, count=count)))


def test_sobol_sorted0_is_the_sorted_sobol_set():
    """From one generator state both give the same set; sorted0 is it
    sorted by the first column."""
    u = rqmc.sobol(_gen(5), 2048, 3)
    s = rqmc.sobol_sorted0(_gen(5), 2048, 3)
    assert torch.equal(s, u[torch.argsort(u[:, 0])])


def test_sobol_sorted0_needs_a_power_of_two():
    with pytest.raises(ValueError):
        rqmc.sobol_sorted0(_gen(0), 1000, 2)


def test_unknown_scramble_raises():
    with pytest.raises(ValueError):
        rqmc.sobol(_gen(0), 64, 2, scramble="owen_nested")
    with pytest.raises(ValueError):
        rqmc.sobol_from_words({"shift": torch.zeros(2, dtype=torch.int64)},
                              64, 2, "lms_shift")


@pytest.mark.parametrize("scramble", ["lms_shift", "shift", "owen"])
def test_scrambles_keep_the_net(scramble):
    """At N = 2^m every column has one point in each dyadic cell, and the
    first two columns one in each cell of the 32 x 32 grid; two seeds give
    two sets, and one seed the same set."""
    N, d = 1024, 8
    for seed in (0, 1):
        u = rqmc.sobol(_gen(seed), N, d, scramble=scramble).numpy()
        assert u.shape == (N, d) and u.dtype == np.float32
        assert (u > 0).all() and (u < 1).all()
        for j in range(d):
            cells = np.sort(np.floor(N * u[:, j]).astype(int))
            np.testing.assert_array_equal(cells, np.arange(N))
        c = np.floor(32 * u[:, :2]).astype(int)
        cnt = np.zeros((32, 32), int)
        np.add.at(cnt, (c[:, 0], c[:, 1]), 1)
        assert cnt.min() == cnt.max() == 1
    a = rqmc.sobol(_gen(1), 64, 3, scramble=scramble)
    assert torch.equal(a, rqmc.sobol(_gen(1), 64, 3, scramble=scramble))
    assert float((a - rqmc.sobol(_gen(2), 64, 3,
                                 scramble=scramble)).abs().max()) > 0.01


def test_lms_and_owen_lower_variance_than_shift():
    """On a smooth product integrand, unbiased, and LMS and Owen well below
    the plain digital shift (as the JAX tests hold)."""
    def f(u):
        return float(torch.prod(1.0 + 0.5 * (u - 0.5), 1).mean())

    sds = {}
    for scramble in ("lms_shift", "owen", "shift"):
        vals = [f(rqmc.sobol(_gen(i), 256, 4, scramble=scramble))
                for i in range(150)]
        assert abs(np.mean(vals) - 1.0) < 1e-3, scramble
        sds[scramble] = np.std(vals)
    assert sds["lms_shift"] < 0.5 * sds["shift"], sds
    assert sds["owen"] < 0.5 * sds["shift"], sds


def test_halton_and_latin():
    h = rqmc.halton(_gen(0), 1000, 4).numpy()
    assert h.shape == (1000, 4) and (h > 0).all() and (h < 1).all()
    np.testing.assert_allclose(h.mean(0), 0.5, atol=0.05)
    # the first column's first 512 points are the multiples of 1/512,
    # shifted modulo 1: every cell of width 1/512 holds one of them
    cells = np.floor(512 * h[:, 0]).astype(int)
    assert np.unique(cells).size == 512
    lat = rqmc.latin(_gen(1), 500, 3).numpy()
    assert lat.shape == (500, 3)
    for j in range(3):
        counts = np.bincount((lat[:, j] * 500).astype(int), minlength=500)
        assert counts.max() == 1


def test_safe_generate_squeezes_into_the_open_cube():
    class Grid:
        def __init__(self, d):
            self.d = d

        def random(self, n):
            return np.linspace(0.0, 1.0, n)[:, None].repeat(self.d, 1)

    u = rqmc.safe_generate(11, 2, Grid)
    assert u.shape == (11, 2) and (u > 0).all() and (u < 1).all()


# ---------------------------------------------------------------------------
# Hilbert curve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 3, 4])
def test_hilbert_index_matches_jax(d):
    """On random integers, at the sort width and the full width: the int64
    key is the JAX package's (hi << 32) | lo."""
    rng = np.random.default_rng(d)
    for nbits in (1, hilbert.sort_nbits(4096, d), max(1, min(62 // d, 16))):
        c = rng.integers(0, 2 ** nbits, size=(2000, d))
        hi, lo = jhilbert.hilbert_index(jnp.asarray(c, jnp.uint32), nbits)
        want = ((np.asarray(hi).astype(np.int64) << 32)
                | np.asarray(lo).astype(np.int64))
        got = hilbert.hilbert_index(torch.from_numpy(c), nbits)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_hilbert_to_int_matches_jax():
    for p in ([3, 5], [1, 2, 3], [7, 0, 1, 2], [65535, 1]):
        assert hilbert.Hilbert_to_int(p) == jhilbert.Hilbert_to_int(p)


def test_hilbert_curve_takes_unit_steps():
    """The 8 x 8 curve visits every cell once, each step to a neighbour."""
    xs, ys = np.meshgrid(np.arange(8), np.arange(8))
    coords = np.stack([xs.ravel(), ys.ravel()], 1)
    key = hilbert.hilbert_index(torch.from_numpy(coords), 3).numpy()
    assert np.unique(key).size == 64
    path = coords[np.argsort(key)]
    assert (np.abs(np.diff(path, axis=0)).sum(1) == 1).all()


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_hilbert_sort_matches_jax(d):
    """The same permutation as the JAX package, exactly.  The cells come
    from float32 means, sds and logistic values that the two packages
    round alike only to a few ulps, so the test first checks that no point
    lies within 16 ulps (of 1, times the 2^nbits cells) of a cell boundary,
    in float64: there the rounding cannot move a point to another cell,
    and the orders must agree."""
    x = np.random.default_rng(10 + d).normal(size=(1000, d)).astype(
        np.float32)
    if d > 1:
        nbits = hilbert.sort_nbits(1000, d)
        x64 = x.astype(np.float64)
        g = (1 << nbits) / (1 + np.exp(-(x64 - x64.mean(0)) / x64.std(0)))
        assert np.abs(g - np.round(g)).min() > 2.0 ** (nbits - 20)
    ours = hilbert.hilbert_sort(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jhilbert.hilbert_sort(jnp.asarray(x)))
    np.testing.assert_array_equal(ours, theirs)
    cols = (torch.from_numpy(x), torch.arange(1000))
    for c, want in zip(hilbert.hilbert_sort_with(torch.from_numpy(x), cols),
                       cols):
        assert torch.equal(c, want[torch.from_numpy(ours)])


def test_standardise_uses_the_population_sd():
    """``jnp.std`` divides by N: so does the port (``correction=0``)."""
    x = torch.tensor([[0.0, 1.0], [1.0, 3.0], [2.0, 8.0], [3.0, 9.0]])
    ours = hilbert._standardise_and_integerise(x, 4).numpy()
    theirs = np.asarray(jhilbert._standardise_and_integerise(
        jnp.asarray(x.numpy()), 4))
    np.testing.assert_array_equal(ours, theirs)
    assert float(hilbert.invlogit(torch.tensor(0.0))) == 0.5
