"""The port's C++ host helpers (``particles_tpu_torch.native``) against the
JAX package's (``particles_tpu.native``), and the port's ``ssp_counts``
through them.

The two packages build their own copies of the same source with g++, so
each helper is held to the JAX package's bit for bit on the same numpy
inputs: the shapes of ``tests/test_native.py``, N = 1, M != N,
unnormalised weights, uniforms tied exactly to the CDF's values, and the
Hilbert index at the largest ``nbits`` of each d.  Below
``_SSP_BLOCKED_MIN`` the port's ``resampling.ssp_counts`` goes through the
helper and equals its plain version ``_ssp_counts_sequential`` on the same
uniforms; a compiler that fails raises, with no fallback.
"""

import importlib

import numpy as np
import pytest
import torch

import particles_tpu_torch.resampling as trs
from particles_tpu import native as jnative
from particles_tpu_torch import _build, hilbert, native


def _seq_cs(W):
    """The helpers' normalised CDF: a left-to-right total, then each
    ``W[j] / total`` added in order."""
    total = 0.0
    for w in W:
        total += w
    return np.cumsum(np.asarray(W) / total), total


def _inverse_cdf_case(name):
    rng = np.random.default_rng(10)
    if name == "test_native":
        W = rng.dirichlet(np.ones(200))
        su = np.sort(rng.uniform(size=150))
    elif name == "N=1":
        W, su = np.array([0.7]), np.sort(rng.uniform(size=5))
    elif name == "unnormalised M>N":
        W = rng.gamma(0.5, 3.0, 300) * 1e3
        su = np.sort(rng.uniform(size=700))
    else:   # every third value of the CDF itself, among uniforms
        W = rng.dirichlet(np.full(64, 0.5))
        su = np.sort(np.concatenate([_seq_cs(W)[0][::3],
                                     rng.uniform(size=20)]))
    return su, W


@pytest.mark.parametrize("name", ["test_native", "N=1", "unnormalised M>N",
                                  "su tied to cs"])
def test_inverse_cdf_matches_the_jax_package(name):
    su, W = _inverse_cdf_case(name)
    got = native.inverse_cdf(su, W)
    assert got.dtype == np.int32 and got.shape == su.shape
    np.testing.assert_array_equal(got, jnative.inverse_cdf(su, W))
    # the port's torch function on W normalised by the same total (the
    # smallest j with cs_j >= su_m, ties to the left, at most N - 1)
    want = trs.inverse_cdf(torch.from_numpy(su),
                           torch.from_numpy(W / _seq_cs(W)[1]))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("N,M,u,kind", [
    (300, 300, 0.417, "dirichlet"), (300, 123, 0.417, "dirichlet"),
    (1, 1, 0.3, "dirichlet"), (1, 5, 0.9, "dirichlet"),
    (500, 500, 0.0, "unnormalised"), (400, 1000, 0.61, "unnormalised")])
def test_systematic_counts_match_the_jax_package(N, M, u, kind):
    rng = np.random.default_rng(N + M)
    W = (rng.dirichlet(np.full(N, 0.3)) if kind == "dirichlet"
         else rng.gamma(0.5, 2.0, N) * 1e4)
    got = native.systematic_counts(W, M, u)
    assert got.dtype == np.int32 and int(got.sum()) == M
    np.testing.assert_array_equal(got, jnative.systematic_counts(W, M, u))
    # the float64 formula, rounded as written (no fused multiply-add)
    z = np.clip(np.floor(M * _seq_cs(W)[0] - u).astype(np.int64) + 1, 0, M)
    z[-1] = M
    np.testing.assert_array_equal(got, np.diff(z, prepend=0))


_SSP_CASES = [(128, 128, 0.5, s) for s in range(4)] + [
    (1, 1, 1.0, 0), (1, 3, 1.0, 0), (2, 2, 0.3, 0), (300, 120, 0.3, 0),
    (300, 777, 0.3, 0), (1000, 1000, -1.0, 0), (8191, 8191, 0.3, 0)]


@pytest.mark.parametrize("N,M,alpha,seed", _SSP_CASES)
def test_ssp_counts_match_the_jax_package(N, M, alpha, seed):
    """``alpha < 0``: unnormalised weights (Gamma(0.5) times 1e3)."""
    rng = np.random.default_rng(100 * N + seed)
    W = (rng.gamma(0.5, 1.0, N) * 1e3 if alpha < 0
         else rng.dirichlet(np.full(N, alpha)))
    u = rng.uniform(size=N - 1)
    got = native.ssp_counts(W, M, u)
    assert got.dtype == np.int32 and int(got.sum()) == M
    np.testing.assert_array_equal(got, jnative.ssp_counts(W, M, u))
    np.testing.assert_array_equal(
        got, trs._ssp_counts_sequential(list(W), M, list(u)))
    MW = M * W / W.sum()
    assert np.all(got >= np.floor(MW) - 1e-9) and np.all(got <= MW + 1)


@pytest.mark.parametrize("N,d,nbits", [
    (500, 2, 4), (200, 3, 3), (300, 1, 32), (300, 2, 31), (300, 3, 20),
    (300, 4, 15)])
def test_hilbert_index_matches_the_jax_package(N, d, nbits):
    """The shapes of ``tests/test_native.py``, and each d at its largest
    ``nbits`` (d nbits <= 62, coordinates uint32)."""
    rng = np.random.default_rng(d * nbits)
    coords = rng.integers(0, 2 ** nbits, size=(N, d),
                          dtype=np.uint64).astype(np.uint32)
    got = native.hilbert_index(coords, nbits)
    assert got.dtype == np.uint64 and got.shape == (N,)
    np.testing.assert_array_equal(got, jnative.hilbert_index(coords, nbits))
    keys = hilbert.hilbert_index(torch.from_numpy(coords.astype(np.int64)),
                                 nbits)
    np.testing.assert_array_equal(got, keys.numpy().astype(np.uint64))


def test_helpers_take_cpu_tensors():
    W = torch.tensor([0.1, 0.5, 0.4], dtype=torch.float32)
    u = torch.tensor([0.3, 0.8], dtype=torch.float64)
    np.testing.assert_array_equal(
        native.ssp_counts(W, 3, u),
        native.ssp_counts(W.numpy().astype(np.float64), 3, u.numpy()))
    coords = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    np.testing.assert_array_equal(native.hilbert_index(coords, 2),
                                  native.hilbert_index(coords.numpy(), 2))


@pytest.mark.parametrize("call", ["ssp u short", "hilbert nbits",
                                  "hilbert d nbits", "inverse_cdf empty"])
def test_bad_shapes_raise_before_the_call(call):
    with pytest.raises(ValueError):
        if call == "ssp u short":
            native.ssp_counts(np.full(4, 0.25), 4, np.zeros(2))
        elif call == "hilbert nbits":
            native.hilbert_index(np.zeros((3, 1), np.uint32), 33)
        elif call == "hilbert d nbits":
            native.hilbert_index(np.zeros((3, 3), np.uint32), 21)
        else:
            native.inverse_cdf(np.zeros(3), np.zeros(0))


def _gen_pair(seed):
    gen = torch.Generator().manual_seed(seed)
    twin = torch.Generator()
    twin.set_state(gen.get_state())
    return gen, twin


@pytest.mark.parametrize("N,M", [(1, 1), (2, 2), (77, 77), (2048, 2048),
                                 (8191, 8191), (300, 120)])
def test_ssp_counts_below_the_tree_go_through_the_helper(N, M, monkeypatch):
    """Equal to the plain version on the same uniforms (drawn from a twin
    of the generator), through ``native.ssp_counts``, and the generator
    left where N - 1 float64 uniforms leave it."""
    W = torch.from_numpy(np.random.default_rng(N).dirichlet(
        np.full(N, 0.3)).astype(np.float32))
    gen, twin = _gen_pair(N)
    calls = []

    def counted(*args):
        calls.append(args[1])
        return native_ssp(*args)

    native_ssp = native.ssp_counts
    monkeypatch.setattr(native, "ssp_counts", counted)
    got = trs.ssp_counts(gen, W, M)
    assert calls == [M]
    u = torch.rand(N - 1, generator=twin, dtype=torch.float64)
    want = trs._ssp_counts_sequential(W.double().tolist(), M, u.tolist())
    assert got.dtype == torch.int32 and got.device == W.device
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(gen.get_state(), twin.get_state())


def test_ssp_counts_at_the_threshold_pair_by_the_tree(monkeypatch):
    N = trs._SSP_BLOCKED_MIN
    W = torch.from_numpy(np.random.default_rng(5).dirichlet(
        np.full(N, 0.3)).astype(np.float32))
    gen, twin = _gen_pair(5)

    def refuse(*args):
        raise AssertionError("the helper was called at N = 8192")

    monkeypatch.setattr(native, "ssp_counts", refuse)
    assert torch.equal(trs.ssp_counts(gen, W),
                       trs._ssp_counts_blocked(twin, W, N))


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/g++"])
def test_a_failed_build_raises_and_nothing_falls_back(cxx, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(_build, "CXX", cxx)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    W = np.full(8, 0.125)
    with pytest.raises(RuntimeError, match="g\\+\\+|false"):
        native.ssp_counts(W, 8, np.zeros(7))
    with pytest.raises(RuntimeError):
        trs.ssp_counts(torch.Generator().manual_seed(0),
                       torch.from_numpy(W.astype(np.float32)))
    assert not list(tmp_path.glob("*.so"))
    assert native.AVAILABLE == (cxx == "false")


def test_import_builds_nothing(monkeypatch):
    def refuse(src):
        raise AssertionError(f"built {src} at import")

    monkeypatch.setattr(_build, "build_host", refuse)
    importlib.reload(native)
    assert native._lib is None and native.AVAILABLE in (True, False)
