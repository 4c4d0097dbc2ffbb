"""Kernels B3-B6 of the port (``particles_tpu_torch.ops``) against the JAX
package's Pallas kernels, and their wrappers' contracts.

Here, with no card, each wrapper runs its plain PyTorch version, so these
tests hold the plain versions against ``particles_tpu``'s kernels run in
interpret mode, on the same numpy inputs; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the CUDA kernels against the plain versions on the
card.  Tolerances: B4, B5 and B6 exact (float compares and integer maxima);
B3 within 1e-6 of JAX's cs, since the sum S is taken in another order, and
both within N * 2^-31 + 1e-6 of the float64 CDF.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import particles_tpu.ops.cummax_kernel as ck
import particles_tpu.ops.merge_rank_kernel as mk
import particles_tpu.ops.repeat_kernel as rk
import particles_tpu.ops.z_kernel as zk
import particles_tpu.resampling as jrs
from particles_tpu_torch import ops, tracing


@pytest.fixture
def interpret(monkeypatch):
    """Route the JAX package's Pallas kernels through interpret mode."""
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    for mod in (zk, rk, mk, ck):
        monkeypatch.setattr(mod, "_on_tpu", lambda: True)
    yield
    zk._cs_pallas.clear_cache()
    rk._repeat_pallas_n.clear_cache()
    mk._merge_pallas.clear_cache()
    ck._running_max_pallas.clear_cache()


def _cdf64(W):
    W64 = np.asarray(W, np.float64)
    return np.cumsum(W64 / W64.sum())


def _f32_cdf(W):
    cs = np.cumsum(np.asarray(W, np.float64))
    return (cs / cs[-1]).astype(np.float32)


# ---------------------------------------------------------------------------
# B3: monotone normalised cumsum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("conc", [1.0, 8.0])
def test_normalised_cumsum_plain_matches_jax_kernel(interpret, conc):
    N = 8192
    lw = conc * np.random.default_rng(int(conc)).normal(size=N)
    W = np.array(jrs.exp_and_normalise(jnp.asarray(lw, jnp.float32)))
    cj = np.array(zk.normalised_cumsum_exact(jnp.asarray(W)))
    ct = ops.normalised_cumsum_exact(torch.from_numpy(W))
    assert ct.dtype == torch.float32 and ct.shape == (N,)
    ct = ct.numpy()
    assert np.abs(ct - cj).max() < 1e-6
    cs64 = _cdf64(W)
    for cs in (ct, cj):
        assert (np.diff(cs) >= 0).all()
        assert np.abs(cs - cs64).max() < N * 2**-31 + 1e-6
        assert abs(cs[-1] - 1.0) < 1e-6


@pytest.mark.parametrize("N", [1, 7, 1000, 5000])
def test_normalised_cumsum_any_size(N):
    """No alignment gate: any N >= 1, degenerate weights included."""
    rng = np.random.default_rng(N)
    for W in (rng.dirichlet(np.full(N, 0.05)).astype(np.float32),
              np.eye(N, dtype=np.float32)[N // 2]):
        cs = ops.normalised_cumsum_exact(torch.from_numpy(W)).numpy()
        assert (np.diff(cs) >= 0).all() and abs(cs[-1] - 1.0) < 1e-6
        assert np.abs(cs - _cdf64(W)).max() < N * 2**-31 + 1e-6


# ---------------------------------------------------------------------------
# B5: sorted-merge rank count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,degenerate", [(1024, False), (4096, False),
                                          (1024, True)])
def test_merge_rank_plain_matches_jax_kernel(interpret, N, degenerate):
    """Exact, with value ties (a tied uniform counts) and one-hot
    weights (cs a step from 0 to 1)."""
    rng = np.random.default_rng(N + degenerate)
    W = (np.eye(N)[N // 3] if degenerate
         else rng.dirichlet(np.full(N, 0.3)))
    cs = _f32_cdf(W)
    su = np.sort(rng.uniform(size=N)).astype(np.float32)
    tied = np.sort(np.concatenate(
        [cs[: N // 2], rng.uniform(size=N - N // 2)])).astype(np.float32)
    for s in (su, tied):
        zj = np.asarray(mk.merge_rank_counts(jnp.asarray(s), jnp.asarray(cs),
                                             N))
        zt = ops.merge_rank_counts(torch.from_numpy(s), torch.from_numpy(cs),
                                   N)
        assert zt.dtype == torch.int32
        np.testing.assert_array_equal(zt.numpy(), zj)


@pytest.mark.parametrize("L,M", [(500, 500), (2000, 2000), (2000, 1500),
                                 (1, 1)])
def test_merge_rank_any_lengths(L, M):
    """Any lengths of su and cs, clipped to [0, M]."""
    rng = np.random.default_rng(L + M)
    cs = _f32_cdf(rng.dirichlet(np.ones(1000)))
    su = np.sort(rng.uniform(size=L)).astype(np.float32)
    z = ops.merge_rank_counts(torch.from_numpy(su), torch.from_numpy(cs), M)
    ref = np.minimum(np.searchsorted(su, cs, side="right"), M)
    np.testing.assert_array_equal(z.numpy(), ref)


def test_merge_rank_stays_monotone_on_a_dip():
    """A float cumsum can leave su one ulp out of order; z stays
    nondecreasing, since a binary search is monotone in its key."""
    rng = np.random.default_rng(5)
    N = 4096
    cs = _f32_cdf(rng.dirichlet(np.ones(N)))
    su = np.sort(rng.uniform(size=N)).astype(np.float32)
    for k in rng.integers(1, N - 1, size=40):
        su[k] = np.nextafter(su[k - 1], np.float32(0))   # su[k] < su[k-1]
    assert (np.diff(su) < 0).any()
    z = ops.merge_rank_counts(torch.from_numpy(su), torch.from_numpy(cs), N)
    assert (np.diff(z.numpy()) >= 0).all()


# ---------------------------------------------------------------------------
# B4: resampling move by the inverse CDF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "N,seed,ties,extreme",
    [(2048, 1, 0.3, None), (4096, 3, 0.0, 0), (4096, 4, 0.0, -1),
     (2559, 6, 0.0, None)])
def test_repeat_su_plain_matches_jax_kernel(interpret, N, seed, ties,
                                            extreme):
    """Served values and ancestors equal exactly, ties and degenerate
    weights included (cases of tests/test_resampling.py::TestRepeatKernels::
    test_su_mode_fused_inverse_cdf)."""
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.ones(N) * 0.25)
    if extreme is not None:
        W = np.zeros(N)
        W[extreme] = 1.0
    cs = np.maximum.accumulate(_f32_cdf(W))
    cs[-1] = 1.0
    su = rng.uniform(size=N)
    if ties:
        k = int(N * ties)
        su[:k] = cs[rng.integers(0, N - 1, size=k)]
    su = np.sort(np.clip(su, 0.0, np.float32(1.0) - np.float32(2**-24))
                 ).astype(np.float32)
    cols = [rng.normal(size=N).astype(np.float32) for _ in range(2)]
    plan = rk.make_repeat_plan_su(jnp.asarray(su), jnp.asarray(cs), N)
    served_j, Aj = rk.repeat_with_plan_cols(
        plan, [jnp.asarray(c) for c in cols], want_anc=True)
    served_t, At = ops.repeat_cols_su(
        torch.from_numpy(su), torch.from_numpy(cs), N,
        [torch.from_numpy(c) for c in cols], want_anc=True)
    assert At.dtype == torch.int64
    np.testing.assert_array_equal(At.numpy(), np.asarray(Aj))
    for yj, yt in zip(served_j, served_t, strict=True):
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(
        ops.ancestors_by_su(torch.from_numpy(su), torch.from_numpy(cs)).numpy(),
        np.asarray(Aj))


@pytest.mark.parametrize("N,k", [(1000, 1), (1000, 4), (1, 3)])
def test_repeat_su_unsorted_queries_any_dtype(N, k):
    """Unsorted queries, M = k N, payloads the TPU route could not take
    (f64, int32 >= 2^24, int8, (N, 3) f16): exact against searchsorted."""
    rng = np.random.default_rng(N + k)
    cs = _f32_cdf(rng.dirichlet(np.full(N, 0.5)))
    cs[-1] = 1.0
    M = k * N
    u = rng.uniform(size=M).astype(np.float32)
    A_ref = np.minimum(np.searchsorted(cs, u, side="left"), N - 1)
    cols = [rng.normal(size=N),
            rng.integers(2**24, 2**31 - 1, size=N).astype(np.int32),
            rng.integers(-128, 127, size=N).astype(np.int8),
            rng.normal(size=(N, 3)).astype(np.float16)]
    served, A = ops.repeat_cols_su(torch.from_numpy(u), torch.from_numpy(cs),
                                   M, [torch.from_numpy(c) for c in cols],
                                   want_anc=True)
    np.testing.assert_array_equal(A.numpy(), A_ref)
    for c, y in zip(cols, served, strict=True):
        assert y.dtype == torch.from_numpy(c).dtype
        np.testing.assert_array_equal(y.numpy(), c[A_ref])


def test_repeat_su_wrapper_contract():
    cs = torch.full((8,), 1.0)
    u = torch.full((8,), 0.5)
    with pytest.raises(TypeError):
        ops.repeat_cols_su(u.double(), cs, 8, [])
    with pytest.raises(ValueError, match="M=4"):
        ops.repeat_cols_su(u, cs, 4, [])
    with pytest.raises(ValueError):
        ops.repeat_cols_su(u, cs, 8, [torch.zeros(7)])
    with pytest.raises(ValueError, match="no kernel"):
        ops.repeat_cols_su(u.to("meta"), cs.to("meta"), 8, [])
    with pytest.raises(TypeError):
        ops.merge_rank_counts(u, cs.to(torch.int32), 8)
    with pytest.raises(ValueError, match="no kernel"):
        ops.merge_rank_counts(u.to("meta"), cs.to("meta"), 8)
    n = tracing.counts()
    ops.repeat_cols_su(u, cs, 8, [torch.zeros(8)], want_anc=True)
    ops.merge_rank_counts(u, cs, 8)
    ops.normalised_cumsum_exact(cs)
    ops.running_max(torch.zeros(8, dtype=torch.int32))
    assert tracing.counts() == n


# ---------------------------------------------------------------------------
# B6: inclusive running max
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [8192, 16384])
def test_running_max_plain_matches_jax_kernel(interpret, N):
    """Exact, negative values included."""
    rng = np.random.default_rng(N)
    z = rng.integers(-2**31, 2**31 - 1, size=N, dtype=np.int64)
    z = z.astype(np.int32)
    yj = np.asarray(ck.running_max(jnp.asarray(z)))
    yt = ops.running_max(torch.from_numpy(z))
    assert yt.dtype == torch.int32
    np.testing.assert_array_equal(yt.numpy(), yj)


@pytest.mark.parametrize("N", [1, 7, 1000, 1025])
def test_running_max_any_size(N):
    rng = np.random.default_rng(N)
    z = rng.integers(-50, 50, size=N).astype(np.int32)
    np.testing.assert_array_equal(
        ops.running_max(torch.from_numpy(z)).numpy(),
        np.maximum.accumulate(z))
    with pytest.raises(TypeError):
        ops.running_max(torch.from_numpy(z).long())
    with pytest.raises(ValueError, match="no kernel"):
        ops.running_max(torch.from_numpy(z).to("meta"))
