"""The port's kernels (``particles_tpu_torch.ops``) against the JAX
package's Pallas kernels, and the wrappers' contracts.

Here, with no card, a wrapper runs its plain PyTorch version, so these
tests hold the plain versions against ``particles_tpu``'s kernels run in
interpret mode (patched from the test side, as
``tests/test_resampling.py::TestRepeatKernels`` does).  The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import particles_tpu.ops.repeat_kernel as rk
import particles_tpu.ops.z_kernel as zk
from particles_tpu_torch import _build, ops, tracing


@pytest.fixture
def interpret(monkeypatch):
    """Route the JAX package's Pallas kernels through interpret mode."""
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(zk, "_on_tpu", lambda: True)
    monkeypatch.setattr(rk, "_on_tpu", lambda: True)
    yield
    zk._z_pallas.clear_cache()
    rk._repeat_pallas_n.clear_cache()


def _oracle_z(W, u, M):
    W64 = W.astype(np.float64)
    cs = np.cumsum(W64) / W64.sum()
    z = np.clip(np.floor(M * cs - np.float64(u)) + 1, 0, M).astype(np.int64)
    z[-1] = M
    return z


# ---------------------------------------------------------------------------
# B1: systematic z-form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [8192, 65536])
@pytest.mark.parametrize("alpha", [1.0, 0.05])
def test_systematic_z_plain_matches_jax_kernel(interpret, N, alpha):
    """|dz| <= 1 elementwise, not bit equality: S = sum(W) and the
    quantising multiply are float operations taken in another order."""
    rng = np.random.default_rng(N + int(100 * alpha))
    W = rng.dirichlet(np.full(N, alpha)).astype(np.float32)
    for u in (0.0, 0.37, 0.999):
        u32 = np.float32(u)
        zj = np.asarray(zk.systematic_z_fused(jnp.asarray(W), jnp.float32(u32),
                                              N)).astype(np.int64)
        zt = ops.systematic_z_fused(torch.from_numpy(W), float(u32), N)
        assert zt.dtype == torch.int32 and zt.shape == (N,)
        zt = zt.numpy().astype(np.int64)
        assert np.abs(zt - zj).max() <= 1
        assert np.all(np.diff(zt) >= 0) and np.all(np.diff(zj) >= 0)
        assert zt[-1] == zj[-1] == N
        assert np.abs(zt - _oracle_z(W, u32, N)).max() <= 1


@pytest.mark.parametrize("N,M", [(1, 1), (7, 7), (1000, 1000), (1000, 501),
                                 (5000, 7)])
def test_systematic_z_plain_any_size(N, M):
    """No alignment gate: any N >= 1 and any M, within one of the float64
    answer, nondecreasing, z[-1] == M."""
    rng = np.random.default_rng(N + M)
    W = rng.dirichlet(np.full(N, 0.3)).astype(np.float32)
    zt = ops.systematic_z_fused(torch.from_numpy(W), 0.25, M)
    zt = zt.numpy().astype(np.int64)
    assert zt.shape == (N,) and zt[-1] == M
    assert np.all(np.diff(zt) >= 0) and zt.min() >= 0 and zt.max() <= M
    assert np.abs(zt - _oracle_z(W, np.float32(0.25), M)).max() <= 1


def test_systematic_z_degenerate_weights():
    """One weight ~ 1: every output serves that particle."""
    N = 4096
    W = np.full(N, 1e-12, np.float64)
    W[1234] = 1.0
    W = (W / W.sum()).astype(np.float32)
    zt = ops.systematic_z_fused(torch.from_numpy(W), 0.5, N)
    A = ops.ancestors_by_z(zt, N)
    assert torch.all(A == 1234)


# ---------------------------------------------------------------------------
# B2: resampling move by z
# ---------------------------------------------------------------------------

def _z_of(W, N, u=0.37):
    return ops.systematic_z_fused(torch.from_numpy(W), u, N)


@pytest.mark.parametrize("N", [2048, 8192, 8192 - 513])
def test_repeat_plain_matches_jax_kernel(interpret, N):
    """Served values and ancestors equal exactly."""
    rng = np.random.default_rng(N)
    W = rng.dirichlet(np.full(N, 0.2)).astype(np.float32)
    zt = _z_of(W, N)
    zj = jnp.asarray(zt.numpy())
    cols = [rng.normal(size=N).astype(np.float32) for _ in range(2)]
    plan = rk.make_repeat_plan(zj, N)
    served_j, Aj = rk.repeat_with_plan_cols(
        plan, [jnp.asarray(c) for c in cols], want_anc=True)
    served_t, At = ops.repeat_cols(zt, N, [torch.from_numpy(c) for c in cols],
                                   want_anc=True)
    for yj, yt in zip(served_j, served_t, strict=True):
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert At.dtype == torch.int64
    np.testing.assert_array_equal(At.numpy(), np.asarray(Aj))
    np.testing.assert_array_equal(ops.ancestors_by_z(zt, N).numpy(),
                                  np.asarray(rk.ancestors_by_z(zj, N)))


@pytest.mark.parametrize("N", [2048, 8192 - 513])
def test_repeat_any_dtype_matches_jnp_repeat(N):
    """Payloads the TPU route could not take (int32 >= 2^24, (N, 3),
    int8) come back exact."""
    rng = np.random.default_rng(N + 1)
    W = rng.dirichlet(np.full(N, 0.5)).astype(np.float32)
    zt = _z_of(W, N, u=0.8)
    counts = jnp.asarray(np.diff(zt.numpy(), prepend=0))
    payloads = [
        rng.integers(2 ** 24, 2 ** 31 - 1, size=N).astype(np.int32),
        rng.normal(size=(N, 3)).astype(np.float32),
        rng.integers(-128, 127, size=N).astype(np.int8),
    ]
    for x in payloads:
        ref = np.asarray(jnp.repeat(jnp.asarray(x), counts, axis=0,
                                    total_repeat_length=N))
        got = ops.repeat_by_z(torch.from_numpy(x), zt, N)
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(got.numpy(), ref)
    rep = ops.serve_by_z(zt, N)
    np.testing.assert_array_equal(rep(torch.from_numpy(payloads[0])).numpy(),
                                  np.asarray(jnp.repeat(
                                      jnp.asarray(payloads[0]), counts,
                                      total_repeat_length=N)))


def test_repeat_m_not_n_and_many_payloads():
    N, M = 1000, 333
    rng = np.random.default_rng(3)
    W = rng.dirichlet(np.ones(N)).astype(np.float32)
    z = ops.systematic_z_fused(torch.from_numpy(W), 0.1, M)
    A_ref = np.searchsorted(z.numpy(), np.arange(M), side="right")
    cols = [torch.randn(N) for _ in range(ops.MAX_PAYLOADS + 3)]
    served, A = ops.repeat_cols(z, M, cols, want_anc=True)
    assert len(served) == len(cols)
    np.testing.assert_array_equal(A.numpy(), A_ref)
    for x, y in zip(cols, served, strict=True):
        assert y.shape == (M,)
        np.testing.assert_array_equal(y.numpy(), x.numpy()[A_ref])


# ---------------------------------------------------------------------------
# wrapper contracts
# ---------------------------------------------------------------------------

def test_wrappers_reject_what_the_kernels_do_not_take():
    W = torch.full((16,), 1 / 16)
    with pytest.raises(TypeError):
        ops.systematic_z_fused(W.double(), 0.5, 16)
    with pytest.raises(ValueError):
        ops.systematic_z_fused(W.reshape(4, 4), 0.5, 16)
    with pytest.raises(ValueError):
        ops.systematic_z_fused(torch.empty(0), 0.5, 16)
    with pytest.raises(ValueError):
        ops.systematic_z_fused(W, 0.5, 0)
    with pytest.raises(ValueError):
        ops.systematic_z_fused(torch.full((32,), 1 / 32)[::2], 0.5, 16)
    z = ops.systematic_z_fused(W, 0.5, 16)
    with pytest.raises(TypeError):
        ops.repeat_cols(z.long(), 16, [W])
    with pytest.raises(ValueError):
        ops.repeat_cols(z, 16, [torch.zeros(15)])
    with pytest.raises(ValueError):
        ops.repeat_cols(z, 16, [torch.zeros(16, 2).T.contiguous().T])
    with pytest.raises(TypeError):
        ops.repeat_cols(z, 16, [torch.zeros(16, dtype=torch.complex128)])


def test_non_cpu_tensors_never_reach_the_plain_versions():
    """A tensor off the CPU goes to a kernel or raises; the meta device has
    no kernel, so it raises rather than running the plain version."""
    W = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.systematic_z_fused(W, 0.5, 16)
    z = torch.empty(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.repeat_cols(z, 16, [torch.empty(16, device="meta")])
    with pytest.raises(ValueError, match="payload on"):
        ops.repeat_cols(torch.zeros(16, dtype=torch.int32), 16, [W])


def test_plain_versions_count_no_launches():
    n = tracing.counts()
    z = ops.systematic_z_fused(torch.full((64,), 1 / 64), 0.5, 64)
    ops.repeat_cols(z, 64, [torch.zeros(64)], want_anc=True)
    assert tracing.counts() == n


# ---------------------------------------------------------------------------
# the nvcc build
# ---------------------------------------------------------------------------

_FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
src = args[-1]
if "broken" in open(src).read():
    print("error: broken source")
    sys.exit(2)
open(args[args.index("-o") + 1], "w").write("lib of " + src)
"""


def test_build_compiles_stale_sources_only(tmp_path, monkeypatch):
    src, out = tmp_path / "csrc", tmp_path / "_build"
    src.mkdir()
    (src / "a.cu").write_text("ok")
    (src / "b.cu").write_text("ok")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    _build.build()
    assert sorted(p.name for p in out.iterdir()) == ["liba.so", "libb.so"]
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    mtime = (out / "liba.so").stat().st_mtime
    _build.build(["a"])                      # fresh: not rebuilt
    assert (out / "liba.so").stat().st_mtime == mtime
    later = time.time() + 10
    os.utime(src / "a.cu", (later, later))   # source newer than the .so
    _build.build(["a"])
    assert (out / "liba.so").stat().st_mtime != mtime
    (src / "c.cu").write_text("broken")
    with pytest.raises(RuntimeError, match="broken source"):
        _build.build(["c"])
    assert not any("tmp" in p.name for p in out.iterdir())


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax nor the JAX
    package."""
    code = (
        "import importlib, sys\n"
        "import particles_tpu_torch as p\n"
        "for m in p._SUBMODULES + ('_build', 'ops.z_kernel', "
        "'ops.repeat_kernel', 'ops.merge_rank_kernel', "
        "'ops.cummax_kernel'):\n"
        "    importlib.import_module('particles_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'particles_tpu')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)
