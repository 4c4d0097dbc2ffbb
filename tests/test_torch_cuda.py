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

from particles_tpu_torch import kalman, ops
from particles_tpu_torch import state_space_models as ssms
from particles_tpu_torch.core import SMC

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _weights(N, alpha, seed):
    g = np.random.default_rng(seed).standard_gamma(alpha, N)
    return (g / g.sum()).astype(np.float32)


@pytest.mark.parametrize("N", [1, 7, 1000, 65539])
@pytest.mark.parametrize("alpha", [1.0, 0.05])
def test_systematic_z_kernel_matches_plain(dev, N, alpha):
    """|dz| <= 1: the kernel and the plain version sum S in another
    order."""
    W = torch.from_numpy(_weights(N, alpha, N)).to(dev)
    for u in (0.0, 0.37, 0.999):
        ut = torch.tensor(u, dtype=torch.float32, device=dev)
        before = ops.systematic_z_fused.launches
        z = ops.systematic_z_fused(W, ut, N)
        assert ops.systematic_z_fused.launches == before + 1
        zp = ops.systematic_z_plain(W, ut, N)
        torch.cuda.synchronize()
        assert z.dtype == torch.int32 and z.shape == (N,)
        assert int((z.long() - zp.long()).abs().max()) <= 1
        assert bool((z[1:] >= z[:-1]).all()) and int(z[-1]) == N


@pytest.mark.parametrize("N,M", [(1, 1), (1000, 1000), (65539, 65539),
                                 (1000, 377)])
def test_repeat_kernel_matches_plain(dev, N, M):
    W = torch.from_numpy(_weights(N, 0.3, N + 1)).to(dev)
    z = ops.systematic_z_fused(W, 0.5, M)
    cols = [torch.randn(N, device=dev),
            torch.randint(2 ** 24, 2 ** 31 - 1, (N,), device=dev,
                          dtype=torch.int32),
            torch.randn(N, 2, device=dev, dtype=torch.float64),
            torch.randint(0, 2, (N,), device=dev).bool()]
    cols += [torch.randn(N, device=dev) for _ in range(ops.MAX_PAYLOADS)]
    before = ops.repeat_cols.launches
    served, A = ops.repeat_cols(z, M, cols, want_anc=True)
    assert ops.repeat_cols.launches == before + 2   # 12 payloads, 8 a launch
    ref, A_ref = ops.repeat_cols_plain(z, M, cols, want_anc=True)
    torch.cuda.synchronize()
    assert torch.equal(A, A_ref)
    for y, yp in zip(served, ref, strict=True):
        assert y.dtype == yp.dtype and torch.equal(y, yp)
    assert torch.equal(ops.ancestors_by_z(z, M), A_ref)


def test_wrappers_check_before_launching(dev):
    before = (ops.systematic_z_fused.launches, ops.repeat_cols.launches)
    with pytest.raises(TypeError):
        ops.systematic_z_fused(torch.ones(8, device=dev, dtype=torch.float64),
                               0.5, 8)
    z = ops.systematic_z_fused(torch.full((8,), 0.125, device=dev), 0.5, 8)
    with pytest.raises(ValueError):
        ops.repeat_cols(z, 8, [torch.zeros(8)])   # payload on the CPU
    with pytest.raises(TypeError):
        ops.repeat_cols(z, 8, [torch.zeros(8, device=dev,
                                           dtype=torch.complex128)])
    assert ops.systematic_z_fused.launches == before[0] + 1
    assert ops.repeat_cols.launches == before[1]


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
    ops.systematic_z_fused.launches = ops.repeat_cols.launches = 0
    pf = SMC(fk=ssms.Bootstrap(ssm=ssm, data=torch.from_numpy(y).to(dev)),
             N=N, seed=0)
    pf.run()
    n_rs = int(pf.summaries.rs_flags.sum())
    assert ops.systematic_z_fused.launches == ops.repeat_cols.launches == n_rs
    assert pf.X.device.type == "cuda"
    assert abs(float(pf.logLt) - kf) < 0.5
