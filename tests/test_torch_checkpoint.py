"""Checkpoint and resume of the port's ``SMC`` (``save_state`` and
``load_state``), after the JAX package's ``tests/test_core.py::
TestCheckpointResume`` and ``tests/test_smc_samplers.py``'s rolling
sampler history round trip.

A run stepped to t = k, saved, and loaded into a NEW ``SMC`` built with a
different seed must run on bit for bit as the uninterrupted run: the same
logLt and X, and the collectors' records carried on.  The checkpoint is
read with ``torch.load(weights_only=True)``, so it holds only tensors,
lists, tuples, dicts and numbers.
"""

import numpy as np
import pytest
import torch

from particles_tpu_torch import collectors, kalman
from particles_tpu_torch import distributions as dists
from particles_tpu_torch import smc_samplers as ssp
from particles_tpu_torch import state_space_models as ssms
from particles_tpu_torch.core import SMC

T = 20
N = 150


class LG(kalman.LinearGauss):
    """The linear Gaussian model with the additive function x_t of the
    on-line smoothers."""

    def add_func(self, t, xp, x):
        return x


@pytest.fixture(scope="module")
def fk():
    ssm = LG(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    _, y = ssm.simulate(torch.Generator().manual_seed(0), T)
    return ssms.Bootstrap(ssm=ssm, data=y)


def _round_trip(make, k, path):
    """(uninterrupted run, resumed run): the second stepped to t = k by an
    object seeded 7, saved, and loaded into one seeded 99."""
    ref = make(7)
    for _ in ref:
        pass
    pf1 = make(7)
    for _ in range(k):
        next(pf1)
    pf1.save_state(path)
    pf2 = make(99)
    pf2.load_state(path)
    assert pf2.t == k
    for _ in pf2:
        pass
    return ref, pf2


def _same_records(a, b):
    for c in a.summaries._collectors:
        ra = getattr(a.summaries, c.summary_name)
        rb = getattr(b.summaries, c.summary_name)
        if isinstance(ra, torch.Tensor):
            assert torch.equal(ra, rb), c.summary_name
        else:
            assert len(ra) == len(rb), c.summary_name
            for u, v in zip(ra, rb):
                if isinstance(u, dict):
                    for key in u:
                        assert torch.equal(u[key], v[key])
                else:
                    assert torch.equal(torch.as_tensor(u),
                                       torch.as_tensor(v)), c.summary_name


OPTIONS = {
    "bootstrap": {},
    "qmc": {"qmc": True},
    "history": {"store_history": True},
    "rolling history": {"store_history": 3},
    "partial history": {"store_history": lambda t: t % 3 == 0},
    "Moments and Online_smooth_naive": {
        "collect": [collectors.Moments(), collectors.Online_smooth_naive()]},
    "Paris": {"collect": [collectors.Paris(max_trials=4)]},
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_round_trip_is_bit_identical(fk, tmp_path, name):
    opts = OPTIONS[name]
    ref, pf = _round_trip(lambda s: SMC(fk=fk, N=N, seed=s, **opts), 8,
                          tmp_path / "ckpt.pt")
    assert float(pf.logLt) == float(ref.logLt)
    assert torch.equal(pf.X, ref.X)
    assert pf.summaries.ESSs.shape == (T,)
    _same_records(pf, ref)
    if name == "history":
        for f in ("X", "A", "lw"):
            assert torch.equal(getattr(pf.hist, f), getattr(ref.hist, f))
    elif name == "rolling history":
        assert pf.hist.T == 3
        for a, b in zip(pf.hist.X, ref.hist.X):
            assert torch.equal(a, b)
    elif name == "partial history":
        assert list(pf.hist.X) == list(ref.hist.X) == list(range(0, T, 3))
        for t in pf.hist.X:
            assert torch.equal(pf.hist.X[t], ref.hist.X[t])
    elif name == "Paris":
        assert pf.summaries._collectors[-1].rounds == \
            ref.summaries._collectors[-1].rounds


def test_the_checkpoint_holds_plain_data_only(fk, tmp_path):
    pf = SMC(fk=fk, N=N, seed=1, collect=[collectors.Paris(max_trials=4)],
             store_history=True)
    for _ in range(4):
        next(pf)
    path = tmp_path / "ckpt.pt"
    pf.save_state(path)
    state = torch.load(path, weights_only=True)
    assert state["t"] == 4 and state["hist_kind"] == "full"


class GaussianMean(ssp.StaticModel):
    def logpyt(self, theta, t):
        return dists.Normal(loc=theta["mu"], scale=1.0).logpdf(self.data[t])


def _conj_model():
    y = np.random.default_rng(0).normal(loc=1.5, size=30).astype(np.float32)
    return GaussianMean(data=y, prior=dists.StructDist(
        {"mu": dists.Normal(0.0, 1.0)}), device="cpu")


def test_ibis_rolling_sampler_history_round_trip(tmp_path):
    """``tests/test_smc_samplers.py::test_rolling_history_checkpoint_roundtrip``:
    the 3-frame window and its times survive, keep rolling after the
    resume, and the run is bit for bit the uninterrupted one (its
    ``ThetaParticles.shared`` — the calibrated scale, the acceptance rate —
    carried across)."""
    model = _conj_model()

    def make(s):
        return SMC(fk=ssp.IBIS(model=model, len_chain=3), N=50, seed=s,
                   store_history=3)

    pf1 = make(4)
    for _ in range(5):
        next(pf1)
    path = tmp_path / "ckpt.pt"
    pf1.save_state(path)
    pf2 = make(0)
    pf2.load_state(path)
    assert list(pf2.hist.times) == list(pf1.hist.times)
    assert torch.equal(pf2.hist.X[-1].theta["mu"], pf1.hist.X[-1].theta["mu"])
    assert set(pf2.X.shared) == set(pf1.X.shared)
    for k, v in pf1.X.shared.items():
        assert torch.equal(pf2.X.shared[k], v), k
    for _ in pf2:
        pass
    assert pf2.hist.T == 3
    assert list(pf2.hist.times) == [pf2.t - 3, pf2.t - 2, pf2.t - 1]
    ref = make(4)
    for _ in ref:
        pass
    assert float(pf2.logLt) == float(ref.logLt)
    assert torch.equal(pf2.X.theta["mu"], ref.X.theta["mu"])


def test_smc2_round_trip(tmp_path):
    """SMC²: the θ-particles' inner filters (``xs``, ``lws``, ``loglik``)
    and the exchange-step state carried across."""
    class LGfixed(kalman.LinearGauss):
        default_params = {"sigmaY": 0.5, "rho": 0.9, "sigmaX": 1.0,
                          "sigma0": None}

    true = kalman.LinearGauss(rho=0.8, sigmaX=1.0, sigmaY=0.5)
    _, y = true.simulate(torch.Generator().manual_seed(0), 10)
    prior = dists.StructDist({"rho": dists.Uniform(a=-0.99, b=0.99)})

    def make(s):
        return SMC(fk=ssp.SMC2(ssm_cls=LGfixed, prior=prior, data=y,
                               init_Nx=16, len_chain=3,
                               ar_to_increase_Nx=0.9), N=40, seed=s)

    ref, pf = _round_trip(make, 5, tmp_path / "ckpt.pt")
    assert float(pf.logLt) == float(ref.logLt)
    assert torch.equal(pf.X.xs, ref.X.xs)
    assert torch.equal(pf.X.theta["rho"], ref.X.theta["rho"])


def test_save_before_a_step_raises(fk, tmp_path):
    pf = SMC(fk=fk, N=50)
    with pytest.raises(ValueError, match="nothing to save"):
        pf.save_state(tmp_path / "nope.pt")


@pytest.mark.parametrize("saved,loaded", [(True, False), (3, True),
                                          (False, 3)])
def test_history_kind_mismatch_raises(fk, tmp_path, saved, loaded):
    pf = SMC(fk=fk, N=50, store_history=saved)
    next(pf)
    pf.save_state(tmp_path / "ckpt.pt")
    with pytest.raises(ValueError, match="history"):
        SMC(fk=fk, N=50, store_history=loaded).load_state(
            tmp_path / "ckpt.pt")
