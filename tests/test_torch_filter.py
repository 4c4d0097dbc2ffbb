"""The port's bootstrap particle filter (``particles_tpu_torch.SMC``)
against the JAX package and the Kalman filter.

JAX keys and torch generators give different streams, so the filter is
compared in two ways: one deterministic step built from the same numpy
arrays in both packages (exact where the arithmetic is the same, rtol
1e-5 in float32 where the order of a reduction differs), and the whole
filter by statistics over fixed seeds.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import particles_tpu.core as jcore
import particles_tpu.kalman as jk
import particles_tpu.ops.z_kernel as zk
import particles_tpu.resampling as jrs
import particles_tpu.state_space_models as jssms
import particles_tpu_torch.resampling as trs
from particles_tpu_torch import (collectors, convert, core, distributions,
                                 kalman, ops, smc_samplers)
from particles_tpu_torch import state_space_models as ssms

PARAMS = dict(rho=0.9, sigmaX=1.0, sigmaY=0.2)


def _simulate(T, seed):
    rng = np.random.default_rng(seed)
    xs = np.empty(T)
    xs[0] = rng.normal() / np.sqrt(1 - PARAMS["rho"] ** 2)
    for t in range(1, T):
        xs[t] = PARAMS["rho"] * xs[t - 1] + PARAMS["sigmaX"] * rng.normal()
    return (xs + PARAMS["sigmaY"] * rng.normal(size=T)).astype(np.float32)


def _models(y):
    jssm = jk.LinearGauss(**PARAMS)
    tssm = convert.ssm_from_params(
        "LinearGauss",
        {k: np.asarray(getattr(jssm, k)) for k in jssm.default_params},
        device="cpu")
    return (jssms.Bootstrap(ssm=jssm, data=jnp.asarray(y)),
            convert.bootstrap_from_numpy(tssm, y, device="cpu"))


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(zk, "_on_tpu", lambda: True)
    yield
    zk._z_pallas.clear_cache()


def test_one_step_matches_jax(interpret):
    """Weights -> resampling decision -> systematic z -> move -> logG,
    from the same X, lw, u and noise in both packages."""
    N, t = 8192, 3
    rng = np.random.default_rng(11)
    X = rng.normal(size=N).astype(np.float32)
    lw = (2.0 * rng.normal(size=N)).astype(np.float32)
    u = np.float32(0.61)
    noise = rng.normal(size=N).astype(np.float32)
    jfk, tfk = _models(_simulate(10, 0))

    jw = jrs.Weights(jnp.asarray(lw))
    tw = trs.Weights(torch.from_numpy(lw))
    np.testing.assert_allclose(float(tw.ESS), float(jw.ESS), rtol=1e-5)
    j_rs = bool(jw.ESS < N * 0.5)
    t_rs = bool(tfk.time_to_resample(core.StepView(
        fk=tfk, t=t, X=None, Xp=None, A=None, wgts=tw, aux=tw, rs_flag=None,
        logLt=None, loglt=None, N=N, ESSrmin=0.5)))
    assert t_rs == j_rs is True

    zj = np.asarray(zk.systematic_z_fused(jw.W, jnp.float32(u), N))
    zt = ops.systematic_z_fused(tw.W, float(u), N)
    assert np.abs(zt.numpy().astype(np.int64) - zj).max() <= 1
    # the move, through the port's own z in both packages
    Xp_t = ops.repeat_by_z(torch.from_numpy(X), zt, N)
    counts = jnp.asarray(np.diff(zt.numpy(), prepend=0))
    Xp_j = jnp.repeat(jnp.asarray(X), counts, total_repeat_length=N)
    np.testing.assert_array_equal(Xp_t.numpy(), np.asarray(Xp_j))

    # X_t = rho * Xp + sigmaX * noise, the Normal draw with the noise given
    Xn_j = jfk.ssm.PX(t, Xp_j).loc + jfk.ssm.sigmaX * jnp.asarray(noise)
    Xn_t = tfk.ssm.PX(t, Xp_t).loc + tfk.ssm.sigmaX * torch.from_numpy(noise)
    np.testing.assert_array_equal(Xn_t.numpy(), np.asarray(Xn_j))
    lwn_j = jfk.logG(t, Xp_j, Xn_j)
    lwn_t = tfk.logG(t, Xp_t, Xn_t)
    np.testing.assert_allclose(lwn_t.numpy(), np.asarray(lwn_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(trs.Weights(lwn_t).log_mean),
                               float(jrs.Weights(lwn_j).log_mean), rtol=1e-5)


def test_filter_matches_kalman_and_jax_by_statistics():
    """T=25, N=4096, 8 fixed seeds.  One run's logLt has sd ~ 0.13, so the
    mean of 8 has sd ~ 0.045: the port's mean within 0.25 of Kalman, and
    within 0.35 of the JAX package's mean on the same data."""
    T, N, seeds = 25, 4096, range(8)
    y = _simulate(T, 1)
    jfk, tfk = _models(y)
    kf = float(kalman.Kalman(ssm=tfk.ssm,
                             data=torch.from_numpy(y.astype(np.float64))).logLt)
    port = []
    for s in seeds:
        pf = core.SMC(fk=tfk, N=N, seed=s)
        pf.run()
        port.append(float(pf.logLt))
    jax_runs = []
    for s in seeds:
        pf = jcore.SMC(fk=jfk, N=N, seed=s)
        pf.run()
        jax_runs.append(float(pf.logLt))
    assert np.all(np.isfinite(port))
    assert abs(np.mean(port) - kf) < 0.25
    assert abs(np.mean(port) - np.mean(jax_runs)) < 0.35


def test_iterator_protocol_and_summaries():
    T = 12
    _, tfk = _models(_simulate(T, 2))
    pf = core.SMC(fk=tfk, N=256, seed=0)
    next(pf)
    next(pf)
    assert pf.t == 2 and isinstance(pf.summaries.ESSs, list)
    pf.run()
    assert pf.t == T
    s = pf.summaries
    assert s.ESSs.shape == s.logLts.shape == s.rs_flags.shape == (T,)
    assert s.rs_flags.dtype == torch.bool and not bool(s.rs_flags[0])
    assert float(s.logLts[-1]) == float(pf.logLt)
    assert pf.X.shape == (256,) and pf.W.shape == (256,)
    assert pf.cpu_time > 0
    with pytest.raises(StopIteration):
        next(pf)

    again = core.SMC(fk=tfk, N=256, seed=0)
    again.run()
    assert float(again.logLt) == float(pf.logLt)   # same seed, same stream
    g = torch.Generator().manual_seed(0)
    with_gen = core.SMC(fk=tfk, N=256, generator=g)
    with_gen.run()
    assert float(with_gen.logLt) == float(pf.logLt)


# what SMC(verbose=True) prints after each step, in both packages
VERBOSE_LINE = re.compile(
    r"t=(\d+): resample=(True|False), ESS \(end of iter\)=(\S+)")


@pytest.mark.parametrize("entry", ["SMC", "multiSMC"])
def test_verbose_prints_one_line_a_step_as_jax_does(entry, capsys):
    """``verbose=True`` prints ``fk.summary_format`` after each step, one
    line a step in the JAX package's format: t, the resampling flag, and
    the ESS as a number (the step's recorded ESS).  ``verbose=False``
    prints nothing."""
    T, N = 5, 64
    jfk, tfk = _models(_simulate(T, 4))

    def lines(run):
        run()
        return [VERBOSE_LINE.fullmatch(line)
                for line in capsys.readouterr().out.splitlines()]

    if entry == "SMC":
        jax_lines = lines(jcore.SMC(fk=jfk, N=N, verbose=True).run)
        pf = core.SMC(fk=tfk, N=N, seed=0, verbose=True)
        port_lines = lines(pf.run)
        summaries = pf.summaries
        assert lines(core.SMC(fk=tfk, N=N, seed=0).run) == []
    else:
        jax_lines = lines(lambda: jcore.multiSMC(fk=jfk, N=N, nruns=1,
                                                 verbose=True))
        runs = []
        port_lines = lines(lambda: runs.extend(core.multiSMC(
            fk=tfk, N=N, nruns=1, verbose=True)))
        summaries = runs[0]["output"].summaries
        assert lines(lambda: core.multiSMC(fk=tfk, N=N, nruns=1)) == []
    for got in (jax_lines, port_lines):
        assert len(got) == T and all(got)
        assert [int(m[1]) for m in got] == list(range(T))
        assert got[0][2] == "False"
        assert all(0.0 < float(m[3]) <= N for m in got)
    assert ([m[2] == "True" for m in port_lines]
            == summaries.rs_flags.tolist())
    assert ([float(m[3]) for m in port_lines]
            == [float(e) for e in summaries.ESSs])


def test_decision_follows_ess_and_logLt_accounting():
    """ESSrmin=0 never resamples, 1 always does; without resampling the
    increments telescope, so logLt is log_mean of the accumulated
    weights."""
    T = 10
    _, tfk = _models(_simulate(T, 3))
    never = core.SMC(fk=tfk, N=512, seed=1, ESSrmin=0.0)
    never.run()
    assert not bool(never.summaries.rs_flags.any())
    np.testing.assert_allclose(float(never.logLt),
                               float(never.wgts.log_mean), rtol=1e-5)
    always = core.SMC(fk=tfk, N=512, seed=1, ESSrmin=1.0 + 1e-6)
    always.run()
    assert bool(always.summaries.rs_flags[1:].all())


def test_mv_model_and_dict_particles():
    """(N, 2) particles go through the move in one call; dict particles
    are served leaf by leaf in one call too."""
    ssm = kalman.MVLinearGauss_Guarniero_etal(alpha=0.4, dx=2)
    x, y = ssm.simulate(torch.Generator().manual_seed(3), 10)
    kf = float(kalman.Kalman(ssm=ssm, data=y.double()).logLt)
    runs = []
    for s in range(4):
        pf = core.SMC(fk=ssms.Bootstrap(ssm=ssm, data=y), N=4096, seed=s)
        pf.run()
        assert pf.X.shape == (4096, 2)
        runs.append(float(pf.logLt))
    assert abs(np.mean(runs) - kf) < 0.3
    z = ops.systematic_z_fused(torch.full((6,), 1 / 6), 0.5, 6)
    X = {"a": torch.arange(6.0), "b": torch.arange(12).reshape(6, 2)}
    Xp, A = core._serve(X, z, 6, want_anc=True)
    assert torch.equal(Xp["a"], X["a"][A]) and torch.equal(Xp["b"], X["b"][A])


class _Ancestors(collectors.Collector):
    summary_name = "ancestors"

    def collect(self, view):
        return view.A


def test_genealogy_collector_gets_ancestors():
    T, N = 6, 128
    _, tfk = _models(_simulate(T, 4))
    pf = core.SMC(fk=tfk, N=N, seed=0, collect=[_Ancestors()])
    pf.run()
    A = pf.summaries.ancestors
    assert A.shape == (T, N) and A.dtype == torch.int64
    for t in range(T):
        if bool(pf.summaries.rs_flags[t]):
            assert bool((A[t, 1:] >= A[t, :-1]).all())
        else:
            assert torch.equal(A[t], torch.arange(N))


def test_unported_options_raise():
    _, tfk = _models(_simulate(5, 5))

    # the samplers (A.9) are ported now: an IBIS Feynman-Kac model runs
    # through the sampler step (N0 = N * len_chain particles, one
    # observation a step); SQMC (A.8) runs, resampling at every step
    class Mean(smc_samplers.StaticModel):
        def logpyt(self, theta, t):
            return distributions.Normal(loc=theta["mu"]).logpdf(self.data[t])

    model = Mean(data=tfk.data, prior=distributions.StructDist(
        {"mu": distributions.Normal()}))
    ibis = core.SMC(fk=smc_samplers.IBIS(model=model, len_chain=4), N=64,
                    seed=0)
    ibis.run()
    assert ibis.t == 5 and ibis.X.N == 256 and ibis.X.lpost.shape == (256,)
    assert np.isfinite(float(ibis.logLt))
    with pytest.raises(ValueError, match="counts-based"):
        core.SMC(fk=smc_samplers.IBIS(model=model), N=64,
                 resampling="killing")
    sqmc = core.SMC(fk=tfk, N=64, qmc=True, seed=0)
    sqmc.run()
    assert sqmc.qmc and bool(sqmc.summaries.rs_flags[1:].all())
    with pytest.raises(ValueError):
        core.SMC(fk=tfk, N=64, resampling="nonsense")

    # auxiliary filters (A.5) are ported now: with logeta = 0 the
    # auxiliary weights are the weights and the reset is to zero, so the
    # run is the bootstrap filter's, draw for draw
    class APF(type(tfk)):
        def logeta(self, t, x):
            return torch.zeros(x.shape[0])

    apf = core.SMC(fk=APF(ssm=tfk.ssm, data=tfk.data), N=64, seed=3)
    boot = core.SMC(fk=tfk, N=64, seed=3)
    apf.run()
    boot.run()
    assert apf.fk.isAPF and torch.equal(apf.X, boot.X)
    np.testing.assert_allclose(float(apf.logLt), float(boot.logLt),
                               rtol=1e-6)

    # history (A.3) and stateful collectors (A.6) are ported now: they run
    class Stateful(collectors.Collector):
        stateful = True

        def init(self, view):
            return 0, view.t

        def step(self, view, state):
            return state + 1, state + 1

    pf = core.SMC(fk=tfk, N=64, store_history=True, collect=[Stateful()])
    pf.run()
    assert pf.hist.T == 5 and pf.summaries.stateful.tolist() == list(range(5))
    off = core.SMC(fk=tfk, N=64, collect="off")
    off.run()
    assert off.summaries is None and np.isfinite(float(off.logLt))


def test_numpy_data_never_runs_on_the_cpu_by_default(monkeypatch):
    """Without a card, every entry point that would place numpy data or
    parameters raises, naming device="cpu", instead of running on the
    CPU; with device="cpu" (or CPU tensors) it runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = _simulate(6, 6)
    ssm = kalman.LinearGauss(**PARAMS)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ssms.Bootstrap(ssm=ssm, data=y)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        convert.bootstrap_from_numpy(ssm, y)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        convert.ssm_from_params("LinearGauss", {"rho": np.float32(0.9)})

    class NoData(core.FeynmanKac):
        T = 3

    with pytest.raises(RuntimeError, match='device="cpu"'):
        core.SMC(fk=NoData(), N=8)
    fk = ssms.Bootstrap(ssm=ssm, data=y, device="cpu")
    assert fk.data.device.type == "cpu" and fk.data.dtype == torch.float32
    pf = core.SMC(fk=fk, N=64, seed=0)
    assert pf.device.type == "cpu"
    pf.run()
    on_given = core.SMC(fk=NoData(), N=8, generator=torch.Generator())
    assert on_given.device.type == "cpu"
