"""Rank bodies of ``tests/test_torch_distributed.py``.

Every function here runs on each rank of a ``launch.spawn`` group, so this
module imports neither JAX nor the JAX package: a spawned rank imports
the module that defines its target.  :func:`run_all` runs every scenario
of one launch and returns plain arrays (the parent joins the ranks'
slices); its inputs are numpy arrays made from seeds by the test file.
"""

import time

import numpy as np
import torch
import torch.distributed as dist

from particles_tpu_torch import collectors as col
from particles_tpu_torch import convert, kalman, mcmc, nested, ops, tracing
from particles_tpu_torch import smc_samplers as ssp
from particles_tpu_torch import distributions as dists
from particles_tpu_torch import state_space_models as ssms
from particles_tpu_torch.parallel import comm, distributed, dqmc, sharded

SEEDS = (0, 1, 2)
FILTERS = ("Bootstrap", "GuidedPF", "AuxiliaryPF", "AuxiliaryBootstrap")
SQMC_N, SMC2_NTHETA, SMC2_NX, SAMPLER_N = 1024, 152, 150, 128
PMMH_CHAINS, PMMH_NITER, PMMH_NX = 8, 200, 100


class LGfixed(kalman.LinearGauss):
    """The fixed-sigma LinearGauss of SMC² and PMMH: rho is the parameter
    (tests/test_parallel.py ``TestShardedSMC2``)."""

    default_params = {"sigmaY": 0.5, "rho": 0.9, "sigmaX": 1.0,
                      "sigma0": None}


RHO_PRIOR = dists.StructDist({"rho": dists.Uniform(a=-0.99, b=0.99)})


class GaussTarget(ssp.StaticModel):
    """The conjugate Gaussian mean of ``TestShardedSamplers``: y_t ~ N(m,
    1), m ~ N(0, 2^2)."""

    def logpyt(self, theta, t):
        return -0.5 * np.log(2 * np.pi) - 0.5 * (self.data[t] - theta["m"]) ** 2


def _counted(prefix, names):
    counts = tracing.counts()
    return {k: counts.get(prefix + k, 0) for k in names}


def _launches():
    """Each kernel's launches so far (``launch.<kernel>``)."""
    return _counted("launch.", ops.KERNELS)


def _calls():
    """Each collective's calls so far (``comm.<name>``)."""
    return _counted("comm.", comm.COLLECTIVES)


def _since(before):
    """The collectives' calls since ``before``, a reading of
    :func:`_calls`."""
    now = _calls()
    return {k: now[k] - before[k] for k in now}


def _rings(device, inp, group=None):
    """The three rings over ``group`` on the given global arrays: each
    result is the rank's (served x, ancestors) slices."""
    D, d = dist.get_world_size(group), dist.get_rank(group)
    out = {}
    x = convert.rank_slice(inp["x"], d, D, device)
    x2 = convert.rank_slice(inp["x2"], d, D, device)
    u = torch.tensor(inp["u"], dtype=torch.float32, device=device)
    table = torch.tensor(inp["u_table"], device=device)
    for kind in ("exact", "dirichlet"):
        w = convert.rank_slice(inp[f"w_{kind}"], d, D, device)
        M = w.shape[0] * D
        y, A = distributed.ring_systematic_resample(
            {"a": x, "b": x2}, w, u, M, group, return_ancestors=True)
        out[f"systematic_{kind}"] = (y["a"], y["b"], A)
        y, A = distributed.ring_stratified_resample(
            {"a": x}, w, None, M, group, return_ancestors=True,
            uniforms=lambda k: table.index_select(0, k.long()))
        out[f"stratified_{kind}"] = (y["a"], A)
        su = convert.rank_slice(inp["su"], d, D, device)
        y, A = dqmc.ring_merge_resample({"a": x}, su, w, group,
                                        return_ancestors=True)
        out[f"merge_{kind}"] = (y["a"], A)
    for pos in inp["one_hot"]:
        w = np.zeros(inp["x"].shape[0], np.float32)
        w[pos] = 1.0
        wl = convert.rank_slice(w, d, D, device)
        out[f"one_hot_{pos}"] = distributed.ring_systematic_resample(
            x, wl, u, w.shape[0], group)
    return out


def _engine(device, inp):
    """``run_shardmap_smc`` over filters, schemes, seeds, collectors and
    histories, with the collective counts of each run."""
    out = {}
    ssm = kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    y, N = inp["y"], inp["N"]

    def run(tag, fk, **kw):
        calls = _calls()
        res = distributed.run_shardmap_smc(fk, N, **kw)
        out[tag] = {"logLt": float(res.logLt), "rs_flags": res.rs_flags,
                    "ESSs": res.ESSs, "calls": _since(calls)}
        return res

    for name in FILTERS:
        fk = getattr(ssms, name)(ssm=ssm, data=y, device=device)
        for seed in SEEDS:
            run(f"{name}_{seed}", fk, seed=seed)
        # every step resamples: the ring and the auxiliary reset run
        run(f"{name}_always", fk, seed=7, ESSrmin=1.0)
    boot = ssms.Bootstrap(ssm=ssm, data=y, device=device)
    for scheme in ("stratified", "multinomial"):
        for seed in SEEDS:
            run(f"{scheme}_{seed}", boot, seed=seed, resampling=scheme)
    res = run("moments", boot, seed=3, collect=[col.Moments()])
    out["moments"]["mean"] = torch.stack([m["mean"] for m in res.moments])
    out["moments"]["var"] = torch.stack([m["var"] for m in res.moments])
    out["moments"]["X"], out["moments"]["lw"] = res.X, res.lw
    res = run("full", boot, seed=9, store_history=True)
    out["full"].update(X=res.hist.X, A=res.hist.A, lw=res.hist.lw)
    res = run("rolling", boot, seed=1, store_history=4)
    out["rolling"].update(T=res.hist.T, X=torch.stack(list(res.hist.X)),
                          A=torch.stack(list(res.hist.A)))
    res = run("partial", boot, seed=1, store_history=lambda t: t % 5 == 0)
    out["partial"].update(times=sorted(res.hist.X),
                          X=torch.stack([res.hist.X[t]
                                         for t in sorted(res.hist.X)]))
    return out


def _ffbs(device, inp):
    """Sharded FFBS-MCMC over a sharded history, with its collectives."""
    ssm = kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.3)
    fk = ssms.Bootstrap(ssm=ssm, data=inp["y_smooth"], device=device)
    res = distributed.run_shardmap_smc(fk, inp["N_smooth"], seed=1,
                                       store_history=True)
    calls = _calls()
    paths = distributed.sharded_backward_mcmc(res.hist, inp["M_smooth"],
                                              seed=3, nsteps=2)
    return {"paths": paths, "calls": _since(calls), "X": res.hist.X,
            "A": res.hist.A, "lw": res.hist.lw}


def _multinomial_counts(device, inp):
    """Offspring counts of the multinomial ring over replicates: the
    rank's bincount of its ancestors, summed over the ranks by the
    parent."""
    D, d = dist.get_world_size(), dist.get_rank()
    w = convert.rank_slice(inp["w_multi"], d, D, device)
    N = inp["w_multi"].shape[0]
    gen = torch.Generator(device=device).manual_seed(11)
    rank_gen = torch.Generator(device=device).manual_seed(100 + d)
    counts = []
    for _ in range(inp["replicates"]):
        _, A = distributed.ring_multinomial_resample(
            w.new_zeros(w.shape[0]), w, gen, rank_gen, N,
            return_ancestors=True)
        counts.append(torch.bincount(A, minlength=N))
    return torch.stack(counts)


def _raises(device, inp):
    """The documented raises: each message, or None when nothing raised."""
    ssm = kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    fk = ssms.Bootstrap(ssm=ssm, data=inp["y"][:5], device=device)
    prior = dists.StructDist({"m": dists.Normal(scale=2.0)})

    class Gauss(ssp.StaticModel):
        def logpyt(self, theta, t):
            return -0.5 * (self.data[t] - theta["m"]) ** 2

    sampler = ssp.IBIS(model=Gauss(data=torch.zeros(5, device=device),
                                   prior=prior))
    mesh = sharded.make_mesh(device_type=device.type)
    cases = {
        "qmc_not_a_power_of_two": lambda: distributed.run_shardmap_smc(
            fk, 768, qmc=True),
        "ssp": lambda: distributed.run_shardmap_smc(fk, 512,
                                                    resampling="ssp"),
        "collector": lambda: distributed.run_shardmap_smc(
            fk, 512, collect=[col.Online_smooth_naive(phi=lambda x: x)]),
        "indivisible": lambda: distributed.run_shardmap_smc(fk, 514),
        "sampler_ssp": lambda: distributed.run_shardmap_smc(
            sampler, 512, resampling="ssp"),
        "nchains": lambda: mcmc.PMMH(
            ssm_cls=LGfixed, prior=RHO_PRIOR, data=inp["y"][:5], Nx=10,
            niter=2, nchains=6, mesh=mesh, device=device),
    }
    out = {}
    for name, call in cases.items():
        try:
            call()
            out[name] = None
        except (NotImplementedError, ValueError) as exc:
            out[name] = f"{type(exc).__name__}: {exc}"
    return out


def _dqmc(device, inp):
    """The distributed sort, Hilbert keys (with the global moments they
    used) and Hilbert reorder on the given global arrays, and the
    exchanges they made."""
    D, d = dist.get_world_size(), dist.get_rank()

    def sl(a):
        return convert.rank_slice(a, d, D, device)

    calls = _calls()
    key, (idx, x) = dqmc.dist_sort_with(
        sl(inp["sort_keys"]), (sl(inp["sort_idx"]), sl(inp["sort_x"])))
    out = {"sort": (key, idx, x), "sort_calls": _since(calls)}
    hx = sl(inp["hx"])
    m, sd = dqmc._dist_moments(hx)
    out["keys"] = (dqmc._dist_hilbert_keys(hx), m, sd)
    X, (lw, ix) = dqmc.dist_qmc_reorder(hx, (sl(inp["hlw"]),
                                             sl(inp["sort_idx"])))
    out["reorder"] = (X, lw, ix)
    X1, (ix1,) = dqmc.dist_qmc_reorder(sl(inp["sort_x"]),
                                       (sl(inp["sort_idx"]),))
    out["reorder_1d"] = (X1, ix1)
    return out


def _sqmc(device, inp):
    """Distributed SQMC: the bootstrap filter over seeds, the guided and
    auxiliary filters, a 3-d model, the history, and a run whose seed a
    single-device run repeats."""
    y, N = inp["y"], SQMC_N
    ssm = kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    out = {}
    for name in ("Bootstrap", "GuidedPF", "AuxiliaryPF"):
        fk = getattr(ssms, name)(ssm=ssm, data=y, device=device)
        for seed in SEEDS:
            calls = _calls()
            res = distributed.run_shardmap_smc(fk, N, seed=seed, qmc=True)
            out[f"{name}_{seed}"] = {"logLt": float(res.logLt),
                                     "ESSs": res.ESSs,
                                     "rs_flags": res.rs_flags,
                                     "calls": _since(calls)}
    boot = ssms.Bootstrap(ssm=ssm, data=y, device=device)
    res = distributed.run_shardmap_smc(boot, N, seed=11, qmc=True)
    out["same_seed"] = {"logLt": float(res.logLt), "ESSs": res.ESSs}
    res = distributed.run_shardmap_smc(boot, N, seed=9, qmc=True,
                                       store_history=True)
    out["hist"] = {"X": res.hist.X, "A": res.hist.A, "lw": res.hist.lw,
                   "hilbert_ordered": res.hist.hilbert_ordered}
    mv = kalman.MVLinearGauss_Guarniero_etal(alpha=0.4, dx=3, device=device)
    fk = ssms.Bootstrap(ssm=mv, data=inp["y_mv"], device=device)
    res = distributed.run_shardmap_smc(fk, N, seed=8, qmc=True)
    out["mv"] = {"logLt": float(res.logLt), "X": res.X}
    return out


def _samplers(device, inp):
    """IBIS (with Moments, a host-side collector and the history),
    adaptive tempering under each ring, NS-SMC and SMC², sharded."""
    model = GaussTarget(data=inp["y_conj"], prior=dists.StructDist(
        {"m": dists.Normal(scale=2.0)}), device=device)
    N = SAMPLER_N
    out = {}
    res = distributed.run_shardmap_smc(
        ssp.IBIS(model=model, len_chain=10), N, seed=1,
        collect=[col.Moments(), ssp.Var_logLt()], store_history=True)
    out["ibis"] = {"logLt": float(res.logLt),
                   "mean": float(res.moments[-1]["mean"]["m"]),
                   "var_logLt": res.var_logLt, "ESSs": res.ESSs,
                   "hist_T": res.hist.T, "hist_N": res.hist.X[-1].N,
                   "X_N": res.X.N}
    for seed in SEEDS:
        res = distributed.run_shardmap_smc(
            ssp.AdaptiveTempering(model=model, len_chain=10), N, seed=seed)
        out[f"tempering_{seed}"] = {
            "logLt": float(res.logLt), "T": len(res.ESSs),
            "exponent": float(res.X.shared["exponent"])}
        res = distributed.run_shardmap_smc(
            nested.NestedSamplingSMC(model=model, len_chain=5, ESSrmin=0.3,
                                     eps=0.01), N, seed=seed)
        out[f"ns_{seed}"] = {"log_evid": float(res.X.shared["log_evid"]),
                             "lt": float(res.X.shared["lt"]),
                             "T": len(res.ESSs)}
    for scheme in ("stratified", "multinomial"):
        res = distributed.run_shardmap_smc(
            ssp.AdaptiveTempering(model=model, len_chain=10), N, seed=4,
            resampling=scheme)
        out[f"tempering_{scheme}"] = {"logLt": float(res.logLt)}
    for seed in range(4):
        fk = ssp.SMC2(ssm_cls=LGfixed, prior=RHO_PRIOR, data=inp["y_smc2"],
                      init_Nx=SMC2_NX, len_chain=4, device=device)
        res = distributed.run_shardmap_smc(fk, SMC2_NTHETA, seed=seed)
        out[f"smc2_{seed}"] = {"logLt": float(res.logLt), "lw": res.lw,
                               "rho": res.X.theta["rho"],
                               "xs": tuple(res.X.xs.shape),
                               "T": len(res.ESSs)}
    return out


def _chains(device, inp):
    """PMMH with its chains over the ranks of a 1-d mesh."""
    mesh = sharded.make_mesh(axis_names=("chains",), device_type=device.type)
    m = mcmc.PMMH(ssm_cls=LGfixed, prior=RHO_PRIOR, data=inp["y_pmmh"],
                  Nx=PMMH_NX, niter=PMMH_NITER, nchains=PMMH_CHAINS, seed=9,
                  mesh=mesh, mesh_axis="chains", device=device)
    m.run()
    return {"rho": m.chain.theta["rho"], "nacc": m.nacc}


def _meshes(device, inp):
    """``run_sharded_smc`` on a (1, 4) mesh with the schemes that have no
    ring, and ``run_sharded_multismc`` on a (2, 2) mesh."""
    ssm = kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    fk = ssms.Bootstrap(ssm=ssm, data=inp["y"], device=device)
    out = {}
    mesh = sharded.make_mesh(4, ("runs", "particles"), (1, 4),
                             device_type=device.type)
    for scheme, seeds in (("ssp", SEEDS), ("residual", (0,)),
                          ("killing", (0,))):
        for seed in seeds:
            calls = _calls()
            res, raw = sharded.run_sharded_smc(
                fk, inp["N"], seed=seed, mesh=mesh, resampling=scheme,
                store_history=seed == 0)
            out[f"{scheme}_{seed}"] = {
                "logLt": float(res.logLt), "rs_flags": res.rs_flags,
                "calls": _since(calls),
                "A": None if raw is None else raw[1]}
    res, _ = sharded.run_sharded_smc(fk, SQMC_N, seed=0, mesh=mesh,
                                     qmc=True)
    out["qmc"] = float(res.logLt)
    mesh2 = sharded.make_mesh(4, ("runs", "particles"), (2, 2),
                              device_type=device.type)
    logLts, lws = sharded.run_sharded_multismc(fk, inp["N"], 4, seed=0,
                                               mesh=mesh2)
    out["multi"] = {"logLts": logLts, "lws": lws}
    constrain = sharded.particle_constrain(mesh)
    x = torch.zeros(8, device=device)
    out["constrain"] = constrain(x, x)[0] is x
    return out


def run_all(device, inputs):
    """Every scenario of one launch of 4 ranks, in a fixed order on every
    rank: the rings on ``inputs[4]`` over the 4 ranks and on ``inputs[2]``
    over a group of ranks 0 and 1, then the engine's scenarios on
    ``inputs[4]``: the filters, sharded FFBS, the raises, distributed
    SQMC and its sort, the samplers, chains across ranks and the mesh
    entry points."""
    inp = inputs[4]
    out = {"rings": {4: _rings(device, inp)}}
    pair = dist.new_group([0, 1])       # every rank takes part in making it
    if dist.get_rank() < 2:
        out["rings"][2] = _rings(device, inputs[2], pair)
    before = _launches()
    out["engine"] = _engine(device, inp)
    after = _launches()
    out["engine_launches"] = {k: after[k] - before[k] for k in after}
    out["ffbs"] = _ffbs(device, inp)
    out["multinomial_counts"] = _multinomial_counts(device, inp)
    out["raises"] = _raises(device, inp)
    out["dqmc"] = _dqmc(device, inp)
    out["sqmc"] = _sqmc(device, inp)
    out["samplers"] = _samplers(device, inp)
    out["chains"] = _chains(device, inp)
    out["meshes"] = _meshes(device, inp)
    return out


def fail_on_rank_1(device):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1, device=device))
    return dist.get_rank()


def hang_on_rank_1(device):
    """Rank 1 never returns; rank 0 returns at once."""
    if dist.get_rank() == 1:
        time.sleep(3600)
    return dist.get_rank()


def card_rings(device, inp):
    """The card tests' rank body: the systematic ring and the merge ring
    on the given global arrays, and a short ``run_shardmap_smc`` per ring
    scheme with the kernels' launches and the run's logLt."""
    D, d = dist.get_world_size(), dist.get_rank()
    x = convert.rank_slice(inp["x"], d, D, device)
    w = convert.rank_slice(inp["w"], d, D, device)
    su = convert.rank_slice(inp["su"], d, D, device)
    u = torch.tensor(inp["u"], device=device)
    N = inp["x"].shape[0]
    out = {"systematic": distributed.ring_systematic_resample(
               x, w, u, N, return_ancestors=True),
           "merge": dqmc.ring_merge_resample(x, su, w, return_ancestors=True),
           "runs": {}}
    ssm = kalman.LinearGauss(rho=0.9, sigmaX=1.0, sigmaY=0.2)
    fk = ssms.Bootstrap(ssm=ssm, data=inp["y"], device=device)
    for scheme in distributed.RING_SCHEMES:
        before = _launches()
        res = distributed.run_shardmap_smc(fk, inp["N_run"], seed=0,
                                           resampling=scheme)
        after = _launches()
        out["runs"][scheme] = {
            "logLt": float(res.logLt), "rs": int(res.rs_flags.sum()),
            "launches": {k: after[k] - before[k] for k in after}}
    return out
