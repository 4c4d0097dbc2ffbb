#!/usr/bin/env python3
"""Where the time of binary SMC and nested sampling goes, at
``chip_smoke.py`` phase 18's shapes, on one CUDA card.

Run from the repository root::

    python3 tools/profile_torch_nested.py [--parts boston,chol,ns_smc,vanilla]
        [--seed S]

- ``boston``: waste-free adaptive tempering with ``BinaryMetropolis`` on
  the expanded Boston design (n = 506, p = 103, dense prior, M = 100, P =
  300) stepped past its step 0: one whole resample-move step (fit, B1, B2,
  299 chain steps, the exponent), then one chain step at M = 100 alone,
  the proposal's draw (``NestedLogistic.rvs_with``, and its column loop
  in two other forms of the same function) and its fit alone.
- ``chol``: ``chol_and_friends`` on that run's N0 = 30,000 particles in
  each of four forms that compute the same function: the shipped one (a
  batched triangular solve, one right-hand side a particle), the last row
  of one (p + 1)-Cholesky of the matrix bordered by X'y (no solve), the
  inverse of the factor times X'y, and the shipped one in a single block;
  each form's largest relative difference from the shipped one.
- ``ns_smc``: NS-SMC on Pima (M = 2^14, P = 64, N0 = 2^20) stepped past
  its step 0: one level.
- ``vanilla``: vanilla NS on Pima (N = 300, nsteps = 8): a chunk of 10
  contractions, reported a contraction.

For each unit a ``torch.profiler`` window gives the device ms by CUDA
kernel and the CUDA kernels; the same unit timed again (the clock stopped
after the device) gives its wall ms; the busy share is device over wall.
A sampler step is replayed from a checkpoint for its window and its
clock, so both read the same step.
A window whose every try drops kernels is None (not measured).  Prints
the card's name and power limit, then one JSON line (with the seconds each
part took).  ``chip_smoke.py`` phase 18 runs it in a fresh process.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _measure(torch, cs, fn, calls=1, top=8):
    """Device ms and CUDA kernels of a call of ``fn`` (a profiler window of
    one call after one to warm up: a window of many calls drops kernels),
    wall ms a call over ``calls`` calls, and the busy share."""
    try:
        by_kernel, per_call = cs._device_window(torch, fn, 1)
        device_ms = sum(by_kernel.values())
    except AssertionError as err:
        print(f"{err}; not measured", file=sys.stderr, flush=True)
        by_kernel = per_call = device_ms = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1000.0 * (time.perf_counter() - t0) / calls
    return {"device_ms": device_ms, "cuda_kernels": per_call,
            "wall_ms": wall_ms,
            "busy_share": None if device_ms is None else device_ms / wall_ms,
            "largest_kernels_ms": None if by_kernel is None else dict(
                sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top])}


def _replay_step(torch, pf, top=8, tries=5):
    """One step of ``pf`` replayed from a checkpoint (``save_state``,
    ``load_state``, the load outside the window and the clock): its device
    ms by CUDA kernel and CUDA kernels from a profiler window that records
    the device alone (a Boston step is ~130,000 kernels: with the host's
    operators too, reading the window takes over a minute), then its wall
    ms.  ``pf`` ends one step on."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(tempfile.mkdtemp(), "step.pt")
    pf.save_state(path)
    by_kernel = n = None
    for k in range(tries):
        pf.load_state(path)
        torch.cuda.synchronize()
        # after two empty windows, record the host's operators too
        acts = [ProfilerActivity.CUDA] if k < 2 else [ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA]
        try:
            with profile(activities=acts) as prof:
                next(pf)
                torch.cuda.synchronize()
        except AssertionError:          # no device activity to record
            continue
        by, count = {}, 0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                name = evt.key[:100]
                by[name] = by.get(name, 0.0) + evt.self_device_time_total / 1e3
                count += evt.count
        if count > 0:
            by_kernel, n = by, count
            break
    pf.load_state(path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    next(pf)
    torch.cuda.synchronize()
    wall_ms = 1000.0 * (time.perf_counter() - t0)
    device_ms = None if by_kernel is None else sum(by_kernel.values())
    return {"device_ms": device_ms, "cuda_kernels": n, "wall_ms": wall_ms,
            "busy_share": None if device_ms is None else device_ms / wall_ms,
            "largest_kernels_ms": None if by_kernel is None else dict(
                sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top])}


def _boston_run(torch, cs, dev, seed):
    """The dense Boston run after its first resample-move: (pf, model)."""
    from particles_tpu_torch import binary_smc as bs
    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import smc_samplers as ssp
    from particles_tpu_torch.core import SMC

    X, y, _, _ = cs.boston_data()
    prior = dists.StructDist({"gamma": dists.IID(bs.Bernoulli(0.5),
                                                 X.shape[1])})
    model = bs.BayesianVS(data=(torch.from_numpy(X).to(dev),
                                torch.from_numpy(y).to(dev)), prior=prior)
    move = ssp.MCMCSequenceWF(mcmc=bs.BinaryMetropolis(),
                              len_chain=cs.BOSTON_P)
    pf = SMC(fk=ssp.AdaptiveTempering(model=model, len_chain=cs.BOSTON_P,
                                      move=move), N=cs.BOSTON_M, seed=seed)
    next(pf)
    return pf, model


def profile_boston(torch, cs, dev, seed, run):
    pf, _ = run
    fk = pf.fk
    out = {"M": cs.BOSTON_M, "P": cs.BOSTON_P, "N0": pf.X.N,
           "first_step": pf.t}
    out["step"] = _replay_step(torch, pf)
    # one chain step at M = 100, on the cloud's first M particles
    Xc = pf.X.with_shared(**fk.move.calibrate(pf.wgts.W, pf.X))
    x = Xc.subset(torch.arange(cs.BOSTON_M, device=dev))
    target = fk.move_target(pf.t, Xc)
    mcmc = fk.move.mcmc
    gen = torch.Generator(device=dev).manual_seed(seed)
    out["chain_step"] = _measure(
        torch, cs, lambda: mcmc.step(gen, x, target), calls=20)
    from particles_tpu_torch import binary_smc as bs
    prop = bs.NestedLogistic(Xc.shared["prop_coeffs"],
                             Xc.shared["prop_edgy"])
    u = torch.rand((cs.BOSTON_M, prop.dim), generator=gen, device=dev)
    out["proposal_draw"] = _measure(torch, cs, lambda: prop.rvs_with(u),
                                    calls=20)
    # the draw's column loop in two other forms of the same function: the
    # test u < sigmoid(lin) (three kernels a column), and the product as
    # an elementwise product and a sum (no cuBLAS call)
    for name, form in (("sigmoid test", _draw_sigmoid),
                       ("product and sum", _draw_product_sum)):
        rec = _measure(torch, cs, lambda form=form: form(torch, prop, u),
                       calls=20)
        rec["draws_differ"] = int((form(torch, prop, u)
                                   != prop.rvs_with(u)).sum())
        out[f"proposal_draw, {name}"] = rec
    out["fit"] = _measure(torch, cs, lambda: bs.NestedLogistic.fit(
        pf.wgts.W, pf.X.theta["gamma"]), calls=5)
    return out


def _draw_sigmoid(torch, prop, u):
    u = torch.where(prop.edgy, torch.where(u < prop._diag, -1.0, 2.0),
                    u).T.contiguous()
    out = torch.zeros_like(u)
    for i in range(prop.dim):
        p = torch.sigmoid(torch.addmv(prop._diag[i], out.T, prop._lower[i]))
        torch.gt(p, u[i], out=out[i])
    return out.T.contiguous().bool()


def _draw_product_sum(torch, prop, u):
    thresh = torch.where(
        prop.edgy, torch.where(u < prop._diag, -torch.inf, torch.inf),
        torch.logit(u)).T.contiguous()
    out = torch.zeros_like(thresh)
    for i in range(prop.dim):
        lin = (out * prop._lower[i][:, None]).sum(0) + prop._diag[i]
        torch.gt(lin, thresh[i], out=out[i])
    return out.T.contiguous().bool()


def _augmented_block(torch):
    def block(gamma, xtx, xty, vm2):
        gf = gamma.float()
        N, p = gf.shape
        A = gf.new_zeros((N, p + 1, p + 1))
        A[:, :p, :p] = xtx[None] * gf[:, :, None] * gf[:, None, :]
        A[:, :p, :p].diagonal(dim1=1, dim2=2).add_(gf * vm2 + (1.0 - gf))
        r = xty[None, :] * gf
        A[:, p, :p] = r
        A[:, :p, p] = r
        A[:, p, p] = 2.0 ** 100
        C = torch.linalg.cholesky_ex(A)[0]
        ldet = torch.log(torch.diagonal(C, dim1=1, dim2=2)[:, :p]).sum(1)
        return gf.sum(1), ldet, (C[:, p, :p] ** 2).sum(1)

    return block


def _inverse_block(torch):
    def block(gamma, xtx, xty, vm2):
        gf = gamma.float()
        N, p = gf.shape
        A = xtx[None] * gf[:, :, None]
        A *= gf[:, None, :]
        A.diagonal(dim1=1, dim2=2).add_(gf * vm2 + (1.0 - gf))
        C = torch.linalg.cholesky_ex(A)[0]
        ldet = torch.log(torch.diagonal(C, dim1=1, dim2=2)).sum(1)
        eye = torch.eye(p, dtype=C.dtype, device=C.device).expand(N, p, p)
        Cinv = torch.linalg.solve_triangular(C, eye, upper=False)
        w = Cinv @ (xty[None, :] * gf)[:, :, None]
        return gf.sum(1), ldet, (w[:, :, 0] ** 2).sum(1)

    return block


def profile_chol(torch, cs, dev, run):
    from particles_tpu_torch import binary_smc as bs

    pf, model = run
    gamma = pf.X.theta["gamma"]
    shipped_block, shipped_chunk = bs._chol_block, bs.CHOL_CHUNK

    def call():
        return bs.chol_and_friends(gamma, model.xtx, model.xty, model.iv2)

    ref = call()
    forms = {"shipped (triangular solve)": (shipped_block, shipped_chunk),
             "bordered (p + 1)-Cholesky": (_augmented_block(torch),
                                           shipped_chunk),
             "inverse of the factor": (_inverse_block(torch), shipped_chunk),
             "shipped, one block": (shipped_block, 2 ** 40)}
    out = {"N0": gamma.shape[0], "p": gamma.shape[1], "forms": {}}
    try:
        for name, (block, chunk) in forms.items():
            bs._chol_block, bs.CHOL_CHUNK = block, chunk
            torch.cuda.reset_peak_memory_stats()
            res = call()
            torch.cuda.synchronize()
            diff = {k: float(((a - b).abs() / b.abs().clamp(min=1e-30))
                             .max()) for k, a, b in zip(
                                 ("ldet", "wtw"), res[1:], ref[1:])}
            rec = _measure(torch, cs, call, calls=5)
            rec.update(max_rel_diff_from_shipped=diff,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            out["forms"][name] = rec
    finally:
        bs._chol_block, bs.CHOL_CHUNK = shipped_block, shipped_chunk
    return out


def profile_ns_smc(torch, cs, dev, seed):
    from particles_tpu_torch import nested
    from particles_tpu_torch.core import SMC

    pima, _ = cs.logistic_model(torch, dev, "Pima")
    pf = SMC(fk=nested.NestedSamplingSMC(model=pima, len_chain=cs.P_SAMPLER,
                                         ESSrmin=cs.NS_ESSRMIN),
             N=cs.N_SAMPLER, seed=seed)
    next(pf)
    out = {"M": cs.N_SAMPLER, "P": cs.P_SAMPLER, "N0": pf.X.N,
           "first_level": pf.t}
    out["level"] = _replay_step(torch, pf)
    return out


def profile_vanilla(torch, cs, dev, seed, K=10):
    from particles_tpu_torch import nested

    pima, _ = cs.logistic_model(torch, dev, "Pima")
    ns = nested.Nested_RWmoves(model=pima, N=cs.VANILLA_PIMA_N,
                               nsteps=cs.VANILLA_PIMA_NSTEPS, seed=seed)
    ns.setup()
    lZ = torch.full((), -torch.inf, device=dev)
    i0 = [0]

    def chunk():
        ns._chunk(ns.arr, ns.lprior, ns.llik, lZ, i0[0], K,
                  ns.draws(ns.gen, K))
        i0[0] += K

    rec = _measure(torch, cs, chunk)
    per = {k: (None if rec[k] is None else rec[k] / K)
           for k in ("device_ms", "cuda_kernels", "wall_ms")}
    return {"N": cs.VANILLA_PIMA_N, "nsteps": cs.VANILLA_PIMA_NSTEPS,
            "contractions_a_window": K, "per_contraction": per,
            "busy_share": rec["busy_share"],
            "largest_kernels_ms_a_chunk": rec["largest_kernels_ms"]}


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parts", default="boston,chol,ns_smc,vanilla")
    parser.add_argument("--seed", type=int, default=18)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_nested: needs a CUDA card")
    import chip_smoke as cs
    from particles_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _build.build()
    dev = torch.device("cuda", 0)
    parts = args.parts.split(",")
    out = {"nvidia_smi": smi}
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t0

    run = None
    if "boston" in parts or "chol" in parts:
        t0 = time.perf_counter()
        run = _boston_run(torch, cs, dev, args.seed)
        seconds["boston_run"] = time.perf_counter() - t0
    if "boston" in parts:
        timed("boston", lambda: profile_boston(torch, cs, dev, args.seed,
                                               run))
    if "chol" in parts:
        timed("chol", lambda: profile_chol(torch, cs, dev, run))
    del run
    if "ns_smc" in parts:
        timed("ns_smc", lambda: profile_ns_smc(torch, cs, dev, args.seed))
    if "vanilla" in parts:
        timed("vanilla", lambda: profile_vanilla(torch, cs, dev, args.seed))
    out["seconds"] = seconds
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
