#!/usr/bin/env python3
"""Drive the PyTorch port (``particles_tpu_torch``) on one NVIDIA GPU and
check every kernel of its main path against its plain version.

Run from the repository root, on a machine with a CUDA card and nvcc::

    python3 chip_smoke.py

It builds the kernels from ``particles_tpu_torch/csrc`` at first use and
prints one JSON line per phase; any failure raises, so the exit code is
not 0 and no result line is printed.  It exits with an error at once when
``torch.cuda.is_available()`` is False.

1. Device and build: the card's name and power limit, versions, nvcc
   seconds (every ``csrc/*.cu`` compiled at once).
2. Kernel B1 (systematic z-form) on the card against its plain version
   and a float64 oracle, N in {1, 7, 1000, 2^20 - 513, 2^20}, Dirichlet(1),
   Dirichlet(0.05) and near-degenerate weights, u in {0, 0.37, 0.999}.
   Tolerance: z nondecreasing, ``z[-1] == M``, ``0 <= z <= M``, and
   ``|z - plain| <= 1``, ``|z - oracle| <= 1`` elementwise (the float sum
   S is taken in another order; the fixed-point cumsum keeps z within one
   of the exact answer).
3. Kernel B2 (resampling move) against its plain version, exact: f32, f64,
   int32 >= 2^24, int64, int8, (N, 2) f32 and (N, 3) f16 payloads, the
   fused form with ancestors, ancestors alone, more payloads than one
   launch takes, and M != N.
4. The main path: ``SMC(Bootstrap(LinearGauss(rho=0.9, sigmaX=1,
   sigmaY=0.2), y), N=2^20).run()`` for T=1000 on the card; logLt finite
   and within 0.5 of the float64 Kalman logLt (its standard deviation is
   about sqrt(T * 2.7 / N) = 0.05); each kernel launched once per
   resampling step.  Two runs, the second warm and timed.
5. Kernel and plain-version times at N = 2^20 (CUDA events, median of 25
   batches of 10 calls), then the kernels line and the result line.
"""

import json
import subprocess
import sys
import time

import numpy as np

N_MAIN = 2 ** 20
T_MAIN = 1000
RHO, SIGX, SIGY = 0.9, 1.0, 0.2
LOGLT_TOL = 0.5


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _dirichlet_like(rng, kind, N):
    if kind == "dirichlet1":
        g = rng.standard_gamma(1.0, N)
    elif kind == "dirichlet0.05":
        g = rng.standard_gamma(0.05, N)
    else:  # near-degenerate: one weight ~ 1
        g = np.full(N, 1e-12)
        g[rng.integers(N)] = 1.0
    return (g / g.sum()).astype(np.float32)


def _oracle_z(W, u, M):
    W64 = W.astype(np.float64)
    cs = np.cumsum(W64) / W64.sum()
    z = np.clip(np.floor(M * cs - np.float64(np.float32(u))) + 1, 0, M)
    z = z.astype(np.int64)
    z[-1] = M
    return z


def _simulate_y(T):
    """Observations of the main path's model, from a numpy seed."""
    rng = np.random.default_rng(1)
    xs = np.empty(T)
    xs[0] = rng.normal() * SIGX / np.sqrt(1 - RHO ** 2)
    for t in range(1, T):
        xs[t] = RHO * xs[t - 1] + SIGX * rng.normal()
    return (xs + SIGY * rng.normal(size=T)).astype(np.float32)


def _time_ms(torch, fn, batches=25, per_batch=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per_batch)
    return float(np.median(samples))


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script needs a CUDA card")
    from particles_tpu_torch import _build, kalman, ops
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.core import SMC

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build()
    build_wall = time.perf_counter() - t0
    for name, log in _build.build_log.items():
        print(f"--- nvcc {name}.cu ---\n{log}", file=sys.stderr)
    _emit({"phase": 1, "device": kind, "count": torch.cuda.device_count(),
           "nvidia_smi": smi, "python": sys.version.split()[0],
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "nvcc_seconds": _build.build_seconds,
           "build_wall_seconds": build_wall})

    # -- 2. B1 against its plain version and a float64 oracle ---------------
    rng = np.random.default_rng(0)
    Ns = [1, 7, 1000, N_MAIN - 513, N_MAIN]
    kinds = ["dirichlet1", "dirichlet0.05", "degenerate"]
    us = [0.0, 0.37, 0.999]
    zs = {}
    err_plain = err_oracle = 0
    n_differ = n_cases = 0
    cases = [(N, N, k, u) for N in Ns for k in kinds for u in us]
    cases.append((1000, 501, "dirichlet1", 0.37))   # M != N
    for N, M, wkind, u in cases:
        W_np = _dirichlet_like(rng, wkind, N)
        W = torch.from_numpy(W_np).to(dev)
        ut = torch.tensor(u, dtype=torch.float32, device=dev)
        z = ops.systematic_z_fused(W, ut, M)
        zp = ops.systematic_z_plain(W, ut, M)
        torch.cuda.synchronize()
        zc = z.cpu().numpy().astype(np.int64)
        zpc = zp.cpu().numpy().astype(np.int64)
        zo = _oracle_z(W_np, u, M)
        tag = f"B1 N={N} M={M} {wkind} u={u}"
        _check(z.dtype == torch.int32 and zc.shape == (N,), f"{tag}: shape")
        _check(bool(np.all(np.diff(zc) >= 0)), f"{tag}: not nondecreasing")
        _check(zc[-1] == M and zc.min() >= 0 and zc.max() <= M,
               f"{tag}: range")
        dp = int(np.abs(zc - zpc).max())
        do = int(np.abs(zc - zo).max())
        _check(dp <= 1, f"{tag}: |z - plain| = {dp} > 1")
        _check(do <= 1, f"{tag}: |z - oracle| = {do} > 1")
        err_plain, err_oracle = max(err_plain, dp), max(err_oracle, do)
        n_differ += int(np.count_nonzero(zc != zpc))
        n_cases += 1
        if (wkind == "dirichlet0.05" and u == 0.37) or M != N:
            zs[(N, M)] = z
    _emit({"phase": 2, "kernel": "systematic_z", "cases": n_cases,
           "max_abs_err_vs_plain": err_plain,
           "max_abs_err_vs_float64": err_oracle,
           "elements_differing_from_plain": n_differ,
           "tolerance": "|dz| <= 1 elementwise"})

    # -- 3. B2 against its plain version, exact -----------------------------
    b2_err = 0.0
    n_cases = 0
    for (N, M), z in zs.items():
        cols = [
            torch.randn(N, device=dev),
            torch.randn(N, device=dev, dtype=torch.float64),
            torch.randint(2 ** 24, 2 ** 31 - 1, (N,), device=dev,
                          dtype=torch.int32),
            torch.randint(-2 ** 62, 2 ** 62, (N,), device=dev,
                          dtype=torch.int64),
            torch.randint(-128, 127, (N,), device=dev, dtype=torch.int8),
            torch.randn(N, 2, device=dev),
            torch.randn(N, 3, device=dev).to(torch.float16),
        ]
        forms = [
            ("fused+anc", ops.repeat_cols(z, M, cols, want_anc=True),
             ops.repeat_cols_plain(z, M, cols, want_anc=True)),
            ("anc only", ([], ops.ancestors_by_z(z, M)),
             ops.repeat_cols_plain(z, M, [], want_anc=True)),
        ]
        many = [torch.randn(N, device=dev)
                for _ in range(ops.MAX_PAYLOADS + 2)]
        forms.append(("two launches", ops.repeat_cols(z, M, many),
                      ops.repeat_cols_plain(z, M, many)))
        torch.cuda.synchronize()
        for form, (ys, A), (yps, Ap) in forms:
            tag = f"B2 N={N} M={M} {form}"
            for y, yp in zip(ys, yps, strict=True):
                _check(y.dtype == yp.dtype and y.shape == yp.shape,
                       f"{tag}: {y.dtype}{tuple(y.shape)} vs "
                       f"{yp.dtype}{tuple(yp.shape)}")
                d = float((y.double() - yp.double()).abs().max())
                b2_err = max(b2_err, d)
                _check(torch.equal(y, yp), f"{tag}: {y.dtype} payload "
                                           f"differs (max {d})")
            if Ap is not None:
                _check(A is not None and A.dtype == torch.int64
                       and torch.equal(A, Ap), f"{tag}: ancestors differ")
            n_cases += 1
    _emit({"phase": 3, "kernel": "repeat_by_z", "cases": n_cases,
           "max_abs_err_vs_plain": b2_err, "tolerance": "exact"})

    # -- 4. the main path at full width --------------------------------------
    y = _simulate_y(T_MAIN)
    ssm = kalman.LinearGauss(rho=RHO, sigmaX=SIGX, sigmaY=SIGY)
    fk = ssms.Bootstrap(ssm=ssm, data=torch.from_numpy(y).to(dev))
    kf_logLt = float(kalman.Kalman(
        ssm=ssm, data=torch.from_numpy(y.astype(np.float64))).logLt)

    def main_path(seed):
        ops.systematic_z_fused.launches = 0
        ops.repeat_cols.launches = 0
        pf = SMC(fk=fk, N=N_MAIN, seed=seed)
        pf.run()
        launches = {"systematic_z": ops.systematic_z_fused.launches,
                    "repeat_by_z": ops.repeat_cols.launches}
        n_rs = int(pf.summaries.rs_flags.sum())
        logLt = float(pf.logLt)
        _check(np.isfinite(logLt), f"main path seed {seed}: logLt {logLt}")
        _check(abs(logLt - kf_logLt) < LOGLT_TOL,
               f"main path seed {seed}: |logLt - Kalman| = "
               f"{abs(logLt - kf_logLt)} >= {LOGLT_TOL}")
        for name, n in launches.items():
            _check(n == n_rs and n > 0,
                   f"main path seed {seed}: {name} launched {n} times, "
                   f"{n_rs} resampling steps")
        _check(pf.X.shape == (N_MAIN,) and bool(torch.isfinite(pf.X).all()),
               f"main path seed {seed}: final particles")
        for s in ("ESSs", "logLts", "rs_flags"):
            _check(getattr(pf.summaries, s).shape == (T_MAIN,),
                   f"main path seed {seed}: summaries.{s}")
        return pf, launches, n_rs, logLt

    _, launches, n_rs, logLt0 = main_path(0)
    pf1, launches1, n_rs1, logLt1 = main_path(1)
    wall = pf1.cpu_time
    _emit({"phase": 4, "N": N_MAIN, "T": T_MAIN, "logLt": logLt0,
           "logLt_warm_run": logLt1, "kalman_logLt": kf_logLt,
           "abs_diff": abs(logLt0 - kf_logLt), "tolerance": LOGLT_TOL,
           "resampling_steps": n_rs, "launches": launches,
           "resampling_steps_warm_run": n_rs1,
           "launches_warm_run": launches1,
           "warm_wall_s": wall, "particle_steps_per_s": N_MAIN * T_MAIN / wall,
           "ms_per_step": 1000.0 * wall / T_MAIN})

    # -- 5. kernel times ----------------------------------------------------
    W = torch.from_numpy(_dirichlet_like(rng, "dirichlet1", N_MAIN)).to(dev)
    u = torch.tensor(0.37, dtype=torch.float32, device=dev)
    z = ops.systematic_z_fused(W, u, N_MAIN)
    x = torch.randn(N_MAIN, device=dev)
    times = {
        "systematic_z": (
            _time_ms(torch, lambda: ops.systematic_z_fused(W, u, N_MAIN)),
            _time_ms(torch, lambda: ops.systematic_z_plain(W, u, N_MAIN))),
        "repeat_by_z": (
            _time_ms(torch, lambda: ops.repeat_cols(z, N_MAIN, [x])),
            _time_ms(torch, lambda: ops.repeat_cols_plain(z, N_MAIN, [x]))),
    }
    meta = {
        "systematic_z": ("particles_tpu_torch/csrc/z_kernel.cu",
                         "particles_tpu/ops/z_kernel.py:93", err_plain),
        "repeat_by_z": ("particles_tpu_torch/csrc/repeat_kernel.cu",
                        "particles_tpu/ops/repeat_kernel.py:70", b2_err),
    }
    kernels = []
    for name, (ms, plain_ms) in times.items():
        source, replaces, err = meta[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "max_err": err, "ms": ms,
                        "kernel_ms": ms, "plain_ms": plain_ms})
    _emit({"phase": 5, "N": N_MAIN, "nvidia_smi": smi,
           "timing": "CUDA events, median of 25 batches of 10 calls"})
    _emit({"kernels": kernels})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
