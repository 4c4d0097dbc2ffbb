#!/usr/bin/env python3
"""Drive the PyTorch port (``particles_tpu_torch``) on one NVIDIA GPU and
check every kernel of its paths against its plain version.

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
   of the exact answer).  On weights k_i 2^-24 (k_i < 256: S exact in
   double in any order) at N = 2^20 and 2^24, M = N and 4N, z equals the
   plain version bit for bit.  Then, with each u, strained cases: N one
   past a tile, one past the largest one-tile chunk, one past what shared
   memory holds, and 2^24; all weight on one particle (first, middle,
   last), weights mostly zero and S = 4e-30 at N = 2^20; M = 4N at
   N = 2^20 - 513 and 2^24 and on degenerate weights.  Above N = 2^20 and at M = 4N the
   fixed-point grid (2^-30 of the total a weight) puts the function itself
   more than 1 from float64, so there z is held within 1 of the plain
   version and no further from the oracle than the plain version is, plus
   1.
3. Kernel B2 (resampling move) against its plain version, exact: f32, f64,
   int32 >= 2^24, int64, int8, (N, 2) f32 and (N, 3) f16 payloads, the
   fused form with ancestors, ancestors alone, more payloads than one
   launch takes, and M != N; then counts built to strain the merge path
   (N = 2^20 - 513, not a multiple of a block's items): all offspring on
   the first, a middle or the last particle, counts all 1, zero counts in
   runs longer than a block's items, N = 1, M = 1, N/2 + 1 and 4N, and
   N, M both unaligned and small.
4. The main path: ``SMC(Bootstrap(LinearGauss(rho=0.9, sigmaX=1,
   sigmaY=0.2), y), N=2^20).run()`` for T=1000 on the card; logLt finite
   and within 0.5 of the float64 Kalman logLt (its standard deviation is
   about sqrt(T * 2.7 / N) = 0.05); each kernel launched once per
   resampling step.  Two runs, the second warm and timed.
5. Kernel B3 (monotone normalised cumsum) against its plain version and a
   float64 oracle, at phase 2's sizes and weights, then at N one past a
   tile, one past the largest one-tile chunk, one past what shared memory
   holds, and 2^24, and at N = 2^20 on all weight on one particle
   (first, middle, last), weights that are mostly zero, and a sum S just
   above 2^30 / FLT_MAX (the least S with a finite scale): nondecreasing,
   ``|cs[-1] - 1| < 1e-6``, within N 2^-31 + 1e-6 of both; and bit for bit
   equal to the plain version on phase 2's exact-sum weights.
6. Kernel B5 (sorted-merge rank count) against its plain version, exact:
   sorted uniforms, uniforms tied with cs values, L = 2N + 1 and L = N/2 + 1
   uniforms; then, at N = 2^20 - 513 (not a multiple of a block's tile),
   all weight on one particle (first, middle, last), one block's window of
   uniforms one past and four times what shared memory holds, residual's
   tail of 2.0 and L = 1; and on uniforms one ulp out of order, z
   nondecreasing and each z_i a binary search's answer (``su[z_i - 1] <=
   cs_i < su[z_i]``).
7. Kernel B4 (move by the inverse CDF) against its plain version, exact:
   unsorted and sorted uniforms, M = 4N, phase 3's payloads, the fused
   form with ancestors and ancestors alone; then, at N = 2^20 - 513, all
   weight on one particle (first, middle, last), degenerate weights,
   uniforms tied with cs values, uniforms at 0, an ulp below the top,
   negative and past the top, an integer cs served at idx + 0.5, cs[-1] =
   0 (a constant bucket function) and M = 4N.
8. Kernel B6 (running max) against ``torch.cummax``, exact: int32 over
   the whole range (negative values) at phase 2's N and its chunk-edge
   sizes and 2^24, and above N = 1000 also all INT_MIN and a descending
   input.
9. Every resampling scheme: ``multiSMC(fk, N=2^20, resampling=[six
   schemes], nruns=1)`` for T=1000 with numpy data and no device (so the
   port's default puts it on the card), after a warm-up at T=20.  Each
   logLt within 0.5 of Kalman; each kernel launched once per resampling
   step in its scheme's combination (systematic B1+B2, stratified B3+B2,
   multinomial and residual B6+B3+B5+B2, ssp B2, killing B3+B4; every
   CDF the port builds is monotone by construction, and B6 sorts the
   spacings' float cumsum, ROADMAP C.13).  The multinomial and residual
   runs again, every B5 call held against its plain version on the run's
   own uniforms, exact.  Then ``idiotic`` at T=50: it runs and launches no
   kernel.
10. Kernel times at N = 2^20 (CUDA events, median of 25 batches of 10
    calls) beside the plain version's, the one PyTorch call that computes
    the same function where there is one, and the bound; each kernel's and
    library call's device time (``device_ms``: the sum of its CUDA
    kernels' time in a ``torch.profiler`` window of 20 calls, per call) and
    CUDA kernels per call (``launches_per_call``: 1 for B1, B2, B3, B5 and
    B6, 2 for B4); B2, B4 and B5 also on the degenerate weights the filter gives
    them, B4 also on sorted uniforms.
11. History and genealogy on the main path: N = 2^20, T = 1000,
    ``store_history=16`` and ``collect=[Fixed_lag_smooth(lag=5),
    Online_smooth_naive()]`` on the model with the additive function x_t.
    logLt within 0.5 of Kalman; B1 and B2 launched once a resampling step
    and no other kernel; one host sync a step (counted with
    ``torch.cuda.set_sync_debug_mode("warn")``); every resampling step's
    ancestors returned (by B2) and nondecreasing; the window's 16 frames
    and its trajectories equal to a numpy recomposition of its ancestors;
    the fixed-lag and on-line means within 5 sd of the exact targets
    (``kalman_targets``; each smoother's sd from
    ``tools/smoothing_error_scale.py``, ``SMOOTH_SD``).  ms a step of a
    warm run beside phase 4's.
12. Off-line smoothing at N = 2^17, T = 128 (``store_history=True``):
    FFBS-MCMC (one step) and hybrid rejection FFBS (32 rounds, then the
    exact kernel) at M = 2^17, two-filter O(N) at 2^17, FFBS O(N^2) and
    two-filter O(N^2) at N = M = 2^13.  Each smoothed mean within 5 sd of
    the Kalman smoother at every t; B3 launched once per set of weights
    drawn from (its CDF: 1 + 127 a pass for MCMC and reject, 2 a time
    step for two-filter O(N), 1 for FFBS O(N^2)) and B4 once per draw (1 +
    the MCMC steps, or rounds), the O(N^2) two-filter none.  Then each
    kernel on the phase's own inputs, with phases 2, 3, 5 and 7's
    tolerances: B1 and B2 (with and without ancestors) on the forward
    weights and particles at 2^17 and 2^13 (t = 0, 64, 126), B3 and B4 on
    the same with M in {2N, N, N/2 + 1, 37, 1} (PaRIS's first round to a
    last straggler), and on the information filter's weights.  ms a
    backward step, launches, rounds and stragglers.
13. On-line smoothing at T = 128: PaRIS (``Nparis=2``, 32 rounds) at N =
    2^17 and ``Online_smooth_ON2`` at 2^13 within 5 sd of the exact
    targets, PaRIS's B3 launched once a step and B4 once a round; ``Var``,
    ``Var_logLt`` and ``Lag_based_var`` at 2^17 and 256 finite and >= 0,
    and ``Var`` and ``Lag_based_var`` 0 wherever the genealogy has
    coalesced (recomputed from the history; at N = 256 it must coalesce).
    Each kernel on the phase's own inputs, as in phase 12: PaRIS's last
    weights and particles (B1 to B4), ``Online_smooth_ON2``'s and the
    variance estimators' (B1, B2).  ms a step with each collector beside
    the filter alone, and PaRIS's rounds a step.
14. The guided and auxiliary filters and the zoo, through ``SMC`` and
    ``multiSMC``: ``GuidedPF``, ``AuxiliaryPF`` and ``AuxiliaryBootstrap``
    on phase 4's model and data (N = 2^20, T = 1000, ESSrmin = 0.5), each
    logLt within 0.5 of the float64 Kalman logLt; ``Bootstrap`` on a
    three-state ``GaussianHMM`` (N = 2^20, T = 1000), within 0.5 of the
    float64 ``BaumWelch`` logLt; ``StochVol()`` at the JAX package's APF
    shape (N = 2^20, T = 100, ESSrmin = 1.1, data simulated from a numpy
    seed), ``AuxiliaryPF`` and ``AuxiliaryBootstrap`` each within 5 sd of
    ``Bootstrap`` (each sd the spread of the filter's logLt over 8 seeds);
    on data with a large observation (ROADMAP C.7: simulated on the CPU
    from generator seed 0, |y| 2.41), where an auxiliary run now and then
    collapses in both packages, the median of 8 ``AuxiliaryPF`` runs
    within 5 sd of the median of 8 ``Bootstrap`` runs (the sd the hypot of
    the bootstrap's and AuxiliaryPF's 1.4826 MAD), ``AuxiliaryBootstrap``
    recorded.
    In each of these runs B1 and B2 launched once a resampling step and no
    other kernel; B1 and B2 held to their plain versions (phases 2 and
    3's tolerances) on the weights B1 got, the auxiliary ones for an APF,
    and the particles B2 moved, at t = 1, T/2 and T - 1 (the HMM's int64
    states among them), and on ``BearingsOnly``'s (N, 4) rows.  Every
    other zoo model (``StochVol``, ``StochVolLeverage``, ``Gordon_etal``,
    ``BearingsOnly``, ``DiscreteCox``, ``MVStochVol``, ``ThetaLogistic``,
    and the guided or auxiliary filters of those with proposals) at N =
    2^16, T = 100 through ``multiSMC`` over the six schemes: logLt finite,
    each kernel launched once a resampling step in its scheme's
    combination.  ms a step of a warm run beside phase 4's.

15. SQMC (``SQMC`` through the iterator protocol) on phase 4's model and
    data (N = 2^20, T = 1000): logLt within 0.5 of Kalman; B3 and B4
    launched once a step (999 each) and no other kernel; no host sync in
    the 999 steps (counted as in phase 11); the last particles finite and
    sorted (the 1-d Hilbert order).  B3 (phase 5's tolerance) and B4
    (exact, with the particles as payload) held to their plain versions
    on the weights and sorted points of t = 1, T/2 and T - 1.  The sd of
    logLt over 8 seeds at N = 2^16 below the bootstrap filter's at the
    same N and T.  ``MVLinearGauss_Guarniero_etal`` with dx = 2 and 3 (the
    Hilbert keys), N = 2^20, T = 100, within 0.5 of Kalman.
    ``multiSMC(qmc=True)`` over 4 runs, each within 0.5 of Kalman.  QMC
    FFBS from an SQMC history (N = 2^14, M = 2^12, T = 100, 8 seeds):
    each smoothed mean within 5 sd of the float64 Kalman smoother at every
    t, the sd from the spread over the seeds; B3 and B4 once a pass.  The
    card's Sobol points (every scramble and the sorted set) and Hilbert
    keys equal the CPU's bit for bit.  ms a step of a warm run beside
    phase 4's, ms a QMC FFBS pass; from ``tools/profile_torch_sqmc.py``,
    run in a fresh process, ``torch.profiler`` windows of 20 calls: device
    ms a step by CUDA kernel and the CUDA kernels a step, B3 and B4 on the
    main run's inputs of t = T/2, the Sobol draw and the Hilbert sort.

16. The SMC samplers (``SMC`` with ``smc_samplers.IBIS``, ``Tempering``
    and ``AdaptiveTempering``), waste-free at M = 2^14 starting points, P
    = 64 (N0 = 2^20).  The conjugate Gaussian mean of the JAX package's
    tests (T = 30, y from numpy seed 0): each logLt within 0.5 of the
    exact evidence (scipy, y ~ N(0, I + 11^T)) and in units of its
    spread over 8 seeds at N0 = 2^16; the posterior mean within 5 of
    those sd of the exact one.  ``AdaptiveTempering(wastefree=False)``
    with ``AdaptiveMCMCSequence(adaptive=True)`` at N = 2^16.  Pima
    logistic regression (``AdaptiveTempering``) at the JAX package's
    shape (N = 100, len_chain = 30) and at M = 2^14, P = 64: logLt within
    3.0 of the path-sampling estimate and the posterior mean within 0.3
    of the Newton MAP (the example's checks).  Sonar (d = 61) at M = 2^14,
    P = 64: logLt and path sampling finite.  Under ``systematic`` B1 once
    and B2 ceil(leaves / 8) times a resampling step and no other kernel;
    ``multiSMC`` with ``stratified`` (B3, B2) and ``multinomial`` (B3,
    B5, B2) at N0 = 2^16 within 0.5 of exact.  Host syncs counted as in
    phase 11: one a step (the decision; ``done``'s test for
    AdaptiveTempering, plus the read that ends the run), plus one a chain
    step but a move's last for the adaptive move.  B1 (phase 2's
    tolerance) and B2 (exact) on the Pima 2^20 run's own N0 weights and
    served leaves at its first, a middle and its last resampling step.
    ms a step of a warm run beside phase 4's (Sonar's counted run), the
    steps, acceptance rates, bytes served a resampling step; from
    ``tools/profile_torch_samplers.py``, run in a fresh process, device ms
    a step by CUDA kernel, CUDA kernels a step and the busy share.

17. The outer loops over a filter.  SMC² (``smc_samplers.SMC2``) on
    ``StochVolLeverage`` over the GBP/USD series (T = 751), Ntheta = 1000,
    init_Nx = 100, len_chain = 4, ar_to_increase_Nx = 0.1, ESSrmin = 0.5,
    the prior of the JAX package's ``bench.py``: logLt finite, each
    move's acceptance rate in (0, 1), the posterior means, the Nx
    history; B1 and B2 launched once a resampling step (8 leaves: one B2
    launch) and no other kernel; host syncs one a step plus the exchange
    step's read after each resample-move; B1 (phase 2's tolerance) and B2
    (exact, the inner filters' (Nx,) rows as payloads) on the run's own
    inputs at its first, a middle and its last resampling step.  SMC² on
    the fixed-sigma LinearGauss with rho ~ U(-0.99, 0.99) (T = 100,
    Ntheta = 2^12, init_Nx = 2^9, 4 seeds) against the Kalman grid
    evidence and posterior mean: |mean logLt - exact| < 0.4, |mean
    posterior mean - exact| < 0.25 (the JAX test's tolerances).  PMMH on
    StochVol (y simulated from mu = -1, rho = 0.9, sigma = 0.3, T = 200,
    Nx = 100, 8 chains, ``bench.py``'s prior) for PMMH_NITER iterations
    (the deployment's 3000 cut to fit the phase): every chain's
    acceptance rate in (0.05, 0.9), the chain loop under
    ``torch.cuda.set_sync_debug_mode("error")``.  PMMH on the fixed-sigma
    LinearGauss (T = 25, Nx = 200, 8 chains, PMMH_ORACLE_NITER iterations)
    against the Kalman grid posterior: pooled mean within 0.15, sd ratio
    in (0.3, 3).
    CSMC on LinearGauss (T = 100, N = 2^16): particle 0 equal to xstar
    and ancestor 0 at every t, exactly; B3, B5 and B2 launched once a
    step and no other kernel; the steps under the "error" sync guard; B3
    and B5 held to their plain versions on the run's own weights.
    Particle Gibbs (conjugate rho update, Nx = 2^14, PG_SWEEPS sweeps):
    the chain's mean after burn-in within 0.25 of the true 0.8.  The
    checkpoint: phase 4's run saved at t = 500 and loaded into a new
    ``SMC`` (another seed) gives logLt and X bit for bit equal to an
    uninterrupted run; the same for ``qmc=True`` at 2^16 and for IBIS
    with ``store_history=3`` at phase 16's conjugate shape.

18. Binary SMC and nested sampling.  ``binary_smc.BayesianVS`` on the
    expanded Boston design (n = 506, p = 103: main effects, squares and
    interactions, standardised; y the standardised log price), a dense
    prior (Bernoulli 0.5) and a sparse one (Bernoulli 0.05, ``nu = 0``,
    ``iv2 = 0.01``), waste-free ``AdaptiveTempering`` with
    ``BinaryMetropolis`` at M = 100, P = 300 (N0 = 30,000), the example's
    shape uncut: logLt finite, inclusion probabilities in [0, 1], the
    sparse E|gamma| under the dense one, and on the real data LSTAT or RM
    (or a square) among the dense top 15.  ``chol_and_friends`` on the
    dense run's last N0 particles within 1e-3 (relative) of a float64
    computation on 64 sampled rows.  The toy (n = 30, p = 5, 3 runs at
    M = P = 100): the mean absolute error of the inclusion probabilities
    under 0.05 against ``complete_enum``, the active predictors above the
    inactive ones.  ``nested.NestedSamplingSMC`` (ESSrmin = 0.3) on phase
    16's Pima model at M = 2^14, P = 64: its evidence within 6.0 of phase
    16's Pima 2^20 logLt (the example's check); on the conjugate Gaussian
    mean of ``examples/nested_sampling_evidence.py`` (T = 20) at N0 = 2^16
    over 4 seeds, the mean within 0.4 of the exact evidence.
    ``nested.Nested_RWmoves`` on that model (N = 200, nsteps = 5) within
    1.5 of exact and on Pima (N = 100, the example's 300 cut to fit the
    phase; nsteps = 8) within 8.0 of NS-SMC,
    each chunk of contractions under ``set_sync_debug_mode("error")``.  In
    the sampler runs B1 once and B2 ceil(leaves / 8) times a resampling
    step and no other kernel, host syncs one a step (``done``'s read) plus
    the read that ends the run; vanilla NS launches none.  B1 (phase 2's
    tolerance) and B2 (exact, the bool (N0, 103) ``gamma`` rows among the
    leaves) on the Boston dense run's own inputs at its first, a middle and
    its last resampling step.  ms a step, steps, acceptance rates, bytes
    served a resampling step, contractions and ms a contraction; from
    ``tools/profile_torch_nested.py``, run in a fresh process, device ms
    by CUDA kernel, CUDA kernels and the busy share of a Boston step, a
    Boston chain step, the proposal's draw and fit, ``chol_and_friends``
    in four equal forms, a Pima NS-SMC level and a vanilla contraction.

19. The particle-sharded filter (``parallel.run_shardmap_smc``), in
    ranks started by ``parallel.launch.spawn`` after the kernels are
    built: (a) NCCL, one rank a card present, the main path's model and
    data (N = 2^20, T = 1000) with each ring (systematic, stratified,
    multinomial); (b) D_GLOO = 4 gloo ranks sharing card 0 (CUDA tensors,
    the collectives through the host: a check of the ring, not a speed):
    the systematic, stratified and multinomial rings and ``AuxiliaryPF``
    on the first T_GLOO_CUT steps of the headline's data.
    Each logLt within 0.5 of the float64 Kalman logLt of its data; every
    rank's logLt and rs_flags equal; per rank and resampling step, B6
    launched once (three times on multinomial: the spacings, the ring's
    uniforms and cumulative weights), B2 once a hop and B5 once a hop
    on multinomial, no other kernel; the collectives a step: two
    all-reduces (four on ``AuxiliaryPF``), and on a resampling step one
    all-gather and D - 1 ring shifts.  B2, B5 and B6 held against their
    plain versions on the rings' own inputs (T_DIST_CHECK steps that all
    resample, each scheme).  The ring on given global (w, x, u) against
    the single-device serve on the card: equal on weights k_i 2^-24, and
    on Dirichlet weights every output served once and z within 1 of B1's.
    Under gloo, sharded FFBS-MCMC at N = M = 2^17, T = 128 within 5 sd of
    the Kalman smoother, with T_SMOOTH - 1 backward steps of 3
    all-gathers and nothing else; then a second, uncounted pass of it
    with B3 and B4 held against their plain versions on the pass's own
    inputs (B3 within N 2^-31 + 1e-6, B4 exactly), every rank checking
    each at least once.  ms a step, the collectives' ms a step
    (a run with each bracketed by synchronize) and rank 0's device busy
    share in a profiler window.
20. The rest of the distributed path, in ranks started as in phase 19.
    (a) NCCL, one rank a card: distributed SQMC (``run_shardmap_smc(...,
    qmc=True)``) on the headline, uncut, within 0.5 of Kalman, the last
    particles sorted (the 1-d Hilbert order); (b) the waste-free samplers
    on Pima at M = 2^14, P = 64 (N0 = 2^20): adaptive tempering within
    3.0 of path sampling and 0.3 of the Newton MAP, NS-SMC within 6.0 of
    phase 16's tempering.  D_GLOO gloo ranks on card 0: SQMC on the first
    T_GLOO_SQMC steps with its history (global ancestors from every
    rank's slice); adaptive tempering on the conjugate mean (N0 = 2^16)
    within 0.5 of its exact evidence; SMC² on GBP/USD at Ntheta = 1000,
    init_Nx = 100 on the first T_GLOO_SMC2 observations; (c) PMMH's 8
    chains over the ranks (a 1-d ``make_mesh``), PMMH_DIST_NITER
    iterations, pooled within 0.15 of the Kalman grid's posterior mean;
    (d) ``run_sharded_smc`` with ``ssp`` on a (1, 4) mesh and
    ``run_sharded_multismc`` on a (2, 2) mesh, on the first T_GLOO_MESH
    steps, within 0.5 of Kalman.  Every rank's logLt, flags, chains and
    exchanges equal; per rank exactly the launches of SQMC_DIST_LAUNCHES
    a step, a sampler's ring B6 once and B2 D ceil(leaves / 8) times a
    resampling step, the gathered ``ssp`` B2 D times; every B2, B5 and B6
    call of the gloo runs, and of a second pass of the NCCL runs (SQMC on
    T_DIST_CHECK steps), held against its plain version.

21. The host helpers (``native``, C++ behind a C ABI): the library built
    with g++ on the card's host (its seconds printed), then each helper
    held to the port's own functions.  ``ssp_counts`` at N in {1, 2, 100,
    1000, 8191}, M in {N, N/2 + 1, 2N + 1}, through
    ``resampling.ssp_counts`` on the card and called directly, bit for
    bit against ``resampling._ssp_counts_sequential`` on the same
    uniforms (drawn from a twin of the generator, whose stream does not
    move); ``hilbert_index`` bit for bit against ``hilbert.hilbert_index``
    on the card, d in {1, 2, 3, 4} at the largest nbits (d nbits <= 62,
    at most 32); ``systematic_counts`` and ``inverse_cdf`` against the
    same formula in float64 on the card at N in {1000, 8191, 2^20}, equal
    except at points within 4 (N + 1) 2^-53 of a knot (counted and
    printed).  Then ``SMC(Bootstrap(LinearGauss(...)), N=4096,
    resampling="ssp")`` on the main path's data (T = 1000): B2 once a
    resampling step and no other kernel, logLt within 5 sd of Kalman
    (the sd of 12 other seeds' logLt, printed), and a second run of the
    same seed with every B2 call held to its plain version.  Host ms of one ``ssp_counts`` at N = 8191
    through the helper and through the plain version on the same inputs,
    of the port's call on the card, and ms a step of the run.

Then the kernels line (with each kernel's launches on the smoothing path,
``launches_smoothing``, on phase 14's runs, ``launches_zoo``, on phase
15's, ``launches_sqmc``, on phase 16's, ``launches_samplers``, on phase
17's, ``launches_outer``, on phase 18's, ``launches_nested``, on phases
19 and 20, ``launches_distributed``, and on phase 21's run,
``launches_host_helpers``) and the result line.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

N_MAIN = 2 ** 20
T_MAIN = 1000
RHO, SIGX, SIGY = 0.9, 1.0, 0.2
LOGLT_TOL = 0.5
SCHEMES = ["systematic", "stratified", "multinomial", "residual", "ssp",
           "killing"]
# the kernels each scheme launches once per resampling step (ops.KERNELS)
SCHEME_KERNELS = {
    "systematic": {"systematic_z", "repeat_by_z"},
    "stratified": {"normalised_cumsum", "repeat_by_z"},
    "multinomial": {"running_max", "normalised_cumsum", "merge_rank_counts",
                    "repeat_by_z"},
    "residual": {"running_max", "normalised_cumsum", "merge_rank_counts",
                 "repeat_by_z"},
    "ssp": {"repeat_by_z"},
    "killing": {"normalised_cumsum", "repeat_by_su"},
}
T_IDIOTIC = 50
# the smoothing path: phase 11 on the main path's shape with a window of
# history, phases 12 and 13 at the JAX package's smoothing shape
# (bench.py's FFBS-MCMC row: N = M = 2^17, T = 128), the O(N^2) forms at
# 2^13
HIST_WINDOW = 16
LAG = 5
N_SMOOTH = 2 ** 17
T_SMOOTH = 128
N_QUAD = 2 ** 13
# rounds of the rejection samplers (FFBS reject, PaRIS) before the exact
# kernel takes the stragglers: with the default (M, or N), a draw far in a
# tail takes thousands of rounds, each one host sync
REJECT_TRIALS = 32
# sd of each smoother's estimate at t, in units of scale_t / sqrt(N):
# scale_t is the exact smoothing sd at t, times sqrt(t + 1) for the
# on-line smoothers (whose target is a sum of t + 1 means).  From
# tools/smoothing_error_scale.py on the H100: the spread of each estimate
# over 20 seeds (none of them the phases'), each run as its phase runs it
# and at its N; the largest sd over the T times, rounded up to a tenth.
# Each check allows SMOOTH_SDS of them at every t.
SMOOTH_SD = {"fixed_lag": 55.3, "online_naive": 93.4, "paris": 4.5,
             "ffbs_mcmc": 11.3, "ffbs_reject": 10.5, "two_filter_ON": 10.5,
             "online_ON2": 3.0, "ffbs_ON2": 9.6, "two_filter_ON2": 9.7}
SMOOTH_SDS = 5
# phase 14: the guided and auxiliary filters and the zoo.  The Gaussian
# HMM's parameters (the JAX class has no defaults), StochVol at the JAX
# package's APF shape (bench.py: N = 2^20, T = 100, ESSrmin = 1.1) with
# the sd of each filter's logLt from SV_SEEDS seeds, every other zoo model
# at N_ZOO, T_ZOO through multiSMC
HMM_PARAMS = {"trans_mat": [[0.9, 0.05, 0.05], [0.1, 0.8, 0.1],
                            [0.05, 0.15, 0.8]],
              "mus": [-1.0, 0.5, 2.0], "sigmas": [0.5, 0.7, 0.4]}
T_SV = 100
SV_SEEDS = 8
SV_SDS = 5
N_ZOO = 2 ** 16
T_ZOO = 100
MV_SV = {"mu": [-1.0, -0.5], "covX": [[0.1, 0.02], [0.02, 0.05]],
         "corY": [[1.0, 0.4], [0.4, 1.0]], "F": [[0.9, 0.05], [0.0, 0.85]]}
# phase 15: SQMC on the main path's model and data, its spread over
# SPREAD_SEEDS seeds at N_SPREAD against SMC's, the Hilbert-key path at
# T_MV, and QMC FFBS at N_FFBS, M_FFBS, T_FFBS
N_SPREAD = 2 ** 16
SPREAD_SEEDS = 8
T_MV = 100
N_FFBS = 2 ** 14
M_FFBS = 2 ** 12
T_FFBS = 100
# phase 16: the SMC samplers, waste-free at M = N_SAMPLER starting points
# and P = P_SAMPLER states a chain (N0 = 2^20): the conjugate Gaussian mean
# of tests/test_smc_samplers.py (T_CONJ = 30) with IBIS, Tempering at
# TEMPERING_EXPONENTS and AdaptiveTempering; their spread over
# SPREAD_SEEDS seeds at N0 = N_SAMPLER_SPREAD, and the posterior mean held
# within SAMPLER_SDS of those sd; AdaptiveTempering not waste-free with
# the adaptive move (ADAPTIVE_LEN_CHAIN) at N_SAMPLER_SPREAD; Pima at the
# JAX package's shape (bench.py: PIMA_N, PIMA_LEN_CHAIN) and at N0 = 2^20,
# held to examples/tempering_logistic_regression.py's checks (logLt
# within PIMA_PS_TOL of path sampling, the posterior mean within
# PIMA_MAP_TOL of the Newton MAP); Sonar (d = 61) at N0 = 2^20
N_SAMPLER = 2 ** 14
P_SAMPLER = 64
T_CONJ = 30
TEMPERING_EXPONENTS = np.linspace(0.1, 1.0, 10)
N_SAMPLER_SPREAD = 2 ** 16
SAMPLER_SDS = 5
ADAPTIVE_LEN_CHAIN = 12
PIMA_N = 100
PIMA_LEN_CHAIN = 30
PIMA_PS_TOL = 3.0
PIMA_MAP_TOL = 0.3
# phase 17: the outer loops.  SMC² and PMMH at the JAX package's deployment
# shapes (bench.py); PMMH's 3000 iterations are cut to PMMH_NITER, and the
# Kalman-grid check to PMMH_ORACLE_NITER, to keep the script inside its
# time limit (PMMH on StochVol took 63 s of 250 iterations, the grid check
# 60 s of 2000, on an NVIDIA H100 80GB HBM3, 700.00 W)
SMC2_NTHETA = 1000
SMC2_NX = 100
SMC2_LEN_CHAIN = 4
SMC2_AR = 0.1
SMC2_ORACLE_NTHETA = 2 ** 12
SMC2_ORACLE_NX = 2 ** 9
SMC2_ORACLE_T = 100
SMC2_ORACLE_SEEDS = 4
SMC2_EV_TOL = 0.4
SMC2_MEAN_TOL = 0.25
PMMH_T = 200
PMMH_NX = 100
PMMH_CHAINS = 8
PMMH_NITER = 100
PMMH_ORACLE_T = 25
PMMH_ORACLE_NX = 200
PMMH_ORACLE_NITER = 1000
PMMH_ORACLE_BURN = 250
PMMH_MEAN_TOL = 0.15
CSMC_T = 100
CSMC_N = 2 ** 16
PG_NX = 2 ** 14
PG_SWEEPS = 40
PG_BURN = 10
PG_TOL = 0.25
CKPT_T = 500
CKPT_QMC_N = 2 ** 16
CKPT_IBIS_T = 15
# phase 18: binary SMC at the Boston example's shape
# (examples/binary_smc_boston_interactions.py: n = 506, p = 103, M = 100,
# P = 300, uncut), its toy against enumeration, NS-SMC and vanilla NS at
# the nested examples' shapes (examples/nested_logistic.py,
# examples/nested_sampling_evidence.py), NS-SMC widened to N0 = 2^20
BOSTON_M = 100
BOSTON_P = 300
BOSTON_NAMES = ("CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS",
                "RAD", "TAX", "PTRATIO", "B", "LSTAT")
TOY_N = 30
TOY_P = 5
TOY_M = 100
TOY_LEN_CHAIN = 100
TOY_SEEDS = 3
TOY_TOL = 0.05
CHOL_ROWS = 64
CHOL_RTOL = 1e-3
NS_ESSRMIN = 0.3
NS_PIMA_TOL = 6.0
NS_CONJ_T = 20
NS_CONJ_N0 = 2 ** 16
NS_CONJ_SEEDS = 4
NS_CONJ_TOL = 0.4
VANILLA_CONJ_N = 200
VANILLA_CONJ_NSTEPS = 5
VANILLA_CONJ_TOL = 1.5
# the example's N = 300 cut to 100: at 300 the run took 89 s of the phase
# (10,350 contractions at 8.6 ms, NVIDIA H100 80GB HBM3, 700.00 W)
VANILLA_PIMA_N = 100
VANILLA_PIMA_NSTEPS = 8
VANILLA_PIMA_TOL = 8.0
# phase 19: the particle-sharded filter (parallel.run_shardmap_smc) on the
# main path's model and data: NCCL with one rank a card, and D_GLOO gloo
# ranks sharing card 0 with their collectives through the host (a check of
# the ring, not a speed: 37-69 ms a step on an NVIDIA H100 80GB HBM3,
# 700.00 W, so the gloo runs take the first T_GLOO_CUT steps of the
# data; the headline's 1000 took 69 s of the phase's 188 s); sharded
# FFBS-MCMC at the smoothing shape (N = M = N_SMOOTH, T_SMOOTH); every
# kernel checked against its plain version on T_DIST_CHECK steps that all
# resample; a profiler window of DIST_PROFILE_STEPS steps
D_GLOO = 4
T_GLOO_CUT = 100
T_DIST_CHECK = 20
DIST_PROFILE_STEPS = 20
DIST_SCHEMES = ("systematic", "stratified", "multinomial")
# the kernels each ring launches a resampling step, per rank, D ranks: the
# running max once (the z-forms' z) or three times (the block's spacings,
# then the merge ring's uniforms and cumulative weights), the merge rank
# once a hop, the move once a hop
DIST_LAUNCHES = {
    "systematic": lambda D: {"running_max": 1, "repeat_by_z": D},
    "stratified": lambda D: {"running_max": 1, "repeat_by_z": D},
    "multinomial": lambda D: {"running_max": 3, "merge_rank_counts": D,
                              "repeat_by_z": D},
}
# phase 20: the rest of the distributed path, NCCL with one rank a card and
# D_GLOO gloo ranks on card 0 as in phase 19.  NCCL: distributed SQMC on
# the headline (N_MAIN, T_MAIN) and the waste-free samplers on Pima at
# phase 16's and phase 18's shapes (N_SAMPLER starting points, P_SAMPLER
# states a chain), uncut.  Gloo, through the host: SQMC on the first
# T_GLOO_SQMC steps with its history; adaptive tempering on phase 16's
# conjugate mean at N0 = N_SAMPLER_SPREAD; SMC² at phase 17's GBP/USD shape
# on the first T_GLOO_SMC2 observations of its 750; PMMH's PMMH_CHAINS
# chains over the ranks against phase 17's Kalman grid, cut to
# PMMH_DIST_NITER iterations of phase 17's PMMH_ORACLE_NITER; and the mesh
# entry points on the first T_GLOO_MESH steps: run_sharded_smc with ssp on
# a (1, D_GLOO) mesh and run_sharded_multismc (MULTI_RUNS runs) on a (2, 2)
# mesh.  Every B2, B5 and B6 launch of the gloo runs, and of a second pass
# of the NCCL runs (SQMC cut to T_DIST_CHECK steps), is held against its
# plain version.
T_GLOO_SQMC = 50
T_GLOO_SMC2 = 250
PMMH_DIST_NITER = 500
PMMH_DIST_BURN = 100
T_GLOO_MESH = 50
MULTI_RUNS = 4
# the kernels a step launches a rank: distributed SQMC at every t >= 1
# (the merge ring: B6 on the uniforms and on the cumulative weights, B5
# and B2 a hop); a sampler's systematic ring at each resampling step (B6
# once, B2 a hop for every MAX_PAYLOADS leaves); the gathered ssp z-form
# (B2 a hop)
SQMC_DIST_LAUNCHES = lambda D: {"running_max": 2,  # noqa: E731
                                "merge_rank_counts": D, "repeat_by_z": D}
# phase 21: the host helpers (native, C++ built with g++).  ssp_counts at
# SSP_SMALL_NS (below the tree pairing's 8192) against its plain version,
# the Hilbert index of N_HILBERT points at each d's largest nbits, the
# systematic counts and the inverse CDF at KNOT_SIZES against float64 on
# the card, and the headline's model and data with ssp at N_SSP_SMALL,
# whose every resampling step the helper computes and B2 serves.  Its
# logLt is held within LOGLT_SDS sd of Kalman, the sd that of the logLts
# of SSP_SEEDS other seeds of the same run.  Phase 4's sqrt(T * 2.7 / N)
# (0.81 here) is too small at this N: on the CPU, 8 seeds gave sd 1.11
# for ssp and 2.19 for systematic, and means 1.63 and 0.56 below Kalman
# (the log of an unbiased estimate is biased low).
SSP_SMALL_NS = (1, 2, 100, 1000, 8191)
N_HILBERT = 2 ** 16
KNOT_SIZES = (1000, 8191, N_MAIN)
N_SSP_SMALL = 4096
LOGLT_SDS = 5
SSP_SEEDS = 12

# the card's peaks, for the bounds: HBM bytes/s and float32 operations/s
# outside the tensor cores (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


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


def _payloads(torch, dev, N):
    """Phase 3's payload dtypes and widths, (N, ...) each."""
    return [
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


def _strained_counts(rng, tile):
    """(name, offspring counts, M) that strain the z-move's merge path."""
    N = N_MAIN - 513

    def one_hot(k):
        c = np.zeros(N, dtype=np.int64)
        c[k] = N
        return c

    def random_counts(n, m):
        return rng.multinomial(m, rng.dirichlet(np.full(n, 0.3)))

    runs = np.zeros(N, dtype=np.int64)
    burst = np.arange(0, N, 3 * tile + 2)      # 3 blocks of zeros between
    runs[burst] = rng.multinomial(N, np.full(len(burst), 1.0 / len(burst)))
    cases = [("all on the first", one_hot(0), N),
             ("all on a middle one", one_hot(N // 2), N),
             ("all on the last", one_hot(N - 1), N),
             ("counts all 1", np.ones(N, dtype=np.int64), N),
             ("zero runs of 3 blocks", runs, N),
             ("N=1 M=1", np.array([1]), 1), ("N=1 M=5", np.array([5]), 5)]
    for M in (1, N // 2 + 1, 4 * N):
        cases.append((f"M={M}", random_counts(N, M), M))
    cases.append((f"N={3 * tile + 5} M={2 * tile + 7}",
                  random_counts(3 * tile + 5, 2 * tile + 7), 2 * tile + 7))
    return cases


def check_b1(torch, ops, dev, tag, W_np, u, M, strained=False):
    """B1 on ``W_np`` against its plain version and float64: int32 (N,),
    nondecreasing, ``z[-1] == M``, ``0 <= z <= M`` and ``|z - plain| <= 1``;
    ``|z - float64| <= 1``, or, ``strained`` (N > 2^20 or M = 4N, where the
    fixed-point grid puts the function itself further off), no further
    from float64 than the plain version, plus 1.  Returns (z, |z - plain|,
    |z - float64|, |plain - float64|, elements differing from plain)."""
    N = len(W_np)
    W = torch.from_numpy(W_np).to(dev)
    ut = torch.tensor(u, dtype=torch.float32, device=dev)
    z = ops.systematic_z_fused(W, ut, M)
    zp = ops.systematic_z_plain(W, ut, M)
    torch.cuda.synchronize()
    zc = z.cpu().numpy().astype(np.int64)
    zpc = zp.cpu().numpy().astype(np.int64)
    zo = _oracle_z(W_np, u, M)
    _check(z.dtype == torch.int32 and zc.shape == (N,), f"{tag}: shape")
    _check(bool(np.all(np.diff(zc) >= 0)), f"{tag}: not nondecreasing")
    _check(zc[-1] == M and zc.min() >= 0 and zc.max() <= M, f"{tag}: range")
    dp = int(np.abs(zc - zpc).max())
    do = int(np.abs(zc - zo).max())
    dpo = int(np.abs(zpc - zo).max())
    _check(dp <= 1, f"{tag}: |z - plain| = {dp} > 1")
    _check(do <= (max(1, dpo + 1) if strained else 1),
           f"{tag}: |z - oracle| = {do}, |plain - oracle| = {dpo}")
    return z, dp, do, dpo, int(np.count_nonzero(zc != zpc))


def check_b2(torch, tag, forms):
    """B2 against its plain version, exact: ``forms`` is a list of (name,
    (payloads, A), (plain payloads, plain A)).  Returns the largest
    difference (0)."""
    torch.cuda.synchronize()
    err = 0.0
    for form, (ys, A), (yps, Ap) in forms:
        for y, yp in zip(ys, yps, strict=True):
            _check(y.dtype == yp.dtype and y.shape == yp.shape,
                   f"{tag} {form}: {y.dtype}{tuple(y.shape)} vs "
                   f"{yp.dtype}{tuple(yp.shape)}")
            d = float((y.double() - yp.double()).abs().max())
            err = max(err, d)
            _check(torch.equal(y, yp), f"{tag} {form}: {y.dtype} "
                                       f"payload differs (max {d})")
        if Ap is not None:
            _check(A is not None and A.dtype == torch.int64
                   and torch.equal(A, Ap), f"{tag} {form}: ancestors differ")
    return err


def check_b3(torch, ops, dev, tag, W_np):
    """B3 on ``W_np`` against its plain version and float64: nondecreasing,
    ``|cs[-1] - 1| < 1e-6``, within N 2^-31 + 1e-6 of both.  Returns (cs,
    |cs - plain|)."""
    N = len(W_np)
    W = torch.from_numpy(W_np).to(dev)
    cs = ops.normalised_cumsum_exact(W)
    cp = ops.normalised_cumsum_plain(W)
    torch.cuda.synchronize()
    csc, cpc = cs.cpu().numpy(), cp.cpu().numpy()
    W64 = W_np.astype(np.float64)
    co = np.cumsum(W64) / W64.sum()
    tol = N * 2.0 ** -31 + 1e-6
    _check(cs.dtype == torch.float32 and csc.shape == (N,), f"{tag}: shape")
    _check(bool(np.all(np.diff(csc) >= 0)), f"{tag}: not nondecreasing")
    _check(abs(csc[-1] - 1.0) < 1e-6, f"{tag}: cs[-1] = {csc[-1]}")
    dp = float(np.abs(csc - cpc).max())
    do = float(np.abs(csc - co).max())
    _check(dp < tol, f"{tag}: |cs - plain| = {dp} >= {tol}")
    _check(do < tol, f"{tag}: |cs - oracle| = {do} >= {tol}")
    return cs, dp


def check_b4(torch, ops, tag, su, cs, cols):
    """B4 against its plain version, exact: the fused form with ancestors
    and ancestors alone."""
    M = su.shape[0]
    ys, A = ops.repeat_cols_su(su, cs, M, cols, want_anc=True)
    A_only = ops.ancestors_by_su(su, cs)
    yps, Ap = ops.repeat_cols_su_plain(su, cs, M, cols, want_anc=True)
    torch.cuda.synchronize()
    _check(A.dtype == torch.int64 and torch.equal(A, Ap)
           and torch.equal(A_only, Ap), f"{tag}: ancestors differ")
    for out, out_plain in zip(ys, yps, strict=True):
        _check(out.dtype == out_plain.dtype and torch.equal(out, out_plain),
               f"{tag}: {out.dtype} payload differs")


def check_path_kernels(torch, dev, tag, lw, X, Ms, seed):
    """The kernels on a smoothing path's own inputs: the weights of ``lw``
    and the particles ``X`` (N,) as the forward step hands them to B1 and
    B2 (the move with the particles, with and without ancestors), and, for
    each M in ``Ms``, as the backward passes and PaRIS hand them to B3 (the
    CDF) and B4 (M draws served with the particles).  Tolerances as in
    phases 2, 3, 5 and 7.  Returns the cases and largest errors."""
    from particles_tpu_torch import ops
    from particles_tpu_torch import resampling as rs

    W = rs.exp_and_normalise(lw)
    W_np = W.cpu().numpy()
    N = len(W_np)
    u = float(np.random.default_rng(seed).random())
    z, dz, dz64, _, _ = check_b1(torch, ops, dev, f"{tag} B1", W_np, u, N)
    db2 = check_b2(torch, f"{tag} B2", [
        ("fused+anc", ops.repeat_cols(z, N, [X], want_anc=True),
         ops.repeat_cols_plain(z, N, [X], want_anc=True)),
        ("payload", ops.repeat_cols(z, N, [X]),
         ops.repeat_cols_plain(z, N, [X]))])
    out = {"tag": tag, "N": N, "B1": 1, "B2": 2, "systematic_z_err": dz,
           "systematic_z_err_vs_float64": dz64, "repeat_by_z_err": db2}
    if Ms:
        _, db3 = check_b3(torch, ops, dev, f"{tag} B3", W_np)
        cs = rs.pinned_cdf(W)
        for M in Ms:
            check_b4(torch, ops, f"{tag} B4 M={M}",
                     torch.rand(M, device=dev), cs, [X])
        out.update({"B3": 1, "B4": len(Ms), "normalised_cumsum_err": db3,
                    "repeat_by_su_err": 0, "M": list(Ms)})
    return out


def _path_checks_summary(cases):
    """The phase's kernel checks on its own inputs, for its JSON line."""
    keys = ("systematic_z_err", "systematic_z_err_vs_float64",
            "repeat_by_z_err", "normalised_cumsum_err", "repeat_by_su_err")
    return {"inputs": [{k: c[k] for k in ("tag", "N", "M") if k in c}
                       for c in cases],
            "cases": {k: sum(c.get(k, 0) for c in cases)
                      for k in ("B1", "B2", "B3", "B4", "B5")},
            **{f"max_{k}": max(c.get(k, 0) for c in cases) for k in keys},
            "tolerance": "B1 |dz| <= 1 vs plain and float64; B3 |dcs| < "
                         "N 2^-31 + 1e-6 vs plain and float64; B2, B4, B5 "
                         "exact"}


def _simulate_y(T):
    """Observations of the main path's model, from a numpy seed."""
    rng = np.random.default_rng(1)
    xs = np.empty(T)
    xs[0] = rng.normal() * SIGX / np.sqrt(1 - RHO ** 2)
    for t in range(1, T):
        xs[t] = RHO * xs[t - 1] + SIGX * rng.normal()
    return (xs + SIGY * rng.normal(size=T)).astype(np.float32)


def kalman_targets(y, lag):
    """Exact float64 targets of the smoothers on the main path's model:
    the smoothing means and variances given all of ``y`` (``mean``,
    ``var``); ``S[t] = sum_{s <= t} E[x_s | y_{0:t}]``, the on-line
    smoothers' target at t for the additive function x_t; and ``F[t] =
    E[x_{max(t - lag, 0)} | y_{0:t}]``, the fixed-lag smoother's.  The RTS
    step ``m_s = mf_s + J_s (m_{s+1} - mp_{s+1})`` does not depend on the
    end time, so one backward sweep serves every end time at once."""
    T = len(y)
    y = np.asarray(y, np.float64)
    mf, Pf, mp, Pp = (np.empty(T) for _ in range(4))
    for t in range(T):
        if t == 0:
            mp[0], Pp[0] = 0.0, SIGX ** 2 / (1 - RHO ** 2)
        else:
            mp[t], Pp[t] = RHO * mf[t - 1], RHO ** 2 * Pf[t - 1] + SIGX ** 2
        gain = Pp[t] / (Pp[t] + SIGY ** 2)
        mf[t], Pf[t] = mp[t] + gain * (y[t] - mp[t]), (1 - gain) * Pp[t]
    J = RHO * Pf[:-1] / Pp[1:]
    m, S, F = mf.copy(), mf.copy(), np.empty(T)   # m[e]: m_s given y_{0:e}
    mean, var = np.empty(T), np.empty(T)
    mean[-1], var[-1] = mf[-1], Pf[-1]
    for s in range(T - 2, -1, -1):
        m[s + 1:] = mf[s] + J[s] * (m[s + 1:] - mp[s + 1])
        S[s + 1:] += m[s + 1:]
        if s + lag < T:
            F[s + lag] = m[s + lag]
        mean[s] = m[-1]
        var[s] = Pf[s] + J[s] ** 2 * (var[s + 1] - Pp[s + 1])
    F[:lag] = m[:lag]
    return {"mean": mean, "var": var, "S": S, "F": F}


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


def _device_window(torch, fn, calls, tries=5):
    """({CUDA kernel: device ms a call}, CUDA kernels a call) of ``fn``,
    from a ``torch.profiler`` window of ``calls`` calls.  The profiler
    now and then misses some of a window's kernels, or all of them: a
    window whose count of kernels is no multiple of ``calls`` is taken
    again, up to ``tries`` windows."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_kernel, n = {}, 0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                name = evt.key[:100]
                by_kernel[name] = (by_kernel.get(name, 0.0)
                                   + evt.self_device_time_total / 1000.0
                                   / calls)
                n += evt.count
        if n > 0 and n % calls == 0:
            return by_kernel, n / calls
    raise AssertionError(f"the profiler recorded {n} CUDA kernels for "
                         f"{calls} calls, in each of {tries} windows")


def _device_ms(torch, fn, calls=20):
    """(device ms a call, CUDA kernels a call) of ``fn``."""
    by_kernel, per_call = _device_window(torch, fn, calls)
    return sum(by_kernel.values()), per_call


def _zero_counts(ops):
    """Zero every counter of ``tracing``: the kernels' launches, the
    collectives' calls and the host reads."""
    from particles_tpu_torch import tracing

    tracing.reset()


def _read_counts(ops):
    """Each kernel's launches since :func:`_zero_counts`."""
    from particles_tpu_torch import tracing

    counts = tracing.counts()
    return {name: counts.get("launch." + name, 0) for name in ops.KERNELS}


def _read_calls(comm):
    """Each collective's calls since :func:`_zero_counts`."""
    from particles_tpu_torch import tracing

    counts = tracing.counts()
    return {name: counts.get("comm." + name, 0) for name in comm.COLLECTIVES}


def _sync_ms(torch, fn):
    """(result, wall ms) of ``fn``, the clock stopped after the device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1000.0 * (time.perf_counter() - t0)


def _smooth_check(tag, est, exact, scale, N, key):
    """|est_t - exact_t| <= SMOOTH_SDS sd at every t; returns the largest
    error in sd."""
    err = np.abs(np.asarray(est, np.float64) - exact)
    in_sd = err * np.sqrt(N) / (SMOOTH_SD[key] * scale)
    worst = float(in_sd.max())
    _check(np.all(np.isfinite(est)) and worst <= SMOOTH_SDS,
           f"{tag}: error {worst:.2f} sd at t = {int(in_sd.argmax())} "
           f"(limit {SMOOTH_SDS} sd)")
    return {"max_abs_err": float(err.max()), "max_err_sd": worst,
            "tolerance_sd": SMOOTH_SDS,
            "sd_at_t0": float(SMOOTH_SD[key] * scale[0] / np.sqrt(N))}


def _lg_smooth(kalman):
    class LGsmooth(kalman.LinearGauss):
        """The main path's model with the additive function x_t."""

        def add_func(self, t, xp, x):
            return x

    return LGsmooth(rho=RHO, sigmaX=SIGX, sigmaY=SIGY)


def phase_history(torch, dev, smi, y, kf_logLt, main_ms):
    """Phase 11: the main path with a window of history and two genealogy
    collectors, at N = 2^20 and T = 1000."""
    import warnings

    from particles_tpu_torch import collectors, kalman, ops
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.core import SMC

    fk = ssms.Bootstrap(ssm=_lg_smooth(kalman),
                        data=torch.from_numpy(y).to(dev))
    tg = kalman_targets(y, LAG)
    sd = np.sqrt(tg["var"])

    class ANondecreasing(collectors.Collector):
        """On the device: the step's ancestors exist and are nondecreasing
        (False on a resampling step that lacks them)."""

        summary_name = "a_nondecreasing"

        def collect(self, view):
            if not view.rs_flag:
                return torch.ones((), dtype=torch.bool, device=dev)
            if view.A is None:
                return torch.zeros((), dtype=torch.bool, device=dev)
            return (view.A[1:] >= view.A[:-1]).all()

    def smoothers():
        return [collectors.Fixed_lag_smooth(lag=LAG),
                collectors.Online_smooth_naive()]

    _zero_counts(ops)
    pf = SMC(fk=fk, N=N_MAIN, seed=11, store_history=HIST_WINDOW,
             collect=smoothers() + [ANondecreasing()])
    next(pf)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(T_MAIN - 1):
                next(pf)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    for _ in pf:
        pass
    launches = _read_counts(ops)
    n_rs = int(pf.summaries.rs_flags.sum())
    logLt = float(pf.logLt)
    _check(abs(logLt - kf_logLt) < LOGLT_TOL,
           f"phase 11: |logLt - Kalman| = {abs(logLt - kf_logLt)}")
    for name, n in launches.items():
        want = n_rs if name in ("systematic_z", "repeat_by_z") else 0
        _check(n == want and n_rs > 0, f"phase 11: {name} launched {n} "
                                       f"times, {n_rs} resampling steps")
    _check(syncs == T_MAIN - 1, f"phase 11: {syncs} host syncs in "
                                f"{T_MAIN - 1} steps")
    _check(bool(pf.summaries.a_nondecreasing.all()),
           "phase 11: a resampling step's ancestors missing or not sorted")
    h = pf.hist
    _check(h.T == HIST_WINDOW and len(h.A) == HIST_WINDOW
           and torch.equal(h.X[-1], pf.X), "phase 11: the window")
    A_np = [a.cpu().numpy() for a in h.A]
    B = [np.arange(N_MAIN)]
    for a in reversed(A_np[1:]):
        B.append(a[B[-1]])
    _check(np.array_equal(h.compute_trajectories().cpu().numpy(),
                          np.stack(B[::-1])),
           "phase 11: the window's trajectories differ from numpy's")
    s = pf.summaries
    fixed = _smooth_check("phase 11 fixed lag",
                          s.fixed_lag_smooths.cpu().numpy(), tg["F"], sd,
                          N_MAIN, "fixed_lag")
    grow = sd.mean() * np.sqrt(np.arange(1, T_MAIN + 1))
    naive = _smooth_check("phase 11 naive on-line",
                          s.online_smooth_naives.cpu().numpy(), tg["S"],
                          grow, N_MAIN, "online_naive")
    warm = SMC(fk=fk, N=N_MAIN, seed=12, store_history=HIST_WINDOW,
               collect=smoothers())
    warm.run()
    ms = 1000.0 * warm.cpu_time / T_MAIN
    _emit({"phase": 11, "nvidia_smi": smi, "N": N_MAIN, "T": T_MAIN,
           "store_history": HIST_WINDOW,
           "collect": ["Fixed_lag_smooth(lag=5)", "Online_smooth_naive()"],
           "logLt": logLt, "abs_diff": abs(logLt - kf_logLt),
           "tolerance": LOGLT_TOL, "resampling_steps": n_rs,
           "launches": launches, "host_syncs": syncs,
           "host_syncs_per_step": syncs / (T_MAIN - 1),
           "window_frames": h.T, "window_trajectories": "equal to numpy's",
           "fixed_lag_vs_kalman": fixed, "naive_vs_kalman": naive,
           "ms_per_step": ms, "main_path_ms_per_step": main_ms,
           "ratio_to_main_path": ms / main_ms})
    return {"phase 11 forward": launches}


def phase_offline(torch, dev, smi):
    """Phase 12: the off-line smoothers against the Kalman smoother."""
    from particles_tpu_torch import kalman, ops
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.core import SMC

    y = _simulate_y(T_SMOOTH)
    tg = kalman_targets(y, LAG)
    sd = np.sqrt(tg["var"])
    ssm = _lg_smooth(kalman)
    fk = ssms.Bootstrap(ssm=ssm, data=torch.from_numpy(y).to(dev))
    info_fk = ssms.Bootstrap(ssm=ssm,
                             data=torch.from_numpy(y[::-1].copy()).to(dev))
    gen = torch.Generator(device=dev).manual_seed(5)
    out, all_launches = {}, {}

    def forward(N, seed, data_fk=fk):
        pf = SMC(fk=data_fk, N=N, seed=seed, store_history=True)
        pf.run()
        return pf

    def measured(name, fn, steps, kernels):
        """Run ``fn`` with the counts zeroed; the kernels named must have
        launched, and no other."""
        _zero_counts(ops)
        res, ms = _sync_ms(torch, fn)
        launches = _read_counts(ops)
        for k, n in launches.items():
            _check((n > 0) == (k in kernels),
                   f"phase 12 {name}: {k} launched {n} times")
        all_launches[f"phase 12 {name}"] = launches
        return res, {"ms_per_backward_step": ms / steps,
                     "launches": launches}

    pf = forward(N_SMOOTH, 21)
    forward(N_SMOOTH, 20)    # the allocator and the draws warm
    steps = T_SMOOTH - 1
    for name, fn in (
            ("ffbs_mcmc", lambda: pf.hist.backward_sampling_mcmc(
                gen, N_SMOOTH, nsteps=1)),
            ("ffbs_reject", lambda: pf.hist.backward_sampling_reject(
                gen, N_SMOOTH, max_trials=REJECT_TRIALS))):
        paths, rec = measured(name, fn, steps,
                              {"normalised_cumsum", "repeat_by_su"})
        _check(paths.shape == (T_SMOOTH, N_SMOOTH), f"{name}: shape")
        rec.update(_smooth_check(f"phase 12 {name}",
                                 paths.mean(1).cpu().numpy(), tg["mean"],
                                 sd, N_SMOOTH, name))
        if name == "ffbs_mcmc":
            want = {"normalised_cumsum": 1 + steps, "repeat_by_su": 1 + steps}
        else:
            rec.update({"max_trials": REJECT_TRIALS,
                        "rounds": sum(pf.hist.rounds),
                        "rounds_per_step": sum(pf.hist.rounds) / steps,
                        "max_rounds_in_a_step": max(pf.hist.rounds),
                        "stragglers": sum(pf.hist.stragglers),
                        "steps_with_stragglers": sum(
                            n > 0 for n in pf.hist.stragglers)})
            # one CDF a step, one B4 launch a round
            want = {"normalised_cumsum": 1 + steps,
                    "repeat_by_su": 1 + sum(pf.hist.rounds)}
        for k, n in want.items():
            _check(rec["launches"][k] == n,
                   f"phase 12 {name}: {k} launched {rec['launches'][k]}, "
                   f"expected {n}")
        out[name] = rec
    info = forward(N_SMOOTH, 22, info_fk)

    def two_filter_ON():
        return torch.stack([pf.hist.two_filter_smoothing(
            t, info, lambda x, xf: x, ssm.PX0().logpdf, linear_cost=True,
            gen=gen) for t in range(steps)])

    est, rec = measured("two_filter_ON", two_filter_ON, steps,
                        {"normalised_cumsum", "repeat_by_su"})
    for k in ("normalised_cumsum", "repeat_by_su"):
        _check(rec["launches"][k] == 2 * steps,
               f"phase 12 two_filter_ON: {k} launched {rec['launches'][k]}, "
               f"expected {2 * steps}")
    rec.update(_smooth_check("phase 12 two-filter O(N)", est.cpu().numpy(),
                             tg["mean"][:-1], sd[:-1], N_SMOOTH,
                             "two_filter_ON"))
    out["two_filter_ON"] = rec
    pfq, infoq = forward(N_QUAD, 23), forward(N_QUAD, 24, info_fk)
    paths, rec = measured(
        "ffbs_ON2", lambda: pfq.hist.backward_sampling_ON2(gen, N_QUAD),
        steps, {"normalised_cumsum", "repeat_by_su"})
    _check(rec["launches"]["normalised_cumsum"] == 1
           and rec["launches"]["repeat_by_su"] == 1,
           f"phase 12 ffbs_ON2: launches {rec['launches']}")
    rec.update(_smooth_check("phase 12 ffbs_ON2",
                             paths.mean(1).cpu().numpy(), tg["mean"], sd,
                             N_QUAD, "ffbs_ON2"))
    out["ffbs_ON2"] = rec

    def two_filter_ON2():
        return torch.stack([pfq.hist.two_filter_smoothing(
            t, infoq, lambda x, xf: x, ssm.PX0().logpdf)
            for t in range(steps)])

    est, rec = measured("two_filter_ON2", two_filter_ON2, steps, set())
    rec.update(_smooth_check("phase 12 two-filter O(N^2)",
                             est.cpu().numpy(), tg["mean"][:-1], sd[:-1],
                             N_QUAD, "two_filter_ON2"))
    out["two_filter_ON2"] = rec
    # every kernel of the phase on the phase's own inputs: the forward
    # weights and particles at 2^17 and 2^13 (B1, B2 in the forward step;
    # B3, B4 in the backward passes, M from PaRIS's 2N to a last
    # straggler), and the information filter's weights of two-filter O(N)
    checks = []
    for h, N in ((pf.hist, N_SMOOTH), (pfq.hist, N_QUAD)):
        Ms = (2 * N, N, N // 2 + 1, 37, 1)
        for t in (0, T_SMOOTH // 2, T_SMOOTH - 2):
            checks.append(check_path_kernels(
                torch, dev, f"phase 12 N={N} t={t}", h.lw[t], h.X[t], Ms,
                seed=t))
    ti = T_SMOOTH // 2
    checks.append(check_path_kernels(
        torch, dev, f"phase 12 information filter t={ti}",
        info.hist.lw[ti] - ssm.PX0().logpdf(info.hist.X[ti]),
        info.hist.X[ti], (N_SMOOTH,), seed=ti))
    _emit({"phase": 12, "nvidia_smi": smi, "T": T_SMOOTH,
           "N": N_SMOOTH, "M": N_SMOOTH, "N_quadratic": N_QUAD,
           "forward_resampling_steps": int(pf.summaries.rs_flags.sum()),
           "smoothers": out, "kernels_vs_plain": _path_checks_summary(checks)})
    return all_launches, checks


def phase_online(torch, dev, smi):
    """Phase 13: PaRIS, the O(N^2) on-line smoother and the variance
    estimators."""
    from particles_tpu_torch import collectors, kalman, ops
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch import variance_estimators as ve
    from particles_tpu_torch.core import SMC

    y = _simulate_y(T_SMOOTH)
    tg = kalman_targets(y, LAG)
    grow = np.sqrt(tg["var"]).mean() * np.sqrt(np.arange(1, T_SMOOTH + 1))
    fk = ssms.Bootstrap(ssm=_lg_smooth(kalman),
                        data=torch.from_numpy(y).to(dev))
    all_launches = {}

    def run(N, seed, cols, **kw):
        pf = SMC(fk=fk, N=N, seed=seed, collect=cols, **kw)
        pf.run()
        return pf, 1000.0 * pf.cpu_time / T_SMOOTH

    run(N_SMOOTH, 30, [])          # warm
    alone = {N: run(N, 31, [])[1] for N in (N_SMOOTH, N_QUAD)}
    paris = collectors.Paris(Nparis=2, max_trials=REJECT_TRIALS)
    _zero_counts(ops)
    pf, paris_ms = run(N_SMOOTH, 32, [paris])
    launches = _read_counts(ops)
    all_launches["phase 13 Paris"] = launches
    rounds = sum(paris.rounds)
    for k, n in launches.items():
        # one CDF a step (each step has a round), one B4 launch a round
        want = {"normalised_cumsum": T_SMOOTH - 1, "repeat_by_su": rounds,
                "systematic_z": int(pf.summaries.rs_flags.sum()),
                "repeat_by_z": int(pf.summaries.rs_flags.sum())}.get(k, 0)
        _check(n == want and (want > 0 or k not in ("normalised_cumsum",
                                                    "repeat_by_su")),
               f"phase 13 Paris: {k} launched {n} times, expected {want}")
    paris_err = _smooth_check("phase 13 Paris",
                              pf.summaries.paris.cpu().numpy(), tg["S"],
                              grow, N_SMOOTH, "paris")
    # the kernels on the phase's own inputs: PaRIS's last weights and
    # particles (its draws: M = 2N, then the rejected, down to a few), the
    # forward steps of each run (B1, B2)
    checks = [check_path_kernels(
        torch, dev, "phase 13 Paris", pf.wgts.lw, pf.X,
        (2 * N_SMOOTH, N_SMOOTH, N_SMOOTH // 2 + 1, 37, 1), seed=13)]
    pf, on2_ms = run(N_QUAD, 33, [collectors.Online_smooth_ON2()])
    on2_err = _smooth_check("phase 13 Online_smooth_ON2",
                            pf.summaries.online_smooth_ON2s.cpu().numpy(),
                            tg["S"], grow, N_QUAD, "online_ON2")
    checks.append(check_path_kernels(
        torch, dev, "phase 13 Online_smooth_ON2", pf.wgts.lw, pf.X, (),
        seed=14))
    var_ms = {}
    for cls in (ve.Var, ve.Var_logLt, ve.Lag_based_var):
        var_ms[cls.__name__] = run(N_SMOOTH, 34, [cls()])[1]
    coalesced = {}
    for N in (N_SMOOTH, 256):
        pf, _ = run(N, 35, [ve.Var(), ve.Var_logLt(),
                            ve.Lag_based_var(lag=LAG)], store_history=True)
        s = pf.summaries
        for t in (1, T_SMOOTH - 2):
            checks.append(check_path_kernels(
                torch, dev, f"phase 13 variance estimators N={N} t={t}",
                pf.hist.lw[t], pf.hist.X[t], (), seed=t))
        for name in ("var", "var_logLt", "lag_based_var"):
            v = getattr(s, name)
            _check(bool(torch.isfinite(v).all() and (v >= 0).all()),
                   f"phase 13 {name} N={N}: not finite and >= 0")
        A = pf.hist.A
        eve = torch.arange(N, device=dev)
        n_eve = n_lag = 0
        for t in range(T_SMOOTH):
            eve = eve[A[t]]
            if bool((eve == eve[0]).all()):
                _check(float(s.var[t]) == 0.0,
                       f"phase 13 Var N={N} t={t}: coalesced, not 0")
                n_eve += 1
            B = torch.arange(N, device=dev)
            for i in range(LAG + 1):
                if i:
                    B = A[max(t - i + 1, 0)][B]
                if bool((B == B[0]).all()):
                    _check(float(s.lag_based_var[t, i]) == 0.0,
                           f"phase 13 Lag_based_var N={N} t={t} lag {i}: "
                           "coalesced, not 0")
                    n_lag += 1
        coalesced[N] = {"var_steps_coalesced": n_eve,
                        "lag_estimates_coalesced": n_lag}
    _check(coalesced[256]["var_steps_coalesced"] > 0,
           "phase 13: the genealogy at N = 256 never coalesced")
    _emit({"phase": 13, "nvidia_smi": smi, "N": N_SMOOTH, "T": T_SMOOTH,
           "N_quadratic": N_QUAD,
           "filter_alone_ms_per_step": alone[N_SMOOTH],
           "paris": {"Nparis": 2, "max_trials": REJECT_TRIALS,
                     "ms_per_step": paris_ms,
                     "rounds_per_step": rounds / (T_SMOOTH - 1),
                     "max_rounds_in_a_step": max(paris.rounds),
                     "launches": launches, **paris_err},
           "online_smooth_ON2": {"N": N_QUAD, "ms_per_step": on2_ms,
                                 "filter_alone_ms_per_step": alone[N_QUAD],
                                 **on2_err},
           "variance_estimators_ms_per_step": var_ms,
           "coalesced": {str(k): v for k, v in coalesced.items()},
           "kernels_vs_plain": _path_checks_summary(checks)})
    return all_launches, checks


def _simulate_sv(model, T):
    """Observations of the StochVol ``model`` (its mu, rho and sigma) from
    a numpy seed, the same on every device."""
    mu, rho, sigma = model.mu, model.rho, model.sigma
    rng = np.random.default_rng(1)
    x = mu + sigma / np.sqrt(1 - rho ** 2) * rng.normal()
    y = np.empty(T)
    for t in range(T):
        if t > 0:
            x = mu + rho * (x - mu) + sigma * rng.normal()
        y[t] = np.exp(0.5 * x) * rng.normal()
    return y.astype(np.float32)


def _simulate_hmm(T):
    """Observations of phase 14's Gaussian HMM from a numpy seed."""
    rng = np.random.default_rng(1)
    P = np.asarray(HMM_PARAMS["trans_mat"], np.float64)
    x = rng.integers(len(P))
    y = np.empty(T)
    for t in range(T):
        if t > 0:
            x = rng.choice(len(P), p=P[x])
        y[t] = HMM_PARAMS["mus"][x] + HMM_PARAMS["sigmas"][x] * rng.normal()
    return y.astype(np.float32)


def phase_zoo(torch, dev, smi, y, kf_logLt, main_ms):
    """Phase 14: the guided and auxiliary filters and the model zoo."""
    from particles_tpu_torch import hmm, kalman, ops
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.core import SMC, multiSMC

    all_launches, checks = {}, []
    resampling_kernels = ("systematic_z", "repeat_by_z")

    def full_width(tag, fk, T, ESSrmin, seed):
        """A run through the iterator protocol, the counts zeroed just
        before it and read just after: B1 and B2 once a resampling step
        and no other kernel.  The weights B1 got (the auxiliary ones for
        an APF) and the particles B2 moved, at t = 1, T/2 and T - 1, are
        checked against the plain versions afterwards; then a warm run of
        the same filter is timed."""
        _zero_counts(ops)
        pf = SMC(fk=fk, N=N_MAIN, seed=seed, ESSrmin=ESSrmin)
        inputs = {}
        while pf.t < T:
            X = pf.X
            next(pf)
            if pf.t - 1 in (1, T // 2, T - 1):
                inputs[pf.t - 1] = (pf.aux.lw, X)
        for _ in pf:        # the end of the run: the summaries stacked
            pass
        launches = _read_counts(ops)
        all_launches[f"phase 14 {tag}"] = launches
        n_rs = int(pf.summaries.rs_flags.sum())
        logLt = float(pf.logLt)
        _check(np.isfinite(logLt), f"phase 14 {tag}: logLt {logLt}")
        for name, n in launches.items():
            want = n_rs if name in resampling_kernels else 0
            _check(n == want and n_rs > 0, f"phase 14 {tag}: {name} "
                   f"launched {n} times, {n_rs} resampling steps")
        for t, (lw, X) in inputs.items():
            checks.append(check_path_kernels(
                torch, dev, f"phase 14 {tag} t={t}", lw, X, (), seed=t))
        warm = SMC(fk=fk, N=N_MAIN, seed=seed + 1, ESSrmin=ESSrmin)
        warm.run()
        return {"logLt": logLt, "resampling_steps": n_rs,
                "launches": launches, "logLt_warm_run": float(warm.logLt),
                "ms_per_step": 1000.0 * warm.cpu_time / T}

    # the main path's model and data with the guided and auxiliary filters
    ssm = kalman.LinearGauss(rho=RHO, sigmaX=SIGX, sigmaY=SIGY)
    data = torch.from_numpy(y).to(dev)
    lg = {}
    for cls in ("GuidedPF", "AuxiliaryPF", "AuxiliaryBootstrap"):
        rec = full_width(f"LinearGauss {cls}",
                         getattr(ssms, cls)(ssm=ssm, data=data), T_MAIN,
                         0.5, 40)
        for key in ("logLt", "logLt_warm_run"):
            _check(abs(rec[key] - kf_logLt) < LOGLT_TOL,
                   f"phase 14 LinearGauss {cls}: {key} {rec[key]}, Kalman "
                   f"{kf_logLt}")
        rec.update(abs_diff=abs(rec["logLt"] - kf_logLt),
                   ratio_to_main_path=rec["ms_per_step"] / main_ms)
        lg[cls] = rec

    # a Gaussian HMM against Baum-Welch, the states int64 particles
    y_hmm = _simulate_hmm(T_MAIN)
    model = hmm.GaussianHMM(**{k: torch.tensor(v, device=dev)
                               for k, v in HMM_PARAMS.items()})
    exact = float(hmm.BaumWelch(hmm=hmm.GaussianHMM(**{
        k: torch.tensor(v, dtype=torch.float64, device=dev)
        for k, v in HMM_PARAMS.items()}), data=torch.from_numpy(y_hmm)).logLt)
    rec = full_width("GaussianHMM Bootstrap", ssms.Bootstrap(
        ssm=model, data=torch.from_numpy(y_hmm).to(dev)), T_MAIN, 0.5, 50)
    for key in ("logLt", "logLt_warm_run"):
        _check(abs(rec[key] - exact) < LOGLT_TOL,
               f"phase 14 GaussianHMM: {key} {rec[key]}, BaumWelch {exact}")
    rec.update(baum_welch_logLt=exact, abs_diff=abs(rec["logLt"] - exact),
               ratio_to_main_path=rec["ms_per_step"] / main_ms)
    hmm_rec = rec

    # StochVol at the JAX package's APF shape: N = 2^20, T = 100, always
    # resampling; the sd of each filter's logLt from its spread over seeds
    sv_model = ssms.StochVol()
    y_sv = torch.from_numpy(_simulate_sv(sv_model, T_SV)).to(dev)
    sv = {}
    for cls in ("Bootstrap", "AuxiliaryPF", "AuxiliaryBootstrap"):
        fk = getattr(ssms, cls)(ssm=sv_model, data=y_sv)
        rec = full_width(f"StochVol {cls}", fk, T_SV, 1.1, 60)
        runs = [rec["logLt"]]
        for s in range(1, SV_SEEDS):
            pf = SMC(fk=fk, N=N_MAIN, seed=60 + 10 * s, ESSrmin=1.1)
            pf.run()
            runs.append(float(pf.logLt))
        _check(np.all(np.isfinite(runs)), f"phase 14 StochVol {cls}: {runs}")
        rec.update(logLt_seeds=runs, sd=float(np.std(runs, ddof=1)))
        sv[cls] = rec
    boot = sv["Bootstrap"]
    for cls in ("AuxiliaryPF", "AuxiliaryBootstrap"):
        rec = sv[cls]
        sd = float(np.hypot(rec["sd"], boot["sd"]))
        rec["diff_to_bootstrap"] = rec["logLt"] - boot["logLt"]
        rec["diff_in_sd"] = rec["diff_to_bootstrap"] / sd
        _check(abs(rec["diff_in_sd"]) <= SV_SDS,
               f"phase 14 StochVol {cls}: {rec['diff_in_sd']} sd from the "
               "bootstrap filter")

    # ROADMAP C.7's data (the model simulated on the CPU from generator
    # seed 0, |y| 2.41 at t = 1).  There a run of an auxiliary filter now
    # and then collapses far below the bootstrap filter, in the JAX
    # package too (AuxiliaryPF: 5 of 64 runs at N = 2^20, AuxiliaryBootstrap
    # every run), so AuxiliaryPF is held by its median: within SV_SDS of
    # the bootstrap filter's median, in units of the hypot of the
    # bootstrap's sd and AuxiliaryPF's robust sd (1.4826 MAD).
    # AuxiliaryBootstrap is recorded, not checked.
    _, y_hard = sv_model.simulate(torch.Generator().manual_seed(0), T_SV)
    hard = {"largest_abs_y": float(y_hard.abs().max())}
    for cls in ("Bootstrap", "AuxiliaryPF", "AuxiliaryBootstrap"):
        fk = getattr(ssms, cls)(ssm=sv_model, data=y_hard.to(dev))
        runs = []
        for s in range(SV_SEEDS):
            pf = SMC(fk=fk, N=N_MAIN, seed=90 + s, ESSrmin=1.1)
            pf.run()
            runs.append(float(pf.logLt))
        _check(np.all(np.isfinite(runs)),
               f"phase 14 StochVol C.7 data {cls}: {runs}")
        med = float(np.median(runs))
        hard[cls] = {"logLt_seeds": runs, "median": med,
                     "sd": float(np.std(runs, ddof=1)),
                     "robust_sd": 1.4826 * float(np.median(
                         np.abs(np.asarray(runs) - med)))}
    boot = hard["Bootstrap"]
    for rec in hard.values():
        if isinstance(rec, dict):
            rec["collapsed"] = sum(v < boot["median"] - 1.0
                                   for v in rec["logLt_seeds"])
    apf = hard["AuxiliaryPF"]
    apf["median_diff_in_sd"] = ((apf["median"] - boot["median"])
                                / float(np.hypot(boot["sd"],
                                                 apf["robust_sd"])))
    _check(abs(apf["median_diff_in_sd"]) <= SV_SDS,
           f"phase 14 StochVol C.7 data AuxiliaryPF: median "
           f"{apf['median_diff_in_sd']} sd from the bootstrap filter's")
    sv["c7_data"] = hard

    # every other zoo model at N_ZOO through multiSMC over the six schemes
    zoo_models = {
        "StochVol": ssms.StochVol(),
        "StochVolLeverage": ssms.StochVolLeverage(phi=-0.5),
        "Gordon_etal": ssms.Gordon_etal(),
        "BearingsOnly": ssms.BearingsOnly(),
        "DiscreteCox": ssms.DiscreteCox(),
        "MVStochVol": ssms.MVStochVol(**{
            k: torch.tensor(v, device=dev) for k, v in MV_SV.items()}),
        "ThetaLogistic": ssms.ThetaLogistic(),
    }
    gen = torch.Generator(device=dev).manual_seed(70)
    fks = {}
    for name, m in zoo_models.items():
        _, y_m = m.simulate(gen, T_ZOO)
        fks[name] = ssms.Bootstrap(ssm=m, data=y_m)
        if name in ("StochVol", "StochVolLeverage", "ThetaLogistic"):
            fks[f"{name} GuidedPF"] = ssms.GuidedPF(ssm=m, data=y_m)
        if name == "StochVol":
            fks[f"{name} AuxiliaryPF"] = ssms.AuxiliaryPF(ssm=m, data=y_m)
    snaps = []

    def snapshot(res):
        snaps.append(_read_counts(ops))
        return res

    _zero_counts(ops)
    snaps.append(_read_counts(ops))
    runs = multiSMC(fk=fks, N=N_ZOO, resampling=SCHEMES, nruns=1,
                    out_func=snapshot)
    zoo = {}
    for k, entry in enumerate(runs):
        scheme, res = entry["resampling"], entry["output"]
        tag = f"{entry['fk']} {scheme}"
        n_rs = int(res.rs_flags.sum())
        logLt = float(res.logLt)
        launched = {name: snaps[k + 1][name] - snaps[k][name]
                    for name in ops.KERNELS}
        _check(np.isfinite(logLt), f"phase 14 {tag}: logLt {logLt}")
        for name, n in launched.items():
            want = n_rs if name in SCHEME_KERNELS[scheme] else 0
            _check(n == want, f"phase 14 {tag}: {name} launched {n} times, "
                              f"{n_rs} resampling steps")
        zoo.setdefault(entry["fk"], {})[scheme] = {
            "logLt": logLt, "resampling_steps": n_rs,
            "ms_per_step": 1000.0 * res.cpu_time / T_ZOO}
    all_launches["phase 14 zoo multiSMC"] = _read_counts(ops)
    # BearingsOnly's (N, 4) rows through B1 and B2 (the payload of a run's
    # last step)
    pf = SMC(fk=fks["BearingsOnly"], N=N_ZOO, seed=80)
    pf.run()
    checks.append(check_path_kernels(torch, dev, "phase 14 BearingsOnly",
                                     pf.wgts.lw, pf.X, (), seed=80))
    _emit({"phase": 14, "nvidia_smi": smi, "N": N_MAIN,
           "main_path_ms_per_step": main_ms,
           "linear_gauss": {"T": T_MAIN, "ESSrmin": 0.5,
                            "kalman_logLt": kf_logLt,
                            "tolerance": LOGLT_TOL, **lg},
           "gaussian_hmm": {"T": T_MAIN, "K": len(HMM_PARAMS["mus"]),
                            "tolerance": LOGLT_TOL, **hmm_rec},
           "stoch_vol": {"T": T_SV, "ESSrmin": 1.1, "seeds": SV_SEEDS,
                         "tolerance_sd": SV_SDS, **sv},
           "zoo": {"N": N_ZOO, "T": T_ZOO, "runs": zoo},
           "kernels_vs_plain": _path_checks_summary(checks)})
    return all_launches, checks


def phase_sqmc(torch, dev, smi, y, kf_logLt, main_ms):
    """Phase 15: SQMC and QMC FFBS.  Each part reports its seconds on
    stderr as it ends."""
    import warnings

    t_start = time.perf_counter()

    def progress(part):
        print(f"phase 15: {part} done at "
              f"{time.perf_counter() - t_start:.1f} s", file=sys.stderr,
              flush=True)

    from particles_tpu_torch import hilbert, kalman, ops, rqmc
    from particles_tpu_torch import resampling as rs
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.core import SQMC, SMC, multiSMC

    sqmc_kernels = ("normalised_cumsum", "repeat_by_su")
    all_launches, checks = {}, []

    def held(tag, launches, steps):
        for name, n in launches.items():
            want = steps if name in sqmc_kernels else 0
            _check(n == want, f"phase 15 {tag}: {name} launched {n} times, "
                              f"{steps} steps")
        all_launches[f"phase 15 {tag}"] = launches

    ssm = kalman.LinearGauss(rho=RHO, sigmaX=SIGX, sigmaY=SIGY)
    fk = ssms.Bootstrap(ssm=ssm, data=torch.from_numpy(y).to(dev))

    # the main run through the iterator protocol: the sorted points of the
    # steps whose kernel inputs are checked afterwards are kept by a
    # wrapper of the closed-form draw the step calls
    keep_at = {1, T_MAIN // 2, T_MAIN - 1}
    kept, draw = {}, rqmc.sobol_sorted0

    def keeping_draw(*args, **kwargs):
        out = draw(*args, **kwargs)
        if pf.t in keep_at:
            kept[pf.t] = out
        return out

    _zero_counts(ops)
    pf = SQMC(fk=fk, N=N_MAIN, seed=15)
    next(pf)
    torch.cuda.synchronize()
    inputs = {}
    rqmc.sobol_sorted0 = keeping_draw
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(T_MAIN - 1):
                    X = pf.X
                    next(pf)
                    if pf.t - 1 in keep_at:
                        inputs[pf.t - 1] = (pf.aux.lw, X)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        rqmc.sobol_sorted0 = draw
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    for _ in pf:
        pass
    launches = _read_counts(ops)
    progress("the main run")
    held("SQMC", launches, T_MAIN - 1)
    logLt = float(pf.logLt)
    _check(abs(logLt - kf_logLt) < LOGLT_TOL,
           f"phase 15: |logLt - Kalman| = {abs(logLt - kf_logLt)}")
    _check(syncs == 0, f"phase 15: {syncs} host syncs in {T_MAIN - 1} "
                       "SQMC steps")
    _check(bool(pf.summaries.rs_flags[1:].all())
           and pf.X.shape == (N_MAIN,) and bool(torch.isfinite(pf.X).all())
           and bool((pf.X[1:] >= pf.X[:-1]).all()),
           "phase 15: every step resamples, the last particles finite and "
           "in Hilbert order")
    # B3 and B4 on the phase's own inputs: the weights and the sorted
    # points of t = 1, T/2 and T - 1, the particles as B4's payload
    for t in sorted(inputs):
        lw, X = inputs[t]
        W = rs.exp_and_normalise(lw)
        _, db3 = check_b3(torch, ops, dev, f"phase 15 t={t} B3",
                          W.cpu().numpy())
        su = kept[t][:, 0].contiguous()
        _check(bool((su[1:] >= su[:-1]).all()), f"phase 15 t={t}: su")
        check_b4(torch, ops, f"phase 15 t={t} B4", su, rs.pinned_cdf(W), [X])
        checks.append({"tag": f"phase 15 SQMC t={t}", "N": N_MAIN,
                       "M": [N_MAIN], "B3": 1, "B4": 1,
                       "normalised_cumsum_err": db3, "repeat_by_su_err": 0})
    progress("the kernel checks")

    # a warm run timed
    warm = SQMC(fk=fk, N=N_MAIN, seed=16)
    warm.run()
    ms = 1000.0 * warm.cpu_time / T_MAIN
    _check(abs(float(warm.logLt) - kf_logLt) < LOGLT_TOL,
           f"phase 15 warm run: logLt {float(warm.logLt)}")
    # device ms from profiler windows, in a fresh process (in this one,
    # after phase 10's windows, the profiler drops kernels): B3 and B4 on
    # the main run's inputs of t = T/2 (the same seed replays the same
    # run), the next 20 steps by CUDA kernel, the Sobol draw and the
    # Hilbert sort alone
    tool = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "profile_torch_sqmc.py"),
         "--seed", "15"], capture_output=True, text=True, timeout=600)
    _check(tool.returncode == 0, f"phase 15: tools/profile_torch_sqmc.py "
                                 f"failed: {tool.stderr[-2000:]}")
    prof = json.loads(tool.stdout.strip().splitlines()[-1])
    device_ms = prof["step_device_ms"]

    progress("the warm run and the profiler windows")

    # the spread of logLt over seeds at N = 2^16, SQMC against SMC
    spread = {}
    for name, make in (("SQMC", lambda s: SQMC(fk=fk, N=N_SPREAD, seed=s)),
                       ("SMC", lambda s: SMC(fk=fk, N=N_SPREAD, seed=s))):
        runs = []
        for s in range(SPREAD_SEEDS):
            p = make(200 + s)
            p.run()
            runs.append(float(p.logLt))
        _check(np.all(np.isfinite(runs)), f"phase 15 spread {name}: {runs}")
        spread[name] = {"logLt_seeds": runs,
                        "sd": float(np.std(runs, ddof=1))}
    _check(spread["SQMC"]["sd"] < spread["SMC"]["sd"],
           f"phase 15: SQMC's sd {spread['SQMC']['sd']} not below SMC's "
           f"{spread['SMC']['sd']}")

    progress("the spread over seeds")

    # the Hilbert-key path: MVLinearGauss_Guarniero_etal, dx = 2 and 3
    mv = {}
    for dx in (2, 3):
        cpu_model = kalman.MVLinearGauss_Guarniero_etal(dx=dx, device="cpu")
        _, y_mv = cpu_model.simulate(torch.Generator().manual_seed(dx), T_MV)
        exact = float(kalman.Kalman(ssm=cpu_model,
                                    data=y_mv.double()).logLt)
        fk_mv = ssms.Bootstrap(
            ssm=kalman.MVLinearGauss_Guarniero_etal(dx=dx, device=dev),
            data=y_mv.to(dev))
        _zero_counts(ops)
        p = SQMC(fk=fk_mv, N=N_MAIN, seed=30 + dx)
        p.run()
        held(f"MVLinearGauss dx={dx}", _read_counts(ops), T_MV - 1)
        rec = {"logLt": float(p.logLt), "kalman_logLt": exact,
               "abs_diff": abs(float(p.logLt) - exact),
               "ms_per_step": 1000.0 * p.cpu_time / T_MV,
               "nbits": hilbert.sort_nbits(N_MAIN, dx)}
        _check(rec["abs_diff"] < LOGLT_TOL,
               f"phase 15 MVLinearGauss dx={dx}: {rec}")
        mv[f"dx={dx}"] = rec

    progress("the multivariate runs")

    # multiSMC(qmc=True) over 4 runs
    _zero_counts(ops)
    out = multiSMC(fk=fk, N=N_MAIN, qmc=True, nruns=4, seed=15)
    held("multiSMC", _read_counts(ops), 4 * (T_MAIN - 1))
    multi = [float(e["output"].logLt) for e in out]
    _check(all(np.isfinite(v) and abs(v - kf_logLt) < LOGLT_TOL
               for v in multi), f"phase 15 multiSMC: {multi}")

    progress("multiSMC")

    # QMC FFBS from an SQMC history against the Kalman smoother; the sd at
    # each t from the spread over the seeds
    y_s = y[:T_FFBS]
    exact_s = kalman_targets(y_s, 1)["mean"]
    fk_s = ssms.Bootstrap(ssm=ssm, data=torch.from_numpy(y_s).to(dev))
    ests, pass_ms, ffbs_launches = [], [], None
    for s in range(SPREAD_SEEDS):
        p = SQMC(fk=fk_s, N=N_FFBS, seed=50 + s, store_history=True)
        p.run()
        gen = torch.Generator(device=dev).manual_seed(60 + s)
        _zero_counts(ops)
        paths, wall = _sync_ms(
            torch, lambda: p.hist.backward_sampling_qmc(gen, M_FFBS))
        if ffbs_launches is None:
            ffbs_launches = _read_counts(ops)
            held("QMC FFBS pass", ffbs_launches, 1)
        pass_ms.append(wall)
        _check(paths.shape == (T_FFBS, M_FFBS)
               and bool(torch.isfinite(paths).all()),
               f"phase 15 QMC FFBS seed {s}: paths")
        ests.append(paths.mean(1).cpu().numpy().astype(np.float64))
    ests = np.stack(ests)
    sd_t = ests.std(0, ddof=1)
    err_sd = np.abs(ests - exact_s) / sd_t
    _check(np.all(np.isfinite(err_sd)) and err_sd.max() <= SMOOTH_SDS,
           f"phase 15 QMC FFBS: {err_sd.max():.2f} sd at t = "
           f"{int(err_sd.max(0).argmax())}")

    progress("QMC FFBS")

    # the card against the CPU: the points of every scramble and of the
    # sorted set, and the Hilbert keys, for the same words and integers
    gen = torch.Generator().manual_seed(15)
    n_equal = 0
    for scramble in ("lms_shift", "shift", "owen"):
        words = rqmc.scramble_words(gen, 2, scramble)
        on_dev = {k: v.to(dev) for k, v in words.items()}
        pairs = [(rqmc.sobol_from_words(on_dev, N_MAIN, 2, scramble),
                  rqmc.sobol_from_words(words, N_MAIN, 2, scramble))]
        if scramble == "lms_shift":
            pairs.append((rqmc.sobol_sorted0_from_words(on_dev, N_MAIN, 2),
                          rqmc.sobol_sorted0_from_words(words, N_MAIN, 2)))
        for got, want in pairs:
            _check(torch.equal(got.cpu(), want),
                   f"phase 15: {scramble} points on the card differ from "
                   "the CPU's")
            n_equal += 1
    for dx in (2, 3):
        nbits = hilbert.sort_nbits(N_MAIN, dx)
        c = torch.randint(0, 2 ** nbits, (N_MAIN, dx), generator=gen)
        _check(torch.equal(hilbert.hilbert_index(c.to(dev), nbits).cpu(),
                           hilbert.hilbert_index(c, nbits)),
               f"phase 15: Hilbert keys dx={dx} differ from the CPU's")
        n_equal += 1

    _emit({"phase": 15, "nvidia_smi": smi, "N": N_MAIN, "T": T_MAIN,
           "logLt": logLt, "kalman_logLt": kf_logLt,
           "abs_diff": abs(logLt - kf_logLt), "tolerance": LOGLT_TOL,
           "launches": launches, "host_syncs": syncs,
           "logLt_warm_run": float(warm.logLt), "ms_per_step": ms,
           "main_path_ms_per_step": main_ms,
           "ratio_to_main_path": ms / main_ms,
           "profile": {**prof, "busy_share": (None if device_ms is None
                                               else device_ms / ms)},
           "spread": {"N": N_SPREAD, "seeds": SPREAD_SEEDS, **spread},
           "multivariate": {"T": T_MV, **mv},
           "multiSMC": {"runs": multi,
                        "abs_diff": [abs(v - kf_logLt) for v in multi]},
           "qmc_ffbs": {"N": N_FFBS, "M": M_FFBS, "T": T_FFBS,
                        "seeds": SPREAD_SEEDS, "max_err_sd": float(
                            err_sd.max()), "tolerance_sd": SMOOTH_SDS,
                        "max_abs_err": float(np.abs(ests - exact_s).max()),
                        "ms_per_pass": pass_ms,
                        "launches_per_pass": ffbs_launches},
           "card_equals_cpu_bit_for_bit": n_equal,
           "kernels_vs_plain": _path_checks_summary(checks)})
    return all_launches, checks


def _sampler_classes():
    """The phase's static models: the conjugate Gaussian mean of the JAX
    package's tests and the logistic regression of its Pima example (data
    rows y_i x_i, theta = b0..b{p-1})."""
    import torch

    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import smc_samplers as ssp

    class GaussianMean(ssp.StaticModel):
        """y_t ~ N(mu, 1), mu ~ N(0, 1)."""

        def logpyt(self, theta, t):
            return dists.Normal(loc=theta["mu"]).logpdf(self.data[t])

    class LogisticRegression(ssp.StaticModel):
        def logpyt(self, theta, t):
            p = self.data.shape[1]
            beta = torch.stack([theta[f"b{j}"] for j in range(p)], -1)
            return -torch.nn.functional.softplus(-(beta @ self.data[t]))

    return GaussianMean, LogisticRegression


def conjugate_targets():
    """y (T_CONJ, numpy seed 0, as tests/test_smc_samplers.py), its exact
    log-evidence (y ~ N(0, I + 11^T)), posterior mean and variance."""
    import scipy.stats as st

    y = np.random.default_rng(0).normal(loc=1.5, size=T_CONJ).astype(
        np.float32)
    exact = float(st.multivariate_normal(
        np.zeros(T_CONJ), np.eye(T_CONJ) + np.ones((T_CONJ, T_CONJ))
    ).logpdf(y))
    post_var = 1.0 / (1.0 + T_CONJ)
    return y, exact, post_var * float(y.astype(np.float64).sum()), post_var


def logistic_model(torch, dev, name):
    """``LogisticRegression`` on ``datasets.<name>()`` with the example's
    prior, theta = b0..b{p-1} ~ N(0, 5^2); returns (model, data)."""
    from particles_tpu_torch import datasets
    from particles_tpu_torch import distributions as dists

    _, LogisticRegression = _sampler_classes()
    data = getattr(datasets, name)().data.astype(np.float32)
    p = data.shape[1]
    prior = dists.StructDist({f"b{j}": dists.Normal(scale=5.0)
                              for j in range(p)})
    return LogisticRegression(data=torch.from_numpy(data).to(dev),
                              prior=prior), data


def newton_map(data):
    """The Newton MAP of the logistic regression under the N(0, 5^2)
    prior (examples/tempering_logistic_regression.py)."""
    D = np.asarray(data, float)
    p = D.shape[1]
    b = np.zeros(p)
    for _ in range(50):
        s = 1.0 / (1.0 + np.exp(D @ b))
        grad = D.T @ s - b / 25.0
        H = -(D.T * (s * (1.0 - s))) @ D - np.eye(p) / 25.0
        step = np.linalg.solve(H, grad)
        b = b - step
        if np.max(np.abs(step)) < 1e-8:
            break
    return b


def phase_samplers(torch, dev, smi, main_ms):
    """Phase 16: the SMC samplers.  Each part reports its seconds on
    stderr as it ends."""
    import warnings

    from particles_tpu_torch import collectors, ops
    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import resampling as rs
    from particles_tpu_torch import smc_samplers as ssp
    from particles_tpu_torch.core import SMC, multiSMC

    t_start = time.perf_counter()

    def progress(part):
        print(f"phase 16: {part} done at "
              f"{time.perf_counter() - t_start:.1f} s", file=sys.stderr,
              flush=True)

    GaussianMean, _ = _sampler_classes()
    y, exact, post_mean, post_var = conjugate_targets()
    conj = GaussianMean(data=torch.from_numpy(y).to(dev),
                        prior=dists.StructDist({"mu": dists.Normal()}))
    N0 = N_SAMPLER * P_SAMPLER
    all_launches, checks = {}, []

    class AccRate(collectors.Collector):
        """The move's acceptance rate at each step (on the device)."""

        summary_name = "acc_rates"
        uses_genealogy = False

        def collect(self, view):
            return view.X.shared["acc_rate"]

    def make(kind):
        if kind == "IBIS":
            return ssp.IBIS(model=conj, len_chain=P_SAMPLER)
        if kind == "Tempering":
            return ssp.Tempering(model=conj, len_chain=P_SAMPLER,
                                 exponents=TEMPERING_EXPONENTS)
        return ssp.AdaptiveTempering(model=conj, len_chain=P_SAMPLER)

    def counted(tag, fk, M, seed, scheme="systematic", reads=None):
        """One run through the iterator protocol: host syncs counted after
        step 0 (as in phase 11), launches, and the record."""
        _zero_counts(ops)
        pf = SMC(fk=fk, N=M, seed=seed, resampling=scheme,
                 collect=[AccRate()])
        t0 = time.perf_counter()
        next(pf)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in pf:
                    pass
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)
        launches = _read_counts(ops)
        all_launches[f"phase 16 {tag}"] = launches
        n_rs = int(pf.summaries.rs_flags.sum())
        leaves = len(pf.X._leaves()[0])
        logLt = float(pf.logLt)
        _check(np.isfinite(logLt), f"phase 16 {tag}: logLt {logLt}")
        scheme_kernels = SCHEME_KERNELS[scheme]
        for name, n in launches.items():
            per = -(-leaves // ops.MAX_PAYLOADS) if name == "repeat_by_z" \
                else 1
            want = n_rs * per if name in scheme_kernels else 0
            _check(n == want and n_rs > 0,
                   f"phase 16 {tag}: {name} launched {n} times, {n_rs} "
                   f"resampling steps, {leaves} leaves")
        # the reads: the decision a step (IBIS, Tempering), or done's
        # exponent test before each step and once to end (AdaptiveTempering)
        steps = pf.t - 1
        if reads is None:
            always = getattr(fk, "always_resample", False)
            want_syncs = steps + 1 if always else steps
        else:
            want_syncs = reads(steps)
        _check(syncs == want_syncs, f"phase 16 {tag}: {syncs} host syncs in "
                                    f"{steps} steps, expected {want_syncs}")
        row_bytes = sum(a.element_size() * a[0].numel()
                        for a in pf.X._leaves()[0])
        rec = {"N": M, "N0": pf.X.N, "T": pf.t, "logLt": logLt,
               "resampling_steps": n_rs, "leaves": leaves,
               "launches": launches, "host_syncs": syncs,
               "acc_rates": [float(a) for a in pf.summaries.acc_rates],
               "bytes_served_per_resampling_step": {
                   "written": M * row_bytes, "rows_read": M * row_bytes,
                   "z_read": 4 * pf.X.N},
               "counted_run_s": wall}
        return pf, rec

    def warm(fk, M, seed):
        """ms a step of a run timed by ``run()``."""
        pf = SMC(fk=fk, N=M, seed=seed)
        pf.run()
        return 1000.0 * pf.cpu_time / pf.t

    def post_stats(pf):
        mu = pf.X.theta["mu"].double()
        W = pf.wgts.W.double()
        m = float((W * mu).sum())
        return m, float((W * mu * mu).sum()) - m * m

    # the spread of logLt and of the posterior mean over SPREAD_SEEDS
    # seeds at N_SAMPLER_SPREAD particles (M = N_SAMPLER_SPREAD / P)
    kinds = ("IBIS", "Tempering", "AdaptiveTempering")
    spread = {}
    M_s = N_SAMPLER_SPREAD // P_SAMPLER
    for kind in kinds:
        lls, means = [], []
        for s in range(SPREAD_SEEDS):
            pf = SMC(fk=make(kind), N=M_s, seed=300 + s)
            pf.run()
            lls.append(float(pf.logLt))
            means.append(post_stats(pf)[0])
        _check(np.all(np.isfinite(lls)), f"phase 16 spread {kind}: {lls}")
        spread[kind] = {"logLt_seeds": lls, "mean_seeds": means,
                        "logLt_sd": float(np.std(lls, ddof=1)),
                        "mean_sd": float(np.std(means, ddof=1))}
    progress("the spread over seeds")

    conj_runs = {}
    for k, kind in enumerate(kinds):
        pf, rec = counted(f"conjugate {kind}", make(kind), N_SAMPLER,
                          160 + k)
        m, v = post_stats(pf)
        sd = spread[kind]
        rec.update(exact_logLt=exact, abs_diff=abs(rec["logLt"] - exact),
                   tolerance=LOGLT_TOL,
                   err_in_spread_sd=abs(rec["logLt"] - exact)
                   / sd["logLt_sd"],
                   posterior_mean=m, exact_posterior_mean=post_mean,
                   posterior_var=v, exact_posterior_var=post_var,
                   mean_err_in_spread_sd=abs(m - post_mean) / sd["mean_sd"])
        _check(rec["abs_diff"] < LOGLT_TOL,
               f"phase 16 conjugate {kind}: |logLt - exact| "
               f"{rec['abs_diff']}")
        _check(rec["mean_err_in_spread_sd"] < SAMPLER_SDS,
               f"phase 16 conjugate {kind}: posterior mean {m}, exact "
               f"{post_mean}, {rec['mean_err_in_spread_sd']} sd")
        rec["ms_per_step"] = warm(make(kind), N_SAMPLER, 170 + k)
        rec["ratio_to_main_path"] = rec["ms_per_step"] / main_ms
        conj_runs[kind] = rec
        progress(f"conjugate {kind}")

    # AdaptiveTempering, not waste-free, the adaptive move: a read a chain
    # step on top of done's; each move's chain steps counted
    moves = []

    class CountedMove(ssp.AdaptiveMCMCSequence):
        def __call__(self, gen, x, target, draws=None):
            steps = []
            step_with = self.mcmc.step_with

            def counting(*a, **kw):
                steps.append(1)
                return step_with(*a, **kw)

            self.mcmc.step_with = counting
            try:
                return super().__call__(gen, x, target, draws)
            finally:
                del self.mcmc.step_with
                moves.append(len(steps))

    move = CountedMove(len_chain=ADAPTIVE_LEN_CHAIN, adaptive=True)

    def reads(steps):
        # done's reads, and the move's: after each chain step but the
        # last a move may take
        return steps + 1 + sum(min(k, move.nsteps - 1) for k in moves)

    pf, rec = counted("conjugate AdaptiveTempering adaptive move",
                      ssp.AdaptiveTempering(model=conj, wastefree=False,
                                            move=move),
                      N_SAMPLER_SPREAD, 180, reads=reads)
    rec.update(abs_diff=abs(rec["logLt"] - exact), chain_steps=moves,
               max_chain_steps=move.nsteps)
    _check(rec["abs_diff"] < LOGLT_TOL and pf.X.N == N_SAMPLER_SPREAD,
           f"phase 16 adaptive move: {rec}")
    conj_runs["AdaptiveTempering adaptive move"] = rec
    progress("the adaptive move")

    # multiSMC, stratified (B3) and multinomial (B3, B5), N0 = 2^16
    _zero_counts(ops)
    snaps = [_read_counts(ops)]

    def snapshot(res):
        snaps.append(_read_counts(ops))
        return res

    multi = multiSMC(fk=make("AdaptiveTempering"),
                     N=M_s, nruns=1, seed=16,
                     resampling=["stratified", "multinomial"],
                     out_func=snapshot)
    multi_rec = {}
    for k, entry in enumerate(multi):
        scheme, res = entry["resampling"], entry["output"]
        n_rs = int(res.rs_flags.sum())
        launched = {n: snaps[k + 1][n] - snaps[k][n] for n in ops.KERNELS}
        all_launches[f"phase 16 multiSMC {scheme}"] = launched
        for name, n in launched.items():
            want = n_rs if name in SCHEME_KERNELS[scheme] else 0
            _check(n == want and n_rs > 0, f"phase 16 multiSMC {scheme}: "
                                           f"{name} launched {n} times")
        multi_rec[scheme] = {"logLt": float(res.logLt),
                             "abs_diff": abs(float(res.logLt) - exact),
                             "resampling_steps": n_rs, "launches": launched}
        _check(multi_rec[scheme]["abs_diff"] < LOGLT_TOL,
               f"phase 16 multiSMC {scheme}: {multi_rec[scheme]}")
    progress("multiSMC")

    # Pima at the JAX package's shape (bench.py: N = 100, len_chain = 30),
    # then at M = N_SAMPLER, P = P_SAMPLER with B1 and B2's inputs kept
    pima, pima_data = logistic_model(torch, dev, "Pima")
    b_map = newton_map(pima_data)
    p = pima_data.shape[1]

    def pima_checks(tag, pf):
        W = pf.wgts.W.double()
        post = np.array([float((W * pf.X.theta[f"b{j}"].double()).sum())
                         for j in range(p)])
        ps = float(pf.X.shared["path_sampling"])
        rec = {"path_sampling": ps,
               "abs_diff_path_sampling": abs(float(pf.logLt) - ps),
               "max_abs_diff_newton_map": float(np.abs(post - b_map).max()),
               "exponent": float(pf.X.shared["exponent"])}
        _check(rec["abs_diff_path_sampling"] < PIMA_PS_TOL
               and rec["max_abs_diff_newton_map"] < PIMA_MAP_TOL
               and rec["exponent"] == 1.0, f"phase 16 {tag}: {rec}")
        return rec

    pf, rec = counted("Pima N=100", ssp.AdaptiveTempering(
        model=pima, len_chain=PIMA_LEN_CHAIN), PIMA_N, 190)
    rec.update(pima_checks("Pima N=100", pf))
    rec["ms_per_step"] = warm(ssp.AdaptiveTempering(
        model=pima, len_chain=PIMA_LEN_CHAIN), PIMA_N, 191)
    pima_runs = {"N=100 len_chain=30": rec}
    progress("Pima at N = 100")

    kept_z, kept_serve = [], []
    z_fn, serve = rs.systematic_z_fused, ssp.ThetaParticles.subset_by_z

    def keeping_z(W, u, M):
        z = z_fn(W, u, M)
        kept_z.append((W, u, M, z))
        return z

    def keeping_serve(self, z, M):
        out = serve(self, z, M)
        kept_serve.append((z, M, self._leaves()[0], out._leaves()[0]))
        return out

    rs.systematic_z_fused = keeping_z
    ssp.ThetaParticles.subset_by_z = keeping_serve
    try:
        pf, rec = counted("Pima 2^20", ssp.AdaptiveTempering(
            model=pima, len_chain=P_SAMPLER), N_SAMPLER, 192)
    finally:
        rs.systematic_z_fused = z_fn
        ssp.ThetaParticles.subset_by_z = serve
    rec.update(pima_checks("Pima 2^20", pf))
    # B1 and B2 on the run's own inputs: the N0 weights and every leaf
    # served, at the first, a middle and the last resampling step
    n = len(kept_z)
    _check(n == rec["resampling_steps"] == len(kept_serve),
           f"phase 16 Pima 2^20: kept {n} resampling steps")
    for i in sorted({0, n // 2, n - 1}):
        W, u, M, z = kept_z[i]
        zk, dp, do, _, _ = check_b1(torch, ops, dev,
                                    f"phase 16 Pima step {i} B1",
                                    W.cpu().numpy(), float(u), M)
        _check(torch.equal(zk, z), f"phase 16 Pima step {i}: B1 differs "
                                   "from the run's z")
        z2, M2, leaves, served = kept_serve[i]
        _check(z2 is z and M2 == M, f"phase 16 Pima step {i}: z")
        plain, _ = ops.repeat_cols_plain(z, M, leaves)
        check_b2(torch, f"phase 16 Pima step {i} B2",
                 [("sampler leaves", (served, None), (plain, None))])
        checks.append({"tag": f"phase 16 Pima 2^20 resampling step {i}",
                       "N": N0, "M": [M], "B1": 1, "B2": 1,
                       "systematic_z_err": dp, "systematic_z_err_vs_float64": do,
                       "repeat_by_z_err": 0, "leaves": len(leaves)})
    del kept_z, kept_serve
    rec["ms_per_step"] = warm(ssp.AdaptiveTempering(
        model=pima, len_chain=P_SAMPLER), N_SAMPLER, 193)
    rec["ratio_to_main_path"] = rec["ms_per_step"] / main_ms
    pima_runs["M=2^14 P=64"] = rec
    progress("Pima at 2^20")

    # Sonar, d = 61, at M = N_SAMPLER, P = P_SAMPLER
    sonar, _ = logistic_model(torch, dev, "Sonar")
    pf, rec = counted("Sonar 2^20", ssp.AdaptiveTempering(
        model=sonar, len_chain=P_SAMPLER), N_SAMPLER, 194)
    ps = float(pf.X.shared["path_sampling"])
    rec.update(path_sampling=ps, abs_diff_path_sampling=abs(
        rec["logLt"] - ps), theta_bytes=sum(
            v.numel() * v.element_size() for v in pf.X.theta.values()),
        ms_per_step=1000.0 * rec["counted_run_s"] / pf.t)
    _check(float(pf.X.shared["exponent"]) == 1.0 and np.isfinite(ps),
           f"phase 16 Sonar: {rec}")
    progress("Sonar at 2^20")

    # device ms a step by CUDA kernel, from a fresh process (see phase 15)
    tool = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "profile_torch_samplers.py")],
        capture_output=True, text=True, timeout=600)
    _check(tool.returncode == 0, f"phase 16: tools/profile_torch_samplers.py "
                                 f"failed: {tool.stderr[-2000:]}")
    prof = json.loads(tool.stdout.strip().splitlines()[-1])
    progress("the profiler window")

    _emit({"phase": 16, "nvidia_smi": smi, "M": N_SAMPLER, "P": P_SAMPLER,
           "N0": N0, "conjugate": {"T": T_CONJ, "exact_logLt": exact,
                                   "runs": conj_runs},
           "spread": {"N0": N_SAMPLER_SPREAD, "seeds": SPREAD_SEEDS,
                      **spread},
           "multiSMC": multi_rec, "pima": pima_runs, "sonar": rec,
           "main_path_ms_per_step": main_ms, "profile": prof,
           "kernels_vs_plain": _path_checks_summary(checks),
           "seconds": time.perf_counter() - t_start})
    return all_launches, checks, pima_runs["M=2^14 P=64"]["logLt"]


def _sync_count(torch, fn):
    """(fn(), host syncs counted under ``set_sync_debug_mode("warn")``)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def _no_sync(torch, fn):
    """``fn()`` under ``set_sync_debug_mode("error")``: a host sync raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _simulate_lg(rho, sigx, sigy, T, seed):
    """(x, y) of the linear Gaussian model from a numpy seed, float32."""
    rng = np.random.default_rng(seed)
    x = np.empty(T)
    x[0] = rng.normal() * sigx / np.sqrt(1 - rho ** 2)
    for t in range(1, T):
        x[t] = rho * x[t - 1] + sigx * rng.normal()
    y = x + sigy * rng.normal(size=T)
    return x.astype(np.float32), y.astype(np.float32)


def lg_grid(y, grid, sigx, sigy):
    """log p(y | rho) of the linear Gaussian model (stationary start) at
    each rho of ``grid``: the scalar Kalman filter in float64, vectorised
    over the grid."""
    y = np.asarray(y, np.float64)
    rho = np.asarray(grid, np.float64)
    m, P = np.zeros_like(rho), sigx ** 2 / (1 - rho ** 2)
    ll = np.zeros_like(rho)
    for t in range(len(y)):
        if t > 0:
            m, P = rho * m, rho ** 2 * P + sigx ** 2
        S = P + sigy ** 2
        ll += -0.5 * (np.log(2 * np.pi * S) + (y[t] - m) ** 2 / S)
        K = P / S
        m, P = m + K * (y[t] - m), (1 - K) * P
    return ll


def _lg_fixed():
    """The fixed-sigma linear Gaussian model of the JAX package's SMC² and
    PMMH tests (sigmaY = 0.5, sigmaX = 1, rho the one parameter)."""
    from particles_tpu_torch import kalman

    class LGfixed(kalman.LinearGauss):
        default_params = {"sigmaY": 0.5, "rho": 0.9, "sigmaX": 1.0,
                          "sigma0": None}

    return LGfixed


def lg_oracle(torch, y, npoints):
    """The evidence, posterior mean and sd of rho ~ U(-0.99, 0.99) in the
    fixed-sigma model, by quadrature on a grid of ``npoints``; the grid's
    log-likelihoods held to the port's ``kalman.Kalman`` at three points."""
    from scipy.special import logsumexp

    from particles_tpu_torch import kalman

    LGfixed = _lg_fixed()
    grid = np.linspace(-0.985, 0.985, npoints)
    lls = lg_grid(y, grid, 1.0, 0.5)
    for i in (0, npoints // 2, npoints - 1):
        kf = kalman.Kalman(ssm=LGfixed(rho=float(grid[i])),
                           data=torch.from_numpy(y).double())
        _check(abs(float(kf.logLt) - lls[i]) < 1e-6,
               f"phase 17: the grid's Kalman at rho={grid[i]}: "
               f"{lls[i]} vs {float(kf.logLt)}")
    ev = float(logsumexp(lls) + np.log(grid[1] - grid[0]) - np.log(1.98))
    post = np.exp(lls - lls.max())
    post /= post.sum()
    mean = float(np.sum(post * grid))
    return ev, mean, float(np.sqrt(np.sum(post * grid ** 2) - mean ** 2))


def phase_outer(torch, dev, smi, y_main):
    """Phase 17: the outer loops over a filter.  Each part reports its
    seconds on stderr as it ends."""
    import tempfile

    from particles_tpu_torch import collectors, datasets, kalman, mcmc, ops
    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import resampling as rs
    from particles_tpu_torch import smc_samplers as ssp
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.core import SMC

    t_start = time.perf_counter()

    def progress(part):
        print(f"phase 17: {part} done at "
              f"{time.perf_counter() - t_start:.1f} s", file=sys.stderr,
              flush=True)

    all_launches, checks, out = {}, [], {}
    LGfixed = _lg_fixed()
    rho_prior = dists.StructDist({"rho": dists.Uniform(a=-0.99, b=0.99)})

    class AccRate(collectors.Collector):
        summary_name = "acc_rates"
        uses_genealogy = False

        def collect(self, view):
            return view.X.shared["acc_rate"]

    # -- SMC² on GBP/USD at the deployment's shape ----------------------------
    y_gbp = datasets.GBP_vs_USD_9798().data.astype(np.float32)
    prior = dists.StructDist({
        "mu": dists.Normal(loc=-1.0, scale=2.0),
        "rho": dists.Uniform(a=-0.99, b=0.99),
        "sigma": dists.Gamma(a=2.0, b=4.0),
        "phi": dists.Uniform(a=-0.99, b=0.99)})
    fk = ssp.SMC2(ssm_cls=ssms.StochVolLeverage, prior=prior,
                  data=torch.from_numpy(y_gbp).to(dev), init_Nx=SMC2_NX,
                  len_chain=SMC2_LEN_CHAIN, ar_to_increase_Nx=SMC2_AR)
    kept_z, kept_serve = [], []
    z_fn, serve = rs.systematic_z_fused, ssp.ThetaParticles.subset_by_z

    def keeping_z(W, u, M):
        z = z_fn(W, u, M)
        kept_z.append((W, u, M, z))
        return z

    def keeping_serve(self, z, M):
        res = serve(self, z, M)
        kept_serve.append((z, M, self._leaves()[0], res._leaves()[0]))
        return res

    _zero_counts(ops)
    pf = SMC(fk=fk, N=SMC2_NTHETA, seed=17, ESSrmin=0.5, collect=[AccRate()])
    rs.systematic_z_fused = keeping_z
    ssp.ThetaParticles.subset_by_z = keeping_serve
    try:
        t0 = time.perf_counter()
        next(pf)
        torch.cuda.synchronize()

        def rest():
            for _ in pf:
                pass

        _, syncs = _sync_count(torch, rest)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rs.systematic_z_fused = z_fn
        ssp.ThetaParticles.subset_by_z = serve
    launches = _read_counts(ops)
    all_launches["phase 17 SMC2 GBP/USD"] = launches
    flags = [bool(f) for f in pf.summaries.rs_flags]
    n_rs = sum(flags)
    T = len(flags)
    want_syncs = (T - 1) + sum(flags[1:T - 1])
    _check(syncs == want_syncs, f"phase 17 SMC2: {syncs} host syncs, "
                                f"expected {want_syncs}")
    leaves = len(pf.X._leaves()[0])
    for name, n in launches.items():
        per = -(-leaves // ops.MAX_PAYLOADS) if name == "repeat_by_z" else 1
        want = n_rs * per if name in ("systematic_z", "repeat_by_z") else 0
        _check(n == want and n_rs > 0, f"phase 17 SMC2: {name} launched {n} "
                                       f"times, {n_rs} resampling steps")
    logLt = float(pf.logLt)
    accs = [float(a) for a, f in zip(pf.summaries.acc_rates, flags) if f]
    _check(np.isfinite(logLt), f"phase 17 SMC2: logLt {logLt}")
    _check(all(0.0 < a < 1.0 for a in accs), f"phase 17 SMC2: acceptance "
                                             f"rates {accs}")
    W = pf.wgts.W.double()
    post = {k: float((W * v.double()).sum()) for k, v in pf.X.theta.items()}
    _check(all(np.isfinite(v) for v in post.values()),
           f"phase 17 SMC2: posterior means {post}")
    n = len(kept_z)
    _check(n == n_rs == len(kept_serve), f"phase 17 SMC2: kept {n} steps")
    served_bytes = []
    for i in sorted({0, n // 2, n - 1}):
        Wi, u, M, z = kept_z[i]
        zk, dp, do, _, _ = check_b1(torch, ops, dev,
                                    f"phase 17 SMC2 step {i} B1",
                                    Wi.cpu().numpy(), float(u), M)
        _check(torch.equal(zk, z), f"phase 17 SMC2 step {i}: B1 differs "
                                   "from the run's z")
        z2, M2, lv, served = kept_serve[i]
        _check(z2 is z and M2 == M, f"phase 17 SMC2 step {i}: z")
        plain, _ = ops.repeat_cols_plain(z, M, lv)
        check_b2(torch, f"phase 17 SMC2 step {i} B2",
                 [("theta-particle rows", (served, None), (plain, None))])
        row_bytes = sum(a.element_size() * a[0].numel() for a in lv)
        served_bytes.append({"step": i,
                             "Nx": max(a.shape[1] for a in lv if a.ndim > 1),
                             "row_bytes": row_bytes,
                             "written": M * row_bytes,
                             "rows_read": M * row_bytes,
                             "z_read": 4 * M})
        checks.append({"tag": f"phase 17 SMC2 resampling step {i}",
                       "N": M, "M": [M], "B1": 1, "B2": 1,
                       "systematic_z_err": dp,
                       "systematic_z_err_vs_float64": do,
                       "repeat_by_z_err": 0, "leaves": len(lv)})
    del kept_z, kept_serve
    out["smc2_gbp"] = {
        "Ntheta": SMC2_NTHETA, "T": T, "init_Nx": SMC2_NX,
        "len_chain": SMC2_LEN_CHAIN, "ar_to_increase_Nx": SMC2_AR,
        "logLt": logLt, "posterior_means": post, "acc_rates": accs,
        "Nx_history": [[SMC2_NX, 0]] + [[nx, t] for t, nx in fk.exchanges],
        "final_Nx": int(pf.X.xs.shape[1]), "resampling_steps": n_rs,
        "host_syncs": syncs, "launches": launches, "leaves": leaves,
        "bytes_served_per_resampling_step": served_bytes,
        "ms_per_step": 1000.0 * wall / T, "wall_s": wall}
    progress("SMC2 on GBP/USD")

    # -- SMC² against the Kalman grid -----------------------------------------
    _, y_lg = _simulate_lg(0.8, 1.0, 0.5, SMC2_ORACLE_T, 2)
    ev, pmean, _ = lg_oracle(torch, y_lg, 400)
    lls, means, nxs = [], [], []
    t0 = time.perf_counter()
    for s in range(SMC2_ORACLE_SEEDS):
        fk = ssp.SMC2(ssm_cls=LGfixed, prior=rho_prior,
                      data=torch.from_numpy(y_lg).to(dev),
                      init_Nx=SMC2_ORACLE_NX, len_chain=SMC2_LEN_CHAIN)
        pf = SMC(fk=fk, N=SMC2_ORACLE_NTHETA, seed=170 + s)
        pf.run()
        lls.append(float(pf.logLt))
        means.append(float((pf.wgts.W.double()
                            * pf.X.theta["rho"].double()).sum()))
    rec = {"Ntheta": SMC2_ORACLE_NTHETA, "init_Nx": SMC2_ORACLE_NX,
           "T": SMC2_ORACLE_T, "logLt_seeds": lls, "mean_seeds": means,
           "exact_logLt": ev, "exact_posterior_mean": pmean,
           "abs_err_logLt": abs(float(np.mean(lls)) - ev),
           "abs_err_mean": abs(float(np.mean(means)) - pmean),
           "tolerances": [SMC2_EV_TOL, SMC2_MEAN_TOL],
           "s_per_run": (time.perf_counter() - t0) / SMC2_ORACLE_SEEDS}
    _check(rec["abs_err_logLt"] < SMC2_EV_TOL
           and rec["abs_err_mean"] < SMC2_MEAN_TOL,
           f"phase 17 SMC2 oracle: {rec}")
    out["smc2_oracle"] = rec
    progress("SMC2 against Kalman")

    # -- PMMH on StochVol at the deployment's shape ---------------------------
    y_sv = _simulate_sv(ssms.StochVol(mu=-1.0, rho=0.9, sigma=0.3), PMMH_T)
    prior_pm = dists.StructDist({
        "mu": dists.Normal(scale=2.0),
        "rho": dists.Uniform(a=-0.99, b=0.99),
        "sigma": dists.Gamma(a=2.0, b=4.0)})
    m = mcmc.PMMH(ssm_cls=ssms.StochVol, prior=prior_pm,
                  data=torch.from_numpy(y_sv).to(dev), Nx=PMMH_NX,
                  niter=PMMH_NITER, nchains=PMMH_CHAINS, seed=171)
    _zero_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _no_sync(torch, m._chain)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m._finish()
    acc = [float(a) for a in m.acc_rate]
    launches = _read_counts(ops)
    _check(all(0.05 < a < 0.9 for a in acc), f"phase 17 PMMH StochVol: "
                                             f"acceptance rates {acc}")
    _check(not any(launches.values()), f"phase 17 PMMH: {launches}")
    chain = {k: v.cpu().numpy() for k, v in m.chain.theta.items()}
    burn = PMMH_NITER // 4
    out["pmmh_stochvol"] = {
        "T": PMMH_T, "Nx": PMMH_NX, "nchains": PMMH_CHAINS,
        "niter": PMMH_NITER, "niter_deployment": 3000, "acc_rates": acc,
        "posterior_means": {k: float(v[burn:].mean())
                            for k, v in chain.items()},
        "host_syncs_in_chain_loop": 0, "launches": launches,
        "ms_per_iteration": 1000.0 * wall / (PMMH_NITER - 1),
        "wall_s": wall}
    progress("PMMH on StochVol")

    # -- PMMH against the Kalman grid -----------------------------------------
    _, y_pm = _simulate_lg(0.8, 1.0, 0.5, PMMH_ORACLE_T, 3)
    _, pm_mean, pm_sd = lg_oracle(torch, y_pm, 100)
    m = mcmc.PMMH(ssm_cls=LGfixed, prior=rho_prior,
                  data=torch.from_numpy(y_pm).to(dev), Nx=PMMH_ORACLE_NX,
                  niter=PMMH_ORACLE_NITER, nchains=PMMH_CHAINS, seed=172)
    t0 = time.perf_counter()
    m.run()
    pooled = m.chain.theta["rho"][PMMH_ORACLE_BURN:].cpu().numpy().ravel()
    rec = {"T": PMMH_ORACLE_T, "Nx": PMMH_ORACLE_NX, "nchains": PMMH_CHAINS,
           "niter": PMMH_ORACLE_NITER, "burn": PMMH_ORACLE_BURN,
           "pooled_mean": float(pooled.mean()), "exact_mean": pm_mean,
           "sd_ratio": float(pooled.std() / pm_sd),
           "acc_rates": [float(a) for a in m.acc_rate],
           "ms_per_iteration": 1000.0 * m.cpu_time / (PMMH_ORACLE_NITER - 1)}
    _check(abs(rec["pooled_mean"] - pm_mean) < PMMH_MEAN_TOL
           and 0.3 < rec["sd_ratio"] < 3.0, f"phase 17 PMMH oracle: {rec}")
    out["pmmh_oracle"] = rec
    progress("PMMH against Kalman")

    # -- CSMC and Particle Gibbs ----------------------------------------------
    y_cs = y_main[:CSMC_T]
    xstar = torch.from_numpy(kalman_targets(y_cs, 1)["mean"].astype(
        np.float32)).to(dev)
    fk = ssms.Bootstrap(ssm=kalman.LinearGauss(rho=RHO, sigmaX=SIGX,
                                               sigmaY=SIGY),
                        data=torch.from_numpy(y_cs).to(dev))
    cpf = mcmc.CSMC(fk=fk, N=CSMC_N, xstar=xstar, seed=173)
    _zero_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _no_sync(torch, cpf._run)
    torch.cuda.synchronize()
    csmc_ms = 1000.0 * (time.perf_counter() - t0) / (CSMC_T - 1)
    launches = _read_counts(ops)
    all_launches["phase 17 CSMC"] = launches
    for name, n in launches.items():
        want = (CSMC_T - 1 if name in ("running_max", "normalised_cumsum",
                                       "merge_rank_counts", "repeat_by_z")
                else 0)
        _check(n == want, f"phase 17 CSMC: {name} launched {n} times")
    h = cpf.hist
    _check(torch.equal(h.X[:, 0], xstar) and bool((h.A[:, 0] == 0).all()),
           "phase 17 CSMC: particle 0 not pinned")
    _check(np.isfinite(float(cpf.logLt)), f"phase 17 CSMC: {cpf.logLt}")
    gen = torch.Generator(device=dev).manual_seed(174)
    for t in (0, CSMC_T // 2, CSMC_T - 2):
        W = rs.Weights(h.lw[t]).W
        cs_k, db3 = check_b3(torch, ops, dev, f"phase 17 CSMC t={t} B3",
                             W.cpu().numpy())
        su = rs.uniform_spacings(gen, CSMC_N)
        zk = ops.merge_rank_counts(su, cs_k, CSMC_N)
        _check(torch.equal(zk, ops.merge_rank_counts_plain(su, cs_k, CSMC_N)),
               f"phase 17 CSMC t={t}: B5 differs from plain")
        checks.append({"tag": f"phase 17 CSMC t={t}", "N": CSMC_N,
                       "B3": 1, "B5": 1, "normalised_cumsum_err": db3,
                       "merge_rank_counts_err": 0})

    class PG(mcmc.ParticleGibbs):
        def update_theta(self, gen, theta, x):
            xp, xc = x[:-1], x[1:]
            prec = (xp * xp).sum() + 1.0
            draw = ((xp * xc).sum() / prec
                    + torch.randn((), generator=gen, device=x.device)
                    / prec.sqrt())
            return {"rho": draw.clamp(-0.99, 0.99)}

    _, y_pg = _simulate_lg(0.8, 1.0, 0.5, CSMC_T, 4)
    pg = PG(ssm_cls=LGfixed, prior=rho_prior,
            data=torch.from_numpy(y_pg).to(dev), Nx=PG_NX, niter=PG_SWEEPS,
            seed=175)
    pg.run()
    pg_chain = pg.chain.theta["rho"].cpu().numpy()
    pg_mean = float(pg_chain[PG_BURN:].mean())
    _check(abs(pg_mean - 0.8) < PG_TOL, f"phase 17 Particle Gibbs: mean "
                                        f"{pg_mean}, chain {pg_chain}")
    out["csmc"] = {"T": CSMC_T, "N": CSMC_N, "pinned": True,
                   "host_syncs_per_step": 0, "launches": launches,
                   "logLt": float(cpf.logLt), "ms_per_step": csmc_ms}
    out["particle_gibbs"] = {"T": CSMC_T, "Nx": PG_NX, "sweeps": PG_SWEEPS,
                             "burn": PG_BURN, "mean": pg_mean, "true": 0.8,
                             "ms_per_sweep": 1000.0 * pg.cpu_time
                             / PG_SWEEPS}
    progress("CSMC and Particle Gibbs")

    # -- the checkpoint ---------------------------------------------------------
    tmp = tempfile.mkdtemp()
    ckpt = {}

    def round_trip(tag, make, t_save, same):
        ref = make(180)
        for _ in ref:
            pass
        pf1 = make(180)
        for _ in range(t_save):
            next(pf1)
        path = os.path.join(tmp, f"{len(ckpt)}.pt")
        pf1.save_state(path)
        pf2 = make(181)
        pf2.load_state(path)
        for _ in pf2:
            pass
        ok = same(pf2, ref)
        ckpt[tag] = {"t_saved": t_save, "T": pf2.t, "bit_identical": ok,
                     "logLt": float(pf2.logLt),
                     "checkpoint_bytes": os.path.getsize(path)}
        _check(ok, f"phase 17 checkpoint {tag}: the resumed run differs")

    lg = kalman.LinearGauss(rho=RHO, sigmaX=SIGX, sigmaY=SIGY)
    fk_main = ssms.Bootstrap(ssm=lg, data=torch.from_numpy(y_main).to(dev))

    def same_filter(a, b):
        return float(a.logLt) == float(b.logLt) and torch.equal(a.X, b.X)

    round_trip("main path", lambda s: SMC(fk=fk_main, N=N_MAIN, seed=s),
               CKPT_T, same_filter)
    round_trip("qmc", lambda s: SMC(fk=fk_main, N=CKPT_QMC_N, seed=s,
                                    qmc=True), CKPT_T, same_filter)
    GaussianMean, _ = _sampler_classes()
    y_c, _, _, _ = conjugate_targets()
    conj = GaussianMean(data=torch.from_numpy(y_c).to(dev),
                        prior=dists.StructDist({"mu": dists.Normal()}))

    def same_ibis(a, b):
        return (float(a.logLt) == float(b.logLt)
                and torch.equal(a.X.theta["mu"], b.X.theta["mu"])
                and list(a.hist.times) == list(b.hist.times)
                and torch.equal(a.hist.X[0].theta["mu"],
                                b.hist.X[0].theta["mu"]))

    round_trip("IBIS store_history=3",
               lambda s: SMC(fk=ssp.IBIS(model=conj, len_chain=P_SAMPLER),
                             N=N_SAMPLER, seed=s, store_history=3),
               CKPT_IBIS_T, same_ibis)
    out["checkpoint"] = ckpt
    progress("the checkpoint")

    _emit({"phase": 17, "nvidia_smi": smi, **out,
           "kernels_vs_plain": _path_checks_summary(checks),
           "seconds": time.perf_counter() - t_start})
    return all_launches, checks


def expanded_design(raw):
    """Main effects, squares (but of the binary CHAS) and pairwise
    interactions of the 13 Boston predictors, standardised: (506, 103)
    and the names (copied from examples/binary_smc_boston_interactions.py,
    which imports JAX)."""
    cols, names = [], []
    base = {k: raw[:, i] for i, k in enumerate(BOSTON_NAMES)}
    for i, k in enumerate(BOSTON_NAMES):
        cols.append(base[k])
        names.append(k)
        if k != "CHAS":
            cols.append(base[k] ** 2)
            names.append(f"{k}^2")
        for j in range(i):
            k2 = BOSTON_NAMES[j]
            cols.append(base[k] * base[k2])
            names.append(f"{k} x {k2}")
    X = np.stack(cols, axis=1)
    X = (X - X.mean(axis=0)) / X.std(axis=0)
    return X, names


def boston_data():
    """(X (506, 103), y the standardised log price, the predictors' names,
    whether the data is the synthetic surrogate), X and y float32."""
    from particles_tpu_torch import datasets

    ds = datasets.Boston()
    raw = np.asarray(ds.raw_data, np.float64)
    y = np.log(raw[:, -1])
    y = (y - y.mean()) / y.std()
    X, names = expanded_design(raw[:, :-1])
    return X.astype(np.float32), y.astype(np.float32), names, ds.synthetic


def toy_design():
    """The toy of tests/test_binary_smc.py cut to p = 5: (X, y, active)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(TOY_N, TOY_P)).astype(np.float32)
    beta = np.array([1.5, -1.0, 0.0, 0.8, 0.0], np.float32)
    y = (X @ beta + 0.5 * rng.normal(size=TOY_N)).astype(np.float32)
    return X, y, beta != 0


def nested_evidence_model(torch, dev):
    """The conjugate Gaussian mean of examples/nested_sampling_evidence.py
    (T = 20, y from numpy seed 1): (model, exact log-evidence)."""
    import scipy.stats as st

    from particles_tpu_torch import distributions as dists

    GaussianMean, _ = _sampler_classes()
    y = np.random.default_rng(1).normal(loc=1.0, size=NS_CONJ_T).astype(
        np.float32)
    exact = float(st.multivariate_normal(
        np.zeros(NS_CONJ_T), np.eye(NS_CONJ_T) + np.ones((NS_CONJ_T,
                                                          NS_CONJ_T))
    ).logpdf(y))
    return GaussianMean(data=torch.from_numpy(y).to(dev),
                        prior=dists.StructDist({"mu": dists.Normal()})), exact


def phase_nested(torch, dev, smi, pima_logLt):
    """Phase 18: binary SMC and nested sampling.  Each part reports its
    seconds on stderr as it ends."""
    from particles_tpu_torch import binary_smc as bs
    from particles_tpu_torch import collectors, nested, ops
    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import resampling as rs
    from particles_tpu_torch import smc_samplers as ssp
    from particles_tpu_torch.core import SMC

    t_start = time.perf_counter()

    def progress(part):
        print(f"phase 18: {part} done at "
              f"{time.perf_counter() - t_start:.1f} s", file=sys.stderr,
              flush=True)

    all_launches, checks, out = {}, [], {}

    class AccRate(collectors.Collector):
        summary_name = "acc_rates"
        uses_genealogy = False

        def collect(self, view):
            return view.X.shared["acc_rate"]

    def counted(tag, fk, M, seed, keep=False):
        """One run through the iterator protocol: B1 once and B2
        ceil(leaves / 8) times a resampling step and no other kernel; host
        reads counted after step 0 (done's, before each step and once to
        end); with ``keep``, B1's inputs and B2's leaves at every
        resampling step.  Returns (pf, record, kept)."""
        kept_z, kept_serve = [], []
        z_fn, serve = rs.systematic_z_fused, ssp.ThetaParticles.subset_by_z

        def keeping_z(W, u, M):
            z = z_fn(W, u, M)
            kept_z.append((W, u, M, z))
            return z

        def keeping_serve(self, z, M):
            res = serve(self, z, M)
            kept_serve.append((z, M, self._leaves()[0], res._leaves()[0]))
            return res

        _zero_counts(ops)
        pf = SMC(fk=fk, N=M, seed=seed, collect=[AccRate()])
        if keep:
            rs.systematic_z_fused = keeping_z
            ssp.ThetaParticles.subset_by_z = keeping_serve
        try:
            t0 = time.perf_counter()
            next(pf)
            torch.cuda.synchronize()
            _, syncs = _sync_count(torch, lambda: [None for _ in pf])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            rs.systematic_z_fused = z_fn
            ssp.ThetaParticles.subset_by_z = serve
        launches = _read_counts(ops)
        all_launches[f"phase 18 {tag}"] = launches
        n_rs = int(pf.summaries.rs_flags.sum())
        leaves = pf.X._leaves()[0]
        per = -(-len(leaves) // ops.MAX_PAYLOADS)
        for name, n in launches.items():
            want = 0
            if name in SCHEME_KERNELS["systematic"]:
                want = n_rs * (per if name == "repeat_by_z" else 1)
            _check(n == want and n_rs > 0,
                   f"phase 18 {tag}: {name} launched {n} times, {n_rs} "
                   f"resampling steps, {len(leaves)} leaves")
        steps = pf.t - 1
        _check(syncs == steps + 1, f"phase 18 {tag}: {syncs} host syncs in "
                                   f"{steps} steps, expected {steps + 1}")
        row_bytes = sum(a.element_size() * a[0].numel() for a in leaves)
        rec = {"N": M, "N0": pf.X.N, "T": pf.t, "logLt": float(pf.logLt),
               "resampling_steps": n_rs, "leaves": len(leaves),
               "launches": launches, "host_syncs": syncs,
               "acc_rates": [float(a) for a in pf.summaries.acc_rates],
               "bytes_served_per_resampling_step": {
                   "written": M * row_bytes, "rows_read": M * row_bytes,
                   "z_read": 4 * pf.X.N},
               "wall_s": wall, "ms_per_step": 1000.0 * wall / max(steps, 1)}
        return pf, rec, (kept_z, kept_serve)

    def kernels_on_kept(tag, kept, N0):
        """B1 (phase 2's tolerance) and B2 (exact) on a run's own inputs at
        its first, a middle and its last resampling step."""
        kept_z, kept_serve = kept
        n = len(kept_z)
        _check(n == len(kept_serve) and n > 0,
               f"phase 18 {tag}: kept {n} resampling steps")
        for i in sorted({0, n // 2, n - 1}):
            W, u, M, z = kept_z[i]
            zk, dp, do, _, _ = check_b1(torch, ops, dev,
                                        f"phase 18 {tag} step {i} B1",
                                        W.cpu().numpy(), float(u), M)
            _check(torch.equal(zk, z), f"phase 18 {tag} step {i}: B1 "
                                       "differs from the run's z")
            z2, M2, leaves, served = kept_serve[i]
            _check(z2 is z and M2 == M, f"phase 18 {tag} step {i}: z")
            plain, _ = ops.repeat_cols_plain(z, M, leaves)
            check_b2(torch, f"phase 18 {tag} step {i} B2",
                     [("sampler leaves", (served, None), (plain, None))])
            checks.append({
                "tag": f"phase 18 {tag} resampling step {i}", "N": N0,
                "M": [M], "B1": 1, "B2": 1, "systematic_z_err": dp,
                "systematic_z_err_vs_float64": do, "repeat_by_z_err": 0,
                "leaves": len(leaves),
                "leaf_dtypes": sorted({str(a.dtype) for a in leaves}),
                "widest_row_bytes": max(a.element_size() * a[0].numel()
                                        for a in leaves)})

    def binary_fk(model, P):
        move = ssp.MCMCSequenceWF(mcmc=bs.BinaryMetropolis(), len_chain=P)
        return ssp.AdaptiveTempering(model=model, len_chain=P, move=move)

    def inclusion(pf):
        W = pf.wgts.W.double()
        return (W[:, None] * pf.X.theta["gamma"].double()).sum(0).cpu(
            ).numpy()

    # -- binary SMC on the expanded Boston design, dense and sparse prior ----
    X, y, names, synthetic = boston_data()
    p = X.shape[1]
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    boston, incl = {}, {}
    for label, q, kw, seed in (("dense", 0.5, {}, 180),
                               ("sparse", 0.05, {"nu": 0.0, "iv2": 0.01},
                                181)):
        prior = dists.StructDist({"gamma": dists.IID(bs.Bernoulli(q), p)})
        model = bs.BayesianVS(data=(Xd, yd), prior=prior, **kw)
        pf, rec, kept = counted(f"Boston {label}",
                                binary_fk(model, BOSTON_P), BOSTON_M, seed,
                                keep=label == "dense")
        inc = inclusion(pf)
        incl[label] = inc
        top = np.argsort(-inc)[:15]
        rec.update(prior_p=q, model_kwargs=kw,
                   expected_size=float(inc.sum()),
                   top15={names[j]: float(inc[j]) for j in top},
                   exponent=float(pf.X.shared["exponent"]))
        _check(np.isfinite(rec["logLt"]) and rec["exponent"] == 1.0,
               f"phase 18 Boston {label}: logLt {rec['logLt']}")
        _check(bool(np.all((inc >= 0) & (inc <= 1 + 1e-6))),
               f"phase 18 Boston {label}: inclusion outside [0, 1]")
        _check(pf.X.theta["gamma"].dtype == torch.bool
               and pf.X.N == BOSTON_M * BOSTON_P,
               f"phase 18 Boston {label}: gamma")
        if label == "dense":
            kernels_on_kept(f"Boston {label}", kept, pf.X.N)
            gamma_final, dense_model = pf.X.theta["gamma"], model
        del kept
        boston[label] = rec
        progress(f"Boston {label}")
    _check(incl["sparse"].sum() < incl["dense"].sum(),
           f"phase 18: sparse E|gamma| {incl['sparse'].sum()} not under "
           f"dense {incl['dense'].sum()}")
    best = {names[j] for j in np.argsort(-incl["dense"])[:15]}
    if not synthetic:
        _check(bool(best & {"LSTAT", "RM", "LSTAT^2", "RM^2"}),
               f"phase 18: the dense top 15 {best} lack LSTAT and RM")
    out["boston"] = {"n": X.shape[0], "p": p, "M": BOSTON_M, "P": BOSTON_P,
                     "synthetic": synthetic, "runs": boston}

    # -- chol_and_friends at N0 on the card against float64 ----------------
    N0 = gamma_final.shape[0]
    vm2 = dense_model.iv2
    (L, ldet, wtw), chol_ms = _sync_ms(torch, lambda: bs.chol_and_friends(
        gamma_final, dense_model.xtx, dense_model.xty, vm2))
    rows = np.random.default_rng(18).choice(N0, CHOL_ROWS, replace=False)
    g = gamma_final[torch.from_numpy(rows).to(dev)].cpu().numpy()
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    xtx, xty = X64.T @ X64, X64.T @ y64
    err = {"ldet": 0.0, "wtw": 0.0}
    for i, gi in enumerate(g):
        C = np.linalg.cholesky(xtx[np.ix_(gi, gi)]
                               + float(vm2) * np.eye(gi.sum()))
        w = np.linalg.solve(C, xty[gi])
        for k, got, want in (("ldet", ldet, np.log(np.diag(C)).sum()),
                             ("wtw", wtw, w @ w)):
            e = abs(float(got[rows[i]]) - want) / max(abs(want), 1e-30)
            err[k] = max(err[k], e)
        _check(float(L[rows[i]]) == gi.sum(), "phase 18 chol: len_gam")
    _check(max(err.values()) < CHOL_RTOL, f"phase 18 chol: {err}")
    out["chol_and_friends"] = {"N0": N0, "p": p, "rows": CHOL_ROWS,
                               "max_rel_err_vs_float64": err,
                               "tolerance": CHOL_RTOL, "ms": chol_ms}
    del gamma_final
    progress("chol_and_friends")

    # -- the toy against enumeration ----------------------------------------
    Xt, yt, active = toy_design()
    prior = dists.StructDist({"gamma": dists.IID(bs.Bernoulli(0.5),
                                                 TOY_P)})
    toy = bs.BayesianVS(data=(torch.from_numpy(Xt).to(dev),
                              torch.from_numpy(yt).to(dev)), prior=prior)
    gammas, lp = toy.complete_enum()
    post = torch.softmax(lp.double(), 0)
    exact = (gammas.double() * post[:, None]).sum(0).cpu().numpy()
    ests = []
    for s in range(TOY_SEEDS):
        pf, rec, _ = counted(f"toy seed {s}", binary_fk(toy, TOY_LEN_CHAIN),
                             TOY_M, 185 + s)
        ests.append(inclusion(pf))
    est = np.mean(ests, axis=0)
    mae = float(np.abs(est - exact).mean())
    _check(mae < TOY_TOL and est[active].min() > est[~active].max(),
           f"phase 18 toy: {est} against {exact}")
    out["toy"] = {"n": TOY_N, "p": TOY_P, "M": TOY_M, "P": TOY_LEN_CHAIN,
                  "seeds": TOY_SEEDS, "inclusion": est.tolist(),
                  "enumerated": exact.tolist(), "mean_abs_err": mae,
                  "tolerance": TOY_TOL, "last_run": rec}
    progress("the toy")

    # -- NS-SMC: Pima at N0 = 2^20, the conjugate mean over seeds ----------
    pima, _ = logistic_model(torch, dev, "Pima")
    fk = nested.NestedSamplingSMC(model=pima, len_chain=P_SAMPLER,
                                  ESSrmin=NS_ESSRMIN)
    pf, rec, _ = counted("NS-SMC Pima", fk, N_SAMPLER, 186)
    ns_pima = float(pf.X.shared["log_evid"])
    rec.update(log_evid=ns_pima, levels=pf.t,
               adaptive_tempering_logLt=pima_logLt,
               abs_diff=abs(ns_pima - pima_logLt), tolerance=NS_PIMA_TOL,
               last_level=float(pf.X.shared["lt"]))
    _check(np.isfinite(ns_pima) and rec["abs_diff"] < NS_PIMA_TOL,
           f"phase 18 NS-SMC Pima: log_evid {ns_pima}, adaptive tempering "
           f"{pima_logLt}")
    out["ns_smc_pima"] = rec
    progress("NS-SMC Pima")
    conj, exact = nested_evidence_model(torch, dev)
    M_conj = NS_CONJ_N0 // P_SAMPLER
    evids = []
    for s in range(NS_CONJ_SEEDS):
        pf, rec, _ = counted(f"NS-SMC conjugate seed {s}",
                             nested.NestedSamplingSMC(
                                 model=conj, len_chain=P_SAMPLER,
                                 ESSrmin=NS_ESSRMIN), M_conj, 187 + s)
        evids.append(float(pf.X.shared["log_evid"]))
    _check(abs(np.mean(evids) - exact) < NS_CONJ_TOL,
           f"phase 18 NS-SMC conjugate: {evids}, exact {exact}")
    out["ns_smc_conjugate"] = {"T": NS_CONJ_T, "N0": NS_CONJ_N0,
                               "log_evid_seeds": evids, "exact": exact,
                               "abs_diff_mean": abs(np.mean(evids) - exact),
                               "tolerance": NS_CONJ_TOL, "last_run": rec}
    progress("NS-SMC conjugate")

    # -- vanilla NS: no host read inside a chunk ----------------------------
    def vanilla(tag, model, N, nsteps, seed):
        ns = nested.Nested_RWmoves(model=model, N=N, nsteps=nsteps,
                                   seed=seed)
        chunk = ns._chunk
        ns._chunk = lambda *a: _no_sync(torch, lambda: chunk(*a))
        _zero_counts(ops)
        ns.run()
        launches = _read_counts(ops)
        all_launches[f"phase 18 {tag}"] = launches
        _check(all(n == 0 for n in launches.values()),
               f"phase 18 {tag}: launched {launches}")
        n = len(ns.lZhats)
        rec = {"N": N, "nsteps": nsteps, "contractions": n,
               "chunks": n // max(N // 2, 10), "lZ": float(ns.lZhats[-1]),
               "wall_s": ns.cpu_time,
               "ms_per_contraction": 1000.0 * ns.cpu_time / n}
        _check(np.isfinite(rec["lZ"]), f"phase 18 {tag}: {rec}")
        return rec

    rec = vanilla("vanilla NS conjugate", conj, VANILLA_CONJ_N,
                  VANILLA_CONJ_NSTEPS, 190)
    rec.update(exact=exact, abs_diff=abs(rec["lZ"] - exact),
               tolerance=VANILLA_CONJ_TOL)
    _check(rec["abs_diff"] < VANILLA_CONJ_TOL,
           f"phase 18 vanilla NS conjugate: {rec}")
    out["vanilla_conjugate"] = rec
    progress("vanilla NS conjugate")
    rec = vanilla("vanilla NS Pima", pima, VANILLA_PIMA_N,
                  VANILLA_PIMA_NSTEPS, 191)
    rec.update(ns_smc=ns_pima, abs_diff=abs(rec["lZ"] - ns_pima),
               tolerance=VANILLA_PIMA_TOL)
    _check(rec["abs_diff"] < VANILLA_PIMA_TOL,
           f"phase 18 vanilla NS Pima: {rec}")
    out["vanilla_pima"] = rec
    progress("vanilla NS Pima")

    # device ms a step by CUDA kernel, from a fresh process (see phase 15)
    tool = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "profile_torch_nested.py")],
        capture_output=True, text=True, timeout=600)
    _check(tool.returncode == 0, f"phase 18: tools/profile_torch_nested.py "
                                 f"failed: {tool.stderr[-2000:]}")
    out["profile"] = json.loads(tool.stdout.strip().splitlines()[-1])
    progress("the profiler window")

    _emit({"phase": 18, "nvidia_smi": smi, **out,
           "kernels_vs_plain": _path_checks_summary(checks),
           "seconds": time.perf_counter() - t_start})
    return all_launches, checks


def check_b5_on_scheme_uniforms(torch, fk):
    """ROADMAP C.13: phase 9's multinomial and residual runs again (the
    same run seeds, so the same uniforms), every B5 call held against its
    plain version on its own inputs; with the calls whose uniforms or
    cumulative weights came out of order (a float cumsum on the card can
    leave neighbours an ulp apart)."""
    from particles_tpu_torch import ops
    from particles_tpu_torch import resampling as rs
    from particles_tpu_torch.core import multiSMC

    real = rs._merge_rank_counts
    rec = {}
    now = {}

    def checked(su, cs, M):
        out = real(su, cs, M)
        r = rec[now["scheme"]]
        r["calls"] += 1
        r["su_pairs_out_of_order"] += int((su[1:] < su[:-1]).sum())
        r["cs_pairs_out_of_order"] += int((cs[1:] < cs[:-1]).sum())
        r["differ_from_plain"] += int(not torch.equal(
            out, ops.merge_rank_counts_plain(su, cs, M)))
        return out

    rs._merge_rank_counts = checked
    try:
        for scheme in ("multinomial", "residual"):
            now["scheme"] = scheme
            rec[scheme] = {"calls": 0, "su_pairs_out_of_order": 0,
                           "cs_pairs_out_of_order": 0,
                           "differ_from_plain": 0}
            multiSMC(fk=fk, N=N_MAIN, resampling=scheme, nruns=1)
    finally:
        rs._merge_rank_counts = real
    for scheme, r in rec.items():
        _check(r["calls"] > 0 and r["differ_from_plain"] == 0,
               f"phase 9 {scheme}: B5 against its plain version on the "
               f"run's own uniforms: {r}")
    return rec


def _dist_given_arrays(seed, N):
    """Phase 19's given global arrays, the same in every process: weights
    k_i 2^-24 (k_i < 16, so every float sum is exact), Dirichlet(1)
    weights, particles and the shared uniform."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 16, N)
    k[-1] += 1
    return {"exact": (k * 2.0 ** -24).astype(np.float32),
            "dirichlet": _dirichlet_like(rng, "dirichlet1", N),
            "x": rng.normal(size=N).astype(np.float32),
            "u": np.float32(rng.random())}


def _same(a, b):
    """``a`` and ``b`` equal, tensors by dtype and value, through tuples
    and lists."""
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if a is None or b is None:
        return a is b
    return a.dtype == b.dtype and bool(a.equal(b))


class _CheckedKernels:
    """While active, every call of B2 (``repeat_cols``), B5
    (``merge_rank_counts``) and B6 (``running_max``), which the rings
    reach through ``ops`` and the sorted spacings through ``resampling``,
    and of B3 (``normalised_cumsum_exact``) and B4 (``repeat_cols_su``,
    also behind ``ancestors_by_su``), which sharded FFBS reaches through
    ``resampling``, is held against its plain version
    on the same inputs: exactly, B3 within N 2^-31 + 1e-6 and
    nondecreasing with its top within 1e-6 of 1, as in ``check_b3``.  The
    kernel's own launch is counted as always, the plain version launches
    nothing.  ``calls`` counts the checked calls, ``b3_err`` the largest
    |cs - plain|."""

    def __init__(self, torch, ops, rs, tag="phase 19"):
        self.torch, self.ops, self.rs, self.tag = torch, ops, rs, tag
        self.calls = {"repeat_by_z": 0, "merge_rank_counts": 0,
                      "running_max": 0, "normalised_cumsum": 0,
                      "repeat_by_su": 0}
        self.b3_err = 0.0

    def __enter__(self):
        torch, ops, rs = self.torch, self.ops, self.rs
        self.real = (ops.repeat_cols, ops.merge_rank_counts, ops.running_max)
        self.real_rs = (rs.normalised_cumsum_exact, rs.repeat_cols_su,
                        rs.ancestors_by_su, rs.merge_rank_counts,
                        rs.running_max)
        real_b2, real_b5, real_b6 = self.real
        real_b3, real_b4 = self.real_rs[:2]
        tag = self.tag

        def repeat_cols(z, M, cols, want_anc=False):
            out = real_b2(z, M, cols, want_anc)
            check_b2(torch, f"{tag} B2", [
                ("ring hop", out, ops.repeat_cols_plain(z, M, cols,
                                                        want_anc))])
            self.calls["repeat_by_z"] += 1
            return out

        def merge_rank_counts(su, cs, M):
            out = real_b5(su, cs, M)
            _check(bool((su[1:] >= su[:-1]).all())
                   and bool((cs[1:] >= cs[:-1]).all()),
                   f"{tag} B5: its inputs are out of order")
            _check(torch.equal(out, ops.merge_rank_counts_plain(su, cs, M)),
                   f"{tag} B5: differs from plain")
            self.calls["merge_rank_counts"] += 1
            return out

        def running_max(z):
            out = real_b6(z)
            _check(torch.equal(out, ops.running_max_plain(z)),
                   f"{tag} B6: differs from plain")
            self.calls["running_max"] += 1
            return out

        def normalised_cumsum_exact(W):
            out = real_b3(W)
            N = W.shape[0]
            err = float((out - ops.normalised_cumsum_plain(W)).abs().max())
            tol = N * 2.0 ** -31 + 1e-6
            _check(out.dtype == torch.float32 and out.shape == (N,)
                   and bool((out[1:] >= out[:-1]).all())
                   and abs(float(out[-1]) - 1.0) < 1e-6,
                   f"{tag} B3: not a nondecreasing CDF ending at 1")
            _check(err < tol, f"{tag} B3: |cs - plain| = {err} >= {tol}")
            self.b3_err = max(self.b3_err, err)
            self.calls["normalised_cumsum"] += 1
            return out

        def repeat_cols_su(su, cs, M, cols, want_anc=False):
            out = real_b4(su, cs, M, cols, want_anc)
            _check(_same(out, ops.repeat_cols_su_plain(su, cs, M, cols,
                                                       want_anc)),
                   f"{tag} B4: differs from plain")
            self.calls["repeat_by_su"] += 1
            return out

        def ancestors_by_su(su, cs):
            return repeat_cols_su(su, cs, su.shape[0], [], want_anc=True)[1]

        ops.repeat_cols, ops.merge_rank_counts, ops.running_max = (
            repeat_cols, merge_rank_counts, running_max)
        (rs.normalised_cumsum_exact, rs.repeat_cols_su, rs.ancestors_by_su,
         rs.merge_rank_counts, rs.running_max) = (
            normalised_cumsum_exact, repeat_cols_su, ancestors_by_su,
            merge_rank_counts, running_max)
        return self

    def __exit__(self, *exc):
        (self.ops.repeat_cols, self.ops.merge_rank_counts,
         self.ops.running_max) = self.real
        (self.rs.normalised_cumsum_exact, self.rs.repeat_cols_su,
         self.rs.ancestors_by_su, self.rs.merge_rank_counts,
         self.rs.running_max) = self.real_rs


def _timed_comm(torch, comm):
    """Wrap the collectives of ``comm`` so that each is bracketed by
    ``torch.cuda.synchronize()`` and its wall time added up; returns (the
    seconds so far, a function that restores the module)."""
    spent = [0.0]
    real = {k: getattr(comm, k) for k in comm.COLLECTIVES}

    def timed(f):
        def g(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **kw)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            return out
        return g

    for k, f in real.items():
        setattr(comm, k, timed(f))

    def restore():
        for k, f in real.items():
            setattr(comm, k, f)
    return spent, restore


def _dist_rank(device, job):
    """Phase 19 on one rank of a ``launch.spawn`` group (NCCL or gloo):
    the counted runs of ``job["runs"]``, a run with its collectives timed,
    a profiler window, every kernel against its plain version on the
    ring's own inputs, the rings on the given arrays and (under gloo)
    sharded FFBS.  Returns what the parent checks and prints."""
    import torch
    import torch.distributed as dist

    from particles_tpu_torch import convert, core, distctx, kalman, ops
    from particles_tpu_torch import resampling as rs
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.parallel import comm, distributed

    D, d = dist.get_world_size(), dist.get_rank()
    y = job["y"]
    ssm = kalman.LinearGauss(rho=RHO, sigmaX=SIGX, sigmaY=SIGY)

    def fk_of(name, T):
        return getattr(ssms, name)(ssm=ssm,
                                   data=torch.from_numpy(y[:T]).to(device))

    out = {"rank": d, "D": D, "backend": str(dist.get_backend()),
           "device": str(device), "runs": {}}
    for scheme in DIST_SCHEMES:       # warm: kernels, allocator, channels
        distributed.run_shardmap_smc(fk_of("Bootstrap", 20), N_MAIN,
                                     seed=100, resampling=scheme)
    for tag, name, scheme, T, ESSrmin in job["runs"]:
        fk = fk_of(name, T)
        _zero_counts(ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = distributed.run_shardmap_smc(fk, N_MAIN, seed=0,
                                           resampling=scheme,
                                           ESSrmin=ESSrmin)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["runs"][tag] = {
            "fk": name, "scheme": scheme, "T": T, "ESSrmin": ESSrmin,
            "logLt": float(res.logLt),
            "rs_flags": res.rs_flags.cpu().numpy(),
            "launches": _read_counts(ops), "calls": _read_calls(comm),
            "wall_s": wall, "ms_per_step": 1000.0 * wall / T,
            "finite": bool(torch.isfinite(res.X).all())}
    # the collectives' share of a step: each bracketed by synchronize
    spent, restore = _timed_comm(torch, comm)
    try:
        T = job["timed_T"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = distributed.run_shardmap_smc(fk_of("Bootstrap", T), N_MAIN,
                                           seed=5)
        torch.cuda.synchronize()
        out["comm_timed"] = {
            "T": T, "ms_per_step": 1000.0 * (time.perf_counter() - t0) / T,
            "comm_ms_per_step": 1000.0 * spent[0] / T,
            "resampling_steps": int(res.rs_flags.sum())}
    finally:
        restore()
    # a profiler window of steps: this rank's device time and busy share
    from torch.profiler import ProfilerActivity, profile

    pf = core.SMC(fk=fk_of("Bootstrap", T_MAIN), N=N_MAIN // D, seed=6)
    with distctx.dist_context(None, distctx.rank_generator(6, d, device)):
        for _ in range(10):
            next(pf)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(DIST_PROFILE_STEPS):
                next(pf)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key[:60]] = (kernels.get(evt.key[:60], 0.0)
                                     + evt.self_device_time_total / 1000.0)
    dev_ms = sum(kernels.values())
    out["profile"] = {
        "steps": DIST_PROFILE_STEPS,
        "resampling_steps": int(sum(
            pf.summaries.rs_flags[-DIST_PROFILE_STEPS:])),
        "wall_ms_per_step": 1000.0 * wall / DIST_PROFILE_STEPS,
        "device_ms_per_step": dev_ms / DIST_PROFILE_STEPS,
        "busy_share": dev_ms / (1000.0 * wall),
        "top_kernels_ms": dict(sorted(kernels.items(),
                                      key=lambda kv: -kv[1])[:6])}
    # every kernel of the rings against its plain version on the ring's
    # own inputs: T_DIST_CHECK steps, each resampling (ESSrmin = 1)
    with _CheckedKernels(torch, ops, rs) as checked:
        for scheme in DIST_SCHEMES:
            distributed.run_shardmap_smc(
                fk_of("Bootstrap", T_DIST_CHECK), N_MAIN, seed=7,
                resampling=scheme, ESSrmin=1.0)
        # the rings on the given global arrays
        g = _dist_given_arrays(job["given_seed"], N_MAIN)
        x = convert.rank_slice(g["x"], d, D, device)
        u = torch.tensor(g["u"], device=device)
        given = {}
        for kind in ("exact", "dirichlet"):
            w = convert.rank_slice(g[kind], d, D, device)
            yv, A = distributed.ring_systematic_resample(
                x, w, u, N_MAIN, return_ancestors=True)
            given[kind] = (yv, A)
    out["checked_calls"] = checked.calls
    out["given"] = given
    if job.get("ffbs"):
        ys = job["y_smooth"]
        fk = ssms.Bootstrap(ssm=_lg_smooth(kalman),
                            data=torch.from_numpy(ys).to(device))
        res = distributed.run_shardmap_smc(fk, N_SMOOTH, seed=21,
                                           store_history=True)
        _zero_counts(ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = distributed.sharded_backward_mcmc(res.hist, N_SMOOTH,
                                                  seed=5, nsteps=1)
        torch.cuda.synchronize()
        out["ffbs"] = {
            "paths_sum": paths.double().sum(1), "shape": tuple(paths.shape),
            "finite": bool(torch.isfinite(paths).all()),
            "ms_per_backward_step": 1000.0 * (time.perf_counter() - t0)
            / (T_SMOOTH - 1),
            "calls": _read_calls(comm), "launches": _read_counts(ops)}
        # B3 and B4 against their plain versions on this pass's own
        # inputs, in a second pass that the counts above do not see
        with _CheckedKernels(torch, ops, rs) as checked:
            distributed.sharded_backward_mcmc(res.hist, N_SMOOTH, seed=5,
                                              nsteps=1)
        out["ffbs"].update(checked_calls=checked.calls,
                           b3_err=checked.b3_err)
    if job.get("more"):     # phase 20, in the same ranks
        out["more"] = _dist20_rank(device, job["more"])
    return out


def phase_distributed(torch, dev, smi, y, kf_logLt, more=None):
    """Phase 19: the particle-sharded filter, NCCL with one rank a card,
    then D_GLOO gloo ranks on card 0.  ``more``: phase 20's jobs by
    backend (:func:`dist_more_jobs`), which the same ranks run after
    phase 19's work.  Returns the launches and phase 20's rank records
    by backend."""
    from particles_tpu_torch import kalman, ops
    from particles_tpu_torch.parallel import launch

    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    more = more or {}
    job_common = {"y": y, "given_seed": 19, "timed_T": T_GLOO_CUT}
    nccl_job = dict(job_common, more=more.get("nccl"), runs=[
        (f"Bootstrap {s}", "Bootstrap", s, T_MAIN, 0.5)
        for s in DIST_SCHEMES])
    # AuxiliaryPF resamples 38 times in the main path's 1000 steps (phase
    # 14): at ESSrmin = 1 each of the cut's steps runs the ring and the
    # auxiliary reset
    gloo_job = dict(job_common, ffbs=True, y_smooth=_simulate_y(T_SMOOTH),
                    more=more.get("gloo"),
                    runs=[("Bootstrap systematic", "Bootstrap", "systematic",
                           T_GLOO_CUT, 0.5)]
                    + [(f"Bootstrap {s}", "Bootstrap", s, T_GLOO_CUT, 0.5)
                       for s in ("stratified", "multinomial")]
                    + [("AuxiliaryPF systematic ESSrmin=1", "AuxiliaryPF",
                        "systematic", T_GLOO_CUT, 1.0)])
    kf_cut = float(kalman.Kalman(
        ssm=kalman.LinearGauss(rho=RHO, sigmaX=SIGX, sigmaY=SIGY),
        data=torch.from_numpy(y[:T_GLOO_CUT].astype(np.float64))).logLt)
    t0 = time.perf_counter()
    results = {
        "nccl": launch.spawn(_dist_rank, cards, args=(nccl_job,),
                             backend="nccl", device="cuda", timeout=900),
        "gloo": launch.spawn(_dist_rank, D_GLOO, args=(gloo_job,),
                             backend="gloo", device="cuda", timeout=900)}
    more_out = {g: [r["more"] for r in ranks] for g, ranks in results.items()
                if ranks[0].get("more")}
    spawn_wall = time.perf_counter() - t0 - sum(
        max(r["wall_s"] for r in ranks) for ranks in more_out.values())
    out = {"phase": 19, "nvidia_smi": smi, "N": N_MAIN,
           "T_gloo_cut": T_GLOO_CUT, "tolerance": LOGLT_TOL,
           "kalman_logLt": kf_logLt, "kalman_logLt_cut": kf_cut,
           "wall_s": spawn_wall}
    launches = {}
    for group, ranks in results.items():
        D = len(ranks)
        rec = {"D": D, "backend": ranks[0]["backend"],
               "devices": [r["device"] for r in ranks], "runs": {}}
        for tag, run in ranks[0]["runs"].items():
            exact = kf_logLt if run["T"] == T_MAIN else kf_cut
            for r in ranks:
                _check(np.array_equal(r["runs"][tag]["rs_flags"],
                                      run["rs_flags"])
                       and r["runs"][tag]["logLt"] == run["logLt"]
                       and r["runs"][tag]["finite"],
                       f"phase 19 {group} {tag}: rank {r['rank']} differs")
            _check(abs(run["logLt"] - exact) < LOGLT_TOL,
                   f"phase 19 {group} {tag}: logLt {run['logLt']}, Kalman "
                   f"{exact}")
            n_rs = int(run["rs_flags"].sum())
            want = DIST_LAUNCHES[run["scheme"]](D)
            for r in ranks:
                for name, n in r["runs"][tag]["launches"].items():
                    _check(n == want.get(name, 0) * n_rs and n_rs > 0,
                           f"phase 19 {group} {tag} rank {r['rank']}: "
                           f"{name} launched {n} times, {n_rs} resampling "
                           f"steps")
            T = run["T"]
            calls = run["calls"]
            extra = T - 1 if run["fk"] == "AuxiliaryPF" else 0
            _check(calls == {"pmax": T + extra, "psum": T + extra,
                             "all_gather": n_rs,
                             "ring_shift": (D - 1) * n_rs, "exchange": 0},
                   f"phase 19 {group} {tag}: collectives {calls}")
            launches[f"phase 19 {group} {tag}"] = {
                name: sum(r["runs"][tag]["launches"][name] for r in ranks)
                for name in ops.KERNELS}
            rec["runs"][tag] = {
                "fk": run["fk"], "scheme": run["scheme"], "T": T,
                "ESSrmin": run["ESSrmin"],
                "logLt": run["logLt"], "abs_diff": abs(run["logLt"] - exact),
                "resampling_steps": n_rs,
                "launches_per_resampling_step_per_rank": {
                    k: v / n_rs for k, v in run["launches"].items() if v},
                "collectives_per_step": {k: v / T for k, v in calls.items()},
                "ms_per_step": [r["runs"][tag]["ms_per_step"]
                                for r in ranks]}
        rec["comm_timed"] = [r["comm_timed"] for r in ranks]
        rec["profile_rank0"] = ranks[0]["profile"]
        rec["checked_kernel_calls"] = [r["checked_calls"] for r in ranks]
        for r in ranks:
            _check(all(r["checked_calls"][k] > 0 for k in (
                "repeat_by_z", "merge_rank_counts", "running_max")),
                   f"phase 19 {group}: a kernel of the rings never checked "
                   f"{r['checked_calls']}")
        # the ring on the given arrays against the single-device serve
        g = _dist_given_arrays(19, N_MAIN)
        x = torch.from_numpy(g["x"]).to(dev)
        u = torch.tensor(g["u"], device=dev)
        for kind in ("exact", "dirichlet"):
            yv = np.concatenate([r["given"][kind][0] for r in ranks])
            A = np.concatenate([r["given"][kind][1] for r in ranks])
            _check(A.min() >= 0 and A.max() < N_MAIN
                   and (np.diff(A) >= 0).all()
                   and np.array_equal(yv, g["x"][A]),
                   f"phase 19 {group} given {kind}: an output not served "
                   "exactly once")
            z_ring = np.searchsorted(A, np.arange(N_MAIN), side="right")
            W = torch.from_numpy(g[kind]).to(dev)
            if kind == "exact":
                cs = torch.cumsum(W, 0)
                z = (torch.floor(N_MAIN * cs / cs[-1] - u).to(torch.int32)
                     + 1).clamp_(0, N_MAIN)
                z[-1:].fill_(N_MAIN)
                (ys,), As = ops.repeat_cols(ops.running_max(z), N_MAIN, [x],
                                            want_anc=True)
                _check(np.array_equal(yv, ys.cpu().numpy())
                       and np.array_equal(A, As.cpu().numpy()),
                       f"phase 19 {group} given exact: the ring differs "
                       "from the single-device serve")
                rec["given_exact"] = "equal"
            else:
                z1 = ops.systematic_z_fused(W, u, N_MAIN).cpu().numpy()
                dz = int(np.abs(z_ring - z1).max())
                _check(dz <= 1, f"phase 19 {group} given dirichlet: |dz| "
                                f"{dz} against B1")
                rec["given_dirichlet_max_dz_vs_B1"] = dz
        if "ffbs" in ranks[0]:
            tg = kalman_targets(_simulate_y(T_SMOOTH), LAG)
            mean = sum(r["ffbs"]["paths_sum"] for r in ranks) / N_SMOOTH
            for r in ranks:
                _check(r["ffbs"]["finite"] and r["ffbs"]["shape"] == (
                    T_SMOOTH, N_SMOOTH // D), "phase 19 ffbs: paths")
                L = 1
                _check(r["ffbs"]["calls"] == {
                    "pmax": 0, "psum": 0, "ring_shift": 0, "exchange": 0,
                    "all_gather": (L + 1) + (T_SMOOTH - 1) * (L + 2)},
                    f"phase 19 ffbs: collectives {r['ffbs']['calls']}")
                checked = r["ffbs"]["checked_calls"]
                _check(checked["normalised_cumsum"] > 0
                       and checked["repeat_by_su"] > 0,
                       f"phase 19 ffbs: B3 or B4 never checked {checked}")
            rec["sharded_ffbs_mcmc"] = {
                "N": N_SMOOTH, "M": N_SMOOTH, "T": T_SMOOTH,
                **_smooth_check("phase 19 sharded ffbs_mcmc", mean,
                                tg["mean"], np.sqrt(tg["var"]), N_SMOOTH,
                                "ffbs_mcmc"),
                "ms_per_backward_step": [r["ffbs"]["ms_per_backward_step"]
                                         for r in ranks],
                "collectives_per_backward_step_rank0": {
                    k: v / (T_SMOOTH - 1)
                    for k, v in ranks[0]["ffbs"]["calls"].items()},
                "launches_rank0": {k: v for k, v in
                                   ranks[0]["ffbs"]["launches"].items() if v},
                "checked_kernel_calls": [r["ffbs"]["checked_calls"]
                                         for r in ranks],
                "normalised_cumsum_err": max(r["ffbs"]["b3_err"]
                                             for r in ranks)}
            launches["phase 19 gloo sharded ffbs"] = {
                name: sum(r["ffbs"]["launches"][name] for r in ranks)
                for name in ops.KERNELS}
        out[group] = rec
    _emit(out)
    return launches, more_out


def _global_mean(torch, x, lw, group=None):
    """The weighted mean of a rank's ``x`` under the rank's log-weights
    ``lw``, over every rank of ``group`` (float64)."""
    from particles_tpu_torch.parallel import comm

    lw = lw.double()
    w = torch.exp(lw - comm.pmax(lw.max(), group))
    num, den = comm.psum((w * x.double()).sum(), w.sum(), group=group)
    return float(num / den)


def _dist20_rank(device, job):
    """Phase 20 on one rank of a ``launch.spawn`` group (NCCL or gloo):
    each run of ``job["runs"]`` counted (launches, collectives, wall), then,
    for NCCL, the runs again with every B2, B5 and B6 call held against its
    plain version (gloo runs checked the first time).  Returns what the
    parent checks and prints."""
    import contextlib

    import torch
    import torch.distributed as dist

    from particles_tpu_torch import kalman, mcmc, nested, ops
    from particles_tpu_torch import distributions as dists
    from particles_tpu_torch import resampling as rs
    from particles_tpu_torch import smc_samplers as ssp
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.parallel import comm, distributed, sharded

    D, d = dist.get_world_size(), dist.get_rank()
    y = job["y"]
    ssm = kalman.LinearGauss(rho=RHO, sigmaX=SIGX, sigmaY=SIGY)

    def lg(T):
        return ssms.Bootstrap(ssm=ssm, data=torch.from_numpy(y[:T]).to(device))

    pima, _ = logistic_model(torch, device, "Pima")
    GaussianMean, _ = _sampler_classes()
    yc, _, _, _ = conjugate_targets()
    conj = GaussianMean(data=torch.from_numpy(yc).to(device),
                        prior=dists.StructDist({"mu": dists.Normal()}))
    LGfixed = _lg_fixed()
    rho_prior = dists.StructDist({"rho": dists.Uniform(a=-0.99, b=0.99)})

    def sampler(fk, N, seed):
        res = distributed.run_shardmap_smc(fk, N, seed=seed)
        rec = {"logLt": float(res.logLt), "rs_flags": res.rs_flags,
               "leaves": len(res.X._leaves()[0]), "N0_rank": res.X.N,
               "shared": {k: float(v) for k, v in res.X.shared.items()
                          if torch.as_tensor(v).numel() == 1}}
        rec["post_mean"] = {k: _global_mean(torch, v, res.lw)
                            for k, v in res.X.theta.items()
                            if v.ndim == 1}
        return rec

    def sqmc(T, hist):
        res = distributed.run_shardmap_smc(lg(T), N_MAIN, seed=0, qmc=True,
                                           store_history=hist)
        rec = {"logLt": float(res.logLt), "rs_flags": res.rs_flags,
               "finite": bool(torch.isfinite(res.X).all()),
               "sorted": bool((res.X[1:] >= res.X[:-1]).all())}
        if hist:
            A = res.hist.A
            rec.update(A_min=int(A.min()), A_max=int(A.max()),
                       origin_ranks=int(torch.unique(
                           A[1:] // (N_MAIN // D)).numel()))
        return rec

    def smc2(T):
        fk = ssp.SMC2(ssm_cls=ssms.StochVolLeverage, prior=dists.StructDist({
            "mu": dists.Normal(loc=-1.0, scale=2.0),
            "rho": dists.Uniform(a=-0.99, b=0.99),
            "sigma": dists.Gamma(a=2.0, b=4.0),
            "phi": dists.Uniform(a=-0.99, b=0.99)}),
            data=torch.from_numpy(job["y_gbp"][:T]).to(device),
            init_Nx=SMC2_NX, len_chain=SMC2_LEN_CHAIN,
            ar_to_increase_Nx=SMC2_AR)
        res = distributed.run_shardmap_smc(fk, SMC2_NTHETA, seed=17)
        return {"logLt": float(res.logLt), "rs_flags": res.rs_flags,
                "leaves": len(res.X._leaves()[0]),
                "exchanges": list(fk.exchanges),
                "xs": tuple(res.X.xs.shape),
                "acc_rate": float(res.X.shared["acc_rate"]),
                "post_mean": {k: _global_mean(torch, v, res.lw)
                              for k, v in res.X.theta.items()}}

    def pmmh():
        mesh = sharded.make_mesh(axis_names=("chains",),
                                 device_type=device.type)
        m = mcmc.PMMH(ssm_cls=LGfixed, prior=rho_prior,
                      data=torch.from_numpy(job["y_pm"]).to(device),
                      Nx=PMMH_ORACLE_NX, niter=PMMH_DIST_NITER,
                      nchains=PMMH_CHAINS, seed=172, mesh=mesh,
                      mesh_axis="chains")
        m.run()
        return {"rho": m.chain.theta["rho"], "nacc": m.nacc}

    def ssp_mesh():
        mesh = sharded.make_mesh(D, ("runs", "particles"), (1, D),
                                 device_type=device.type)
        res, _ = sharded.run_sharded_smc(lg(T_GLOO_MESH), N_MAIN, seed=3,
                                         mesh=mesh, resampling="ssp")
        return {"logLt": float(res.logLt), "rs_flags": res.rs_flags}

    def multi_mesh():
        mesh = sharded.make_mesh(D, ("runs", "particles"), (2, D // 2),
                                 device_type=device.type)
        logLts, lws = sharded.run_sharded_multismc(
            lg(T_GLOO_MESH), N_MAIN, MULTI_RUNS, seed=4, mesh=mesh)
        return {"logLts": logLts, "lws_shape": tuple(lws.shape),
                "finite": bool(torch.isfinite(lws).any(1).all())}

    runs = {
        "sqmc": lambda: sqmc(job["T_sqmc"], job["sqmc_hist"]),
        "tempering Pima": lambda: sampler(
            ssp.AdaptiveTempering(
                model=pima, len_chain=P_SAMPLER), N_SAMPLER, 181),
        "NS-SMC Pima": lambda: sampler(
            nested.NestedSamplingSMC(
                model=pima, len_chain=P_SAMPLER, ESSrmin=NS_ESSRMIN),
            N_SAMPLER, 186),
        "tempering conjugate": lambda: sampler(
            ssp.AdaptiveTempering(
                model=conj, len_chain=P_SAMPLER),
            N_SAMPLER_SPREAD // P_SAMPLER, 182),
        "SMC2 GBP/USD": lambda: smc2(T_GLOO_SMC2),
        "PMMH chains": pmmh,
        "run_sharded_smc ssp": ssp_mesh,
        "run_sharded_multismc": multi_mesh,
    }
    t_start = time.perf_counter()
    out = {"rank": d, "D": D, "backend": str(dist.get_backend()),
           "device": str(device), "runs": {}}
    distributed.run_shardmap_smc(lg(20), N_MAIN, seed=100, qmc=True)  # warm
    for tag in job["runs"]:
        check = (_CheckedKernels(torch, ops, rs, f"phase 20 {tag}")
                 if job["checked"] else contextlib.nullcontext())
        _zero_counts(ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with check:
            rec = runs[tag]()
        torch.cuda.synchronize()
        rec.update(wall_s=time.perf_counter() - t0,
                   launches=_read_counts(ops), calls=_read_calls(comm),
                   checked_calls=getattr(check, "calls", None))
        out["runs"][tag] = rec
    if not job["checked"]:      # the second pass, every kernel checked
        out["checked"] = {}
        again = {"sqmc": lambda: sqmc(T_DIST_CHECK, False),
                 **{k: runs[k] for k in job["runs"] if k != "sqmc"}}
        for tag in job["runs"]:
            with _CheckedKernels(torch, ops, rs,
                                 f"phase 20 {tag} checked") as checked:
                again[tag]()
            out["checked"][tag] = checked.calls
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t_start
    return out


def dist_more_jobs(y):
    """Phase 20's rank jobs, by backend: they run in phase 19's ranks,
    after phase 19's own work (one launch of each backend for both)."""
    from particles_tpu_torch import datasets

    common = {"y": y, "y_pm": _simulate_lg(0.8, 1.0, 0.5, PMMH_ORACLE_T, 3)[1],
              "y_gbp": datasets.GBP_vs_USD_9798().data.astype(np.float32)}
    return {"nccl": dict(common, checked=False, T_sqmc=T_MAIN,
                         sqmc_hist=False,
                         runs=["sqmc", "tempering Pima", "NS-SMC Pima"]),
            "gloo": dict(common, checked=True, T_sqmc=T_GLOO_SQMC,
                         sqmc_hist=True,
                         runs=["sqmc", "tempering conjugate", "SMC2 GBP/USD",
                               "PMMH chains", "run_sharded_smc ssp",
                               "run_sharded_multismc"])}


def phase_dist_more(torch, dev, smi, y, pima_logLt, results):
    """Phase 20: distributed SQMC, the sharded samplers, NS-SMC and SMC²,
    PMMH's chains across ranks and the mesh entry points, run by phase
    19's ranks (``results``: by backend, each rank's ``_dist20_rank``
    record): NCCL with one rank a card, D_GLOO gloo ranks on card 0."""
    from particles_tpu_torch import kalman, ops

    _, pm_mean, pm_sd = lg_oracle(
        torch, _simulate_lg(0.8, 1.0, 0.5, PMMH_ORACLE_T, 3)[1], 100)

    def kalman_of(T):
        return float(kalman.Kalman(
            ssm=kalman.LinearGauss(rho=RHO, sigmaX=SIGX, sigmaY=SIGY),
            data=torch.from_numpy(y[:T].astype(np.float64))).logLt)

    _, conj_exact, _, _ = conjugate_targets()
    b_map = newton_map(logistic_model(torch, dev, "Pima")[1])
    out = {"phase": 20, "nvidia_smi": smi, "N": N_MAIN,
           "wall_s": sum(max(r["wall_s"] for r in ranks)
                         for ranks in results.values()),
           "tolerance": LOGLT_TOL}
    launches = {}
    for group, ranks in results.items():
        D = len(ranks)
        rec_g = {"D": D, "backend": ranks[0]["backend"],
                 "devices": [r["device"] for r in ranks], "runs": {}}
        for tag, run in ranks[0]["runs"].items():
            where = f"phase 20 {group} {tag}"
            for r in ranks:     # what every rank must hold alike
                other = r["runs"][tag]
                for k in ("logLt", "rs_flags", "exchanges", "logLts", "rho",
                          "nacc"):
                    if k in run:
                        _check(np.array_equal(np.asarray(other[k]),
                                              np.asarray(run[k])),
                               f"{where}: rank {r['rank']} differs in {k}")
            rec = {k: v for k, v in run.items()
                   if k not in ("rs_flags", "rho", "launches", "calls",
                                "checked_calls")}
            rec["wall_s"] = [r["runs"][tag]["wall_s"] for r in ranks]
            n_rs = (int(np.asarray(run["rs_flags"]).sum())
                    if "rs_flags" in run else 0)
            rec["resampling_steps"] = n_rs
            want = {}
            if tag == "sqmc":
                T = len(run["rs_flags"])
                exact = kalman_of(T)
                rec.update(T=T, kalman_logLt=exact,
                           abs_diff=abs(run["logLt"] - exact),
                           ms_per_step=[1000.0 * w / T
                                        for w in rec["wall_s"]])
                _check(rec["abs_diff"] < LOGLT_TOL and run["finite"]
                       and run["sorted"] and n_rs == T - 1,
                       f"{where}: {rec}")
                if "A_min" in run:
                    _check(run["A_min"] >= 0 and run["A_max"] < N_MAIN
                           and run["origin_ranks"] == D,
                           f"{where}: the ancestors are not global: {rec}")
                want = {k: v * n_rs for k, v in
                        SQMC_DIST_LAUNCHES(D).items()}
            elif tag in ("tempering Pima", "tempering conjugate",
                         "NS-SMC Pima", "SMC2 GBP/USD"):
                per = -(-run["leaves"] // ops.MAX_PAYLOADS)
                want = {"running_max": n_rs, "repeat_by_z": D * per * n_rs}
                if tag == "tempering Pima":
                    post = np.array([run["post_mean"][f"b{j}"]
                                     for j in range(len(b_map))])
                    ps = run["shared"]["path_sampling"]
                    rec.update(abs_diff_path_sampling=abs(run["logLt"] - ps),
                               max_abs_diff_newton_map=float(
                                   np.abs(post - b_map).max()))
                    _check(rec["abs_diff_path_sampling"] < PIMA_PS_TOL
                           and rec["max_abs_diff_newton_map"] < PIMA_MAP_TOL
                           and run["shared"]["exponent"] == 1.0
                           and run["N0_rank"] == N_SAMPLER * P_SAMPLER // D,
                           f"{where}: {rec}")
                elif tag == "NS-SMC Pima":
                    ev = run["shared"]["log_evid"]
                    rec.update(phase_16_tempering_logLt=pima_logLt,
                               abs_diff=abs(ev - pima_logLt))
                    _check(np.isfinite(ev) and rec["abs_diff"] < NS_PIMA_TOL
                           and np.isinf(run["shared"]["lt"]),
                           f"{where}: {rec}")
                elif tag == "tempering conjugate":
                    rec.update(exact=conj_exact,
                               abs_diff=abs(run["logLt"] - conj_exact))
                    _check(rec["abs_diff"] < LOGLT_TOL, f"{where}: {rec}")
                else:
                    _check(np.isfinite(run["logLt"])
                           and 0.0 < run["acc_rate"] < 1.0
                           and run["xs"][0] == SMC2_NTHETA // D
                           and all(np.isfinite(v) for v in
                                   run["post_mean"].values()),
                           f"{where}: {rec}")
            elif tag == "PMMH chains":
                pooled = np.asarray(run["rho"])[PMMH_DIST_BURN:].ravel()
                rec.update(niter=PMMH_DIST_NITER, burn=PMMH_DIST_BURN,
                           nchains=PMMH_CHAINS, pooled_mean=float(
                               pooled.mean()), exact_mean=pm_mean,
                           sd_ratio=float(pooled.std() / pm_sd),
                           nacc=np.asarray(run["nacc"]).tolist())
                _check(np.asarray(run["rho"]).shape
                       == (PMMH_DIST_NITER, PMMH_CHAINS)
                       and abs(rec["pooled_mean"] - pm_mean) < PMMH_MEAN_TOL
                       and 0.3 < rec["sd_ratio"] < 3.0, f"{where}: {rec}")
            elif tag == "run_sharded_smc ssp":
                exact = kalman_of(T_GLOO_MESH)
                rec.update(T=T_GLOO_MESH, kalman_logLt=exact,
                           abs_diff=abs(run["logLt"] - exact))
                _check(rec["abs_diff"] < LOGLT_TOL and n_rs > 0,
                       f"{where}: {rec}")
                want = {"repeat_by_z": D * n_rs}
            elif tag == "run_sharded_multismc":
                exact = kalman_of(T_GLOO_MESH)
                lls = np.asarray(run["logLts"])
                rec.update(T=T_GLOO_MESH, kalman_logLt=exact,
                           logLts=lls.tolist(),
                           max_abs_diff=float(np.abs(lls - exact).max()))
                _check(lls.shape == (MULTI_RUNS,) and run["finite"]
                       and run["lws_shape"] == (MULTI_RUNS // 2,
                                                N_MAIN // (D // 2))
                       and rec["max_abs_diff"] < LOGLT_TOL,
                       f"{where}: {rec}")
            if tag != "run_sharded_multismc":
                for r in ranks:
                    got = r["runs"][tag]["launches"]
                    _check(all(got[k] == want.get(k, 0) for k in got),
                           f"{where} rank {r['rank']}: launches {got}, "
                           f"expected {want}")
            launches[f"phase 20 {group} {tag}"] = {
                name: sum(r["runs"][tag]["launches"][name] for r in ranks)
                for name in ops.KERNELS}
            rec["launches_rank0"] = {k: v for k, v in
                                     run["launches"].items() if v}
            rec["collectives_rank0"] = run["calls"]
            checked = [r["checked"][tag] if "checked" in r
                       else r["runs"][tag]["checked_calls"] for r in ranks]
            rec["checked_kernel_calls"] = checked
            uses = {k for k, v in run["launches"].items() if v}
            names = {"repeat_by_z": "repeat_by_z",
                     "merge_rank_counts": "merge_rank_counts",
                     "running_max": "running_max"}
            for c in checked:
                _check(all(c[names[k]] > 0 for k in uses if k in names),
                       f"{where}: a kernel never checked {c}")
            rec_g["runs"][tag] = rec
        out[group] = rec_g
    _emit(out)
    return launches


def _knots(tag, got, want, near):
    """``got`` equals ``want`` (int arrays) wherever ``near`` (a point
    within float64 round-off of a knot) is False.  Returns (points near a
    knot, points differing)."""
    differ = got != want
    away = int(np.count_nonzero(differ & ~near))
    _check(away == 0, f"{tag}: {away} points differ away from a knot")
    return int(np.count_nonzero(near)), int(np.count_nonzero(differ))


def phase_host_helpers(torch, dev, smi, y, kf_logLt):
    """Phase 21: the host helpers of ``native``, built here with g++, each
    held to the port's own functions; then ssp below the tree pairing on
    the headline's model and data, its resampling steps through the
    helper and B2.  Returns B2's launches (and the others', 0)."""
    from particles_tpu_torch import _build, hilbert, kalman, native, ops
    from particles_tpu_torch import resampling as rs
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.core import SMC

    t_phase = time.perf_counter()
    # built on this host: the library is removed first, whatever the copy
    # of the repository carried
    (_build.BUILD_DIR / f"lib{native.SRC.stem}.so").unlink(missing_ok=True)
    _build.build_host(native.SRC)
    out = {"phase": 21, "nvidia_smi": smi,
           "gxx_seconds": _build.build_seconds[native.SRC.stem],
           "gxx_flags": _build.CXX_FLAGS}
    rng = np.random.default_rng(21)

    # ssp_counts, through resampling.ssp_counts on the card and called
    # directly, bit for bit against the plain version on the same uniforms
    n_ssp = 0
    for N in SSP_SMALL_NS:
        for M in sorted({N, N // 2 + 1, 2 * N + 1}):
            kind = "dirichlet0.05" if n_ssp % 2 else "dirichlet1"
            W = torch.from_numpy(_dirichlet_like(rng, kind, N)).to(dev)
            gen = torch.Generator(device=dev).manual_seed(N + M)
            twin = torch.Generator(device=dev)
            twin.set_state(gen.get_state())
            got = rs.ssp_counts(gen, W, M)
            u = torch.rand(N - 1, generator=twin, device=dev,
                           dtype=torch.float64)
            want = rs._ssp_counts_sequential(W.double().tolist(), M,
                                             u.tolist())
            tag = f"phase 21 ssp N={N} M={M}"
            _check(got.device == W.device and got.dtype == torch.int32
                   and got.cpu().tolist() == want, f"{tag}: differs")
            direct = native.ssp_counts(W.double().cpu().numpy(), M,
                                       u.cpu().numpy())
            _check(direct.tolist() == want, f"{tag}: the helper differs")
            _check(torch.equal(gen.get_state(), twin.get_state()),
                   f"{tag}: the uniform stream moved")
            n_ssp += 1
    out["ssp_counts"] = {"N": list(SSP_SMALL_NS), "cases": n_ssp,
                         "M": "N, N/2 + 1, 2N + 1",
                         "tolerance": "bit for bit against "
                                      "_ssp_counts_sequential"}

    # the Hilbert index against hilbert.hilbert_index on the card
    hil = {}
    for d in (1, 2, 3, 4):
        nbits = min(62 // d, 32)
        coords = rng.integers(0, 2 ** nbits, size=(N_HILBERT, d),
                              dtype=np.uint64).astype(np.uint32)
        keys = hilbert.hilbert_index(
            torch.from_numpy(coords.astype(np.int64)).to(dev), nbits)
        got = native.hilbert_index(coords, nbits)
        _check(np.array_equal(got, keys.cpu().numpy().astype(np.uint64)),
               f"phase 21 hilbert d={d} nbits={nbits}: keys differ")
        hil[f"d={d}"] = nbits
    out["hilbert_index"] = {"N": N_HILBERT, "nbits": hil,
                            "tolerance": "bit for bit"}

    # systematic_counts and inverse_cdf against the same formula in float64
    # on the card: the two CDFs, summed in other orders, differ by at most
    # 4 (N + 1) 2^-53, so the answers agree except at points that close to
    # a knot (a z at an integer, a uniform at a CDF value)
    knots = {}
    for N in KNOT_SIZES:
        W_np = _dirichlet_like(rng, "dirichlet1", N).astype(np.float64)
        Wd = torch.from_numpy(W_np).to(dev)
        Wn = Wd / Wd.sum()
        cs = torch.cumsum(Wn, 0)
        tol = 4 * (N + 1) * 2.0 ** -53
        for M, u in ((N, 0.37), (2 * N + 1, 0.0)):
            x = M * cs - u
            z = (torch.floor(x) + 1).clamp(0, M).long()
            z[-1] = M
            near = ((x - torch.round(x)).abs() <= M * tol).cpu().numpy()
            z_nat = np.cumsum(native.systematic_counts(W_np, M, u))
            knots[f"systematic N={N} M={M}"] = _knots(
                f"phase 21 systematic N={N} M={M}", z_nat,
                z.cpu().numpy(), near)
            su = torch.sort(torch.rand(M, device=dev,
                                       dtype=torch.float64)).values
            A = rs.inverse_cdf(su, Wn)
            below = cs[(A - 1).clamp(min=0)]
            near = (((cs[A] - su).abs() <= tol)
                    | ((su - below).abs() <= tol)).cpu().numpy()
            A_nat = native.inverse_cdf(su.cpu().numpy(), W_np)
            knots[f"inverse_cdf N={N} M={M}"] = _knots(
                f"phase 21 inverse_cdf N={N} M={M}", A_nat.astype(np.int64),
                A.cpu().numpy(), near)
    out["knots"] = {"points_near_a_knot_and_differing": knots,
                    "tolerance": "equal away from a knot; near: within "
                                 "4 (N + 1) 2^-53 (times M for z)"}

    # ssp below the tree on the headline's model and data
    ssm = kalman.LinearGauss(rho=RHO, sigmaX=SIGX, sigmaY=SIGY)
    fk = ssms.Bootstrap(ssm=ssm, data=torch.from_numpy(y).to(dev))

    def run(seed):
        pf = SMC(fk=fk, N=N_SSP_SMALL, resampling="ssp", seed=seed)
        pf.run()
        return pf

    run(SSP_SEEDS + 1)      # warm
    _zero_counts(ops)
    pf = run(0)
    launches = _read_counts(ops)
    n_rs = int(pf.summaries.rs_flags.sum())
    logLt = float(pf.logLt)
    _check(n_rs > 0 and launches["repeat_by_z"] == n_rs
           and all(n == 0 for k, n in launches.items()
                   if k != "repeat_by_z"),
           f"phase 21 ssp N={N_SSP_SMALL}: launches {launches}, {n_rs} "
           f"resampling steps")
    # B2 on the run's own inputs: the same seed again, every call held to
    # its plain version
    with _CheckedKernels(torch, ops, rs, tag="phase 21") as checked:
        pf2 = run(0)
    n_rs2 = int(pf2.summaries.rs_flags.sum())
    _check(checked.calls["repeat_by_z"] == n_rs2 > 0,
           f"phase 21: {checked.calls} B2 calls checked, {n_rs2} "
           f"resampling steps")
    spread = [float(run(s).logLt) for s in range(1, SSP_SEEDS + 1)]
    sd = float(np.std(spread, ddof=1))
    _check(np.isfinite(logLt) and np.all(np.isfinite(spread))
           and abs(logLt - kf_logLt) < LOGLT_SDS * sd,
           f"phase 21 ssp N={N_SSP_SMALL}: |logLt - Kalman| = "
           f"{abs(logLt - kf_logLt)} >= {LOGLT_SDS} x {sd}")
    out["ssp_run"] = {
        "N": N_SSP_SMALL, "T": T_MAIN, "logLt": logLt,
        "kalman_logLt": kf_logLt, "abs_diff": abs(logLt - kf_logLt),
        "sd": sd, "sd_from": f"logLt of seeds 1-{SSP_SEEDS}",
        "seeds_logLt_mean": float(np.mean(spread)),
        "tolerance_sds": LOGLT_SDS, "resampling_steps": n_rs,
        "launches": launches,
        "b2_calls_checked": checked.calls["repeat_by_z"],
        "ms_per_step": 1000.0 * pf.cpu_time / T_MAIN}

    # host ms of one ssp_counts call at N = 8191: the helper against the
    # plain version on the same inputs, and the port's call on the card
    N = SSP_SMALL_NS[-1]
    W_np = _dirichlet_like(rng, "dirichlet1", N).astype(np.float64)
    u_np = rng.random(N - 1)
    Wl, ul = W_np.tolist(), u_np.tolist()

    def host_ms(fn, reps):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1000.0 * (time.perf_counter() - t0))
        return float(np.median(times))

    _check(native.ssp_counts(W_np, N, u_np).tolist()
           == rs._ssp_counts_sequential(Wl, N, ul),
           "phase 21: the timed inputs differ")
    Wc = torch.from_numpy(W_np.astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    card = [_sync_ms(torch, lambda: rs.ssp_counts(gen, Wc))[1]
            for _ in range(21)]
    out["host_ms_N8191"] = {
        "helper": host_ms(lambda: native.ssp_counts(W_np, N, u_np), 201),
        "plain": host_ms(lambda: rs._ssp_counts_sequential(Wl, N, ul), 9),
        "resampling_ssp_counts_on_the_card": float(np.median(card[1:])),
        "timing": "host clock, median of 201, 9 and 20 calls"}
    out["seconds"] = time.perf_counter() - t_phase
    _emit(out)
    return {f"ssp N={N_SSP_SMALL}": launches}


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script needs a CUDA card")
    from particles_tpu_torch import _build, kalman, ops
    from particles_tpu_torch import state_space_models as ssms
    from particles_tpu_torch.core import SMC, multiSMC

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
        z, dp, do, _, nd = check_b1(
            torch, ops, dev, f"B1 N={N} M={M} {wkind} u={u}",
            _dirichlet_like(rng, wkind, N), u, M)
        err_plain, err_oracle = max(err_plain, dp), max(err_oracle, do)
        n_differ += nd
        n_cases += 1
        if (wkind == "dirichlet0.05" and u == 0.37) or M != N:
            zs[(N, M)] = z
    # strained cases: the chunk edges of the one-launch geometry, 2^24 (W
    # read again from global memory), all weight on one particle, weights
    # mostly zero, S just above the overflow edge of scale, and M = 4N.
    # The fixed-point grid (2^-30 of the total a weight) is the function's
    # own error, and it passes 1 against float64 above N = 2^20 and at
    # M = 4N: there the kernel is held within 1 of the plain version and
    # no further from float64 than the plain version is, plus 1.
    tile, cache_tiles, max_grid = ops.systematic_z_geometry(dev)
    strained = [(f"N={N}", _dirichlet_like(rng, "dirichlet1", N), N)
                for N in (tile + 1, max_grid * tile + 1,
                          max_grid * cache_tiles * tile + 1, 2 ** 24)]
    for k in (0, N_MAIN // 2, N_MAIN - 1):
        W_np = np.zeros(N_MAIN, dtype=np.float32)
        W_np[k] = 1.0
        strained.append((f"all weight on particle {k}", W_np, N_MAIN))
    W_np = np.zeros(N_MAIN, dtype=np.float32)
    W_np[rng.choice(N_MAIN, 5, replace=False)] = rng.random(5)
    strained.append(("mostly zero", W_np, N_MAIN))
    strained.append(("S = 4e-30", (_dirichlet_like(rng, "dirichlet1", N_MAIN)
                                   * np.float32(4e-30)).astype(np.float32),
                     N_MAIN))
    for N, wkind in ((N_MAIN - 513, "dirichlet1"), (N_MAIN, "degenerate"),
                     (2 ** 24, "dirichlet1")):
        strained.append((f"M=4N N={N} {wkind}", _dirichlet_like(rng, wkind, N),
                         4 * N))
    # W_i = k_i 2^-24 (k_i < 256): S is exact in double in any order, so
    # the kernel's S, q and Q are the plain version's and z is bit-exact
    n_exact = 0
    for N in (N_MAIN, 2 ** 24):
        k = rng.integers(0, 256, N)
        k[-1] += 1
        W = torch.from_numpy((k * 2.0 ** -24).astype(np.float32)).to(dev)
        for M in (N, 4 * N):
            for u in us:
                ut = torch.tensor(u, dtype=torch.float32, device=dev)
                _check(torch.equal(ops.systematic_z_fused(W, ut, M),
                                   ops.systematic_z_plain(W, ut, M)),
                       f"B1 exact sum N={N} M={M} u={u}: differs from plain")
                n_exact += 1
    err_plain_oracle = 0
    for name, W_np, M in strained:
        for u in us:
            _, dp, do, dpo, nd = check_b1(torch, ops, dev,
                                          f"B1 {name} M={M} u={u}", W_np, u,
                                          M, strained=True)
            err_plain = max(err_plain, dp)
            err_oracle = max(err_oracle, do)
            err_plain_oracle = max(err_plain_oracle, dpo)
            n_differ += nd
            n_cases += 1
    _emit({"phase": 2, "kernel": "systematic_z", "cases": n_cases,
           "strained_cases": len(strained) * len(us),
           "bit_exact_cases": n_exact,
           "geometry": {"tile": tile, "cache_tiles": cache_tiles,
                        "max_grid": max_grid},
           "max_abs_err_vs_plain": err_plain,
           "max_abs_err_vs_float64": err_oracle,
           "plain_max_abs_err_vs_float64": err_plain_oracle,
           "elements_differing_from_plain": n_differ,
           "tolerance": "nondecreasing, z[-1] == M, |dz| <= 1 vs plain "
                        "(equal where S is exact); |dz| <= 1 vs float64 at "
                        "N <= 2^20, M <= N, else <= |plain - float64| + 1"})

    # -- 3. B2 against its plain version, exact -----------------------------
    b2_err = 0.0
    n_cases = 0

    def b2(tag, forms):
        nonlocal b2_err, n_cases
        b2_err = max(b2_err, check_b2(torch, tag, forms))
        n_cases += len(forms)

    for (N, M), z in zs.items():
        cols = _payloads(torch, dev, N)
        many = [torch.randn(N, device=dev)
                for _ in range(ops.MAX_PAYLOADS + 2)]
        b2(f"B2 N={N} M={M}", [
            ("fused+anc", ops.repeat_cols(z, M, cols, want_anc=True),
             ops.repeat_cols_plain(z, M, cols, want_anc=True)),
            ("anc only", ([], ops.ancestors_by_z(z, M)),
             ops.repeat_cols_plain(z, M, [], want_anc=True)),
            ("two launches", ops.repeat_cols(z, M, many),
             ops.repeat_cols_plain(z, M, many))])
    n_strained = 0
    for name, counts, M in _strained_counts(rng, ops.MERGE_TILE):
        N = len(counts)
        z = torch.from_numpy(np.cumsum(counts).astype(np.int32)).to(dev)
        cols = _payloads(torch, dev, N)
        b2(f"B2 {name} (N={N} M={M})", [
            ("fused+anc", ops.repeat_cols(z, M, cols, want_anc=True),
             ops.repeat_cols_plain(z, M, cols, want_anc=True)),
            ("anc only", ([], ops.ancestors_by_z(z, M)),
             ops.repeat_cols_plain(z, M, [], want_anc=True))])
        n_strained += 1
    _emit({"phase": 3, "kernel": "repeat_by_z", "cases": n_cases,
           "strained_count_vectors": n_strained,
           "max_abs_err_vs_plain": b2_err, "tolerance": "exact"})

    # -- 4. the main path at full width --------------------------------------
    y = _simulate_y(T_MAIN)
    ssm = kalman.LinearGauss(rho=RHO, sigmaX=SIGX, sigmaY=SIGY)
    fk = ssms.Bootstrap(ssm=ssm, data=torch.from_numpy(y).to(dev))
    kf_logLt = float(kalman.Kalman(
        ssm=ssm, data=torch.from_numpy(y.astype(np.float64))).logLt)

    def main_path(seed):
        _zero_counts(ops)
        pf = SMC(fk=fk, N=N_MAIN, seed=seed)
        pf.run()
        launches = {k: v for k, v in _read_counts(ops).items()
                    if k in ("systematic_z", "repeat_by_z")}
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

    # -- 5. B3 against its plain version and a float64 oracle -------------
    b3_err = 0.0
    n_cases = 0
    cdfs = {}

    def b3(tag, W_np):
        nonlocal b3_err, n_cases
        cs, dp = check_b3(torch, ops, dev, tag, W_np)
        b3_err = max(b3_err, dp)
        n_cases += 1
        return cs

    for N in Ns:
        for wkind in kinds:
            cdfs[(N, wkind)] = b3(
                f"B3 N={N} {wkind}", _dirichlet_like(rng, wkind, N))
    tile, cache_tiles, max_grid = ops.normalised_cumsum_geometry(dev)
    for N in (tile + 1, max_grid * tile + 1,
              max_grid * cache_tiles * tile + 1, 2 ** 24):
        b3(f"B3 N={N}", _dirichlet_like(rng, "dirichlet1", N))
    for k in (0, N_MAIN // 2, N_MAIN - 1):
        W_np = np.zeros(N_MAIN, dtype=np.float32)
        W_np[k] = 1.0
        b3(f"B3 all weight on particle {k}", W_np)
    W_np = np.zeros(N_MAIN, dtype=np.float32)
    W_np[rng.choice(N_MAIN, 5, replace=False)] = rng.random(5)
    b3("B3 mostly zero", W_np)
    # the least S for which 2^30 / S is a finite f32 is about 3.2e-30
    b3("B3 S = 4e-30", (_dirichlet_like(rng, "dirichlet1", N_MAIN)
                              * np.float32(4e-30)).astype(np.float32))
    for N in (N_MAIN, 2 ** 24):      # S exact in double: cs bit-exact
        k = rng.integers(0, 256, N)
        k[-1] += 1
        W = torch.from_numpy((k * 2.0 ** -24).astype(np.float32)).to(dev)
        _check(torch.equal(ops.normalised_cumsum_exact(W),
                           ops.normalised_cumsum_plain(W)),
               f"B3 exact sum N={N}: differs from plain")
        n_cases += 1
    _emit({"phase": 5, "kernel": "normalised_cumsum", "cases": n_cases,
           "geometry": {"tile": tile, "cache_tiles": cache_tiles,
                        "max_grid": max_grid},
           "max_abs_err_vs_plain": b3_err,
           "tolerance": "nondecreasing, |cs[-1] - 1| < 1e-6, "
                        "|dcs| < N 2^-31 + 1e-6 vs plain and float64"})

    # -- 6. B5 against its plain version, exact ------------------------------
    n_cases = 0
    for (N, wkind), cs in cdfs.items():
        cases = []
        for L in (N, 2 * N + 1, N // 2 + 1):
            cases.append((f"L={L}", torch.rand(L, device=dev).sort().values,
                          L))
        tied = torch.cat([torch.rand(N - N // 2, device=dev),
                          cs[torch.randint(0, N, (N // 2,), device=dev)]])
        cases.append(("ties", tied.sort().values, N))
        for form, su, M in cases:
            z = ops.merge_rank_counts(su, cs, M)
            zp = ops.merge_rank_counts_plain(su, cs, M)
            torch.cuda.synchronize()
            _check(z.dtype == torch.int32 and torch.equal(z, zp),
                   f"B5 N={N} {wkind} {form}: differs from plain")
            n_cases += 1
        dip = torch.rand(N, device=dev).sort().values
        if N > 2:
            dip[1::7] = torch.nextafter(dip[0:-1:7],
                                        torch.zeros((), device=dev))
        z = ops.merge_rank_counts(dip, cs, N)
        _check(bool((z[1:] >= z[:-1]).all()),
               f"B5 N={N} {wkind}: z not nondecreasing on a dip")
        inf = dip.new_full((1,), float("inf"))
        below = torch.cat([-inf, dip])[z.long()]         # su[z - 1]
        above = torch.cat([dip, inf])[z.long()]          # su[z]
        _check(bool((below <= cs).all() and (cs < above).all()),
               f"B5 N={N} {wkind}: not a binary search's answer on a dip")
    # strained cases, N not a multiple of a block's tile
    N = N_MAIN - 513
    tile, window = ops.MERGE_RANK_TILE, ops.MERGE_RANK_WINDOW
    cs = cdfs[(N, "dirichlet1")]
    su = torch.rand(N, device=dev).sort().values
    strained = []
    for k in (0, N // 2, N - 1):
        W1 = torch.zeros(N, device=dev)
        W1[k:k + 1].fill_(1.0)
        strained.append((f"all weight on particle {k}", su,
                         ops.normalised_cumsum_exact(W1), N))
    a, b = cs[tile], cs[2 * tile - 1]       # block 1's window: (a, b]
    for K in (window + 1, 4 * window):
        mid = torch.minimum(a + (b - a) * torch.arange(
            1, K + 1, device=dev) / K, b)
        rest = torch.rand(N, device=dev)
        rest = rest[(rest <= a) | (rest > b)]
        strained.append((f"block 1's window of {K} > {window}",
                         torch.cat([mid, rest]).sort().values, cs, N))
    tail = su.clone()
    tail[N // 3:] = 2.0
    strained.append(("residual's tail of 2.0", tail, cs, N))
    strained.append(("L=1", torch.rand(1, device=dev), cs, N))
    for form, s, c, M in strained:
        z = ops.merge_rank_counts(s, c, M)
        zp = ops.merge_rank_counts_plain(s, c, M)
        torch.cuda.synchronize()
        _check(z.dtype == torch.int32 and torch.equal(z, zp),
               f"B5 {form} (N={N}): differs from plain")
        n_cases += 1
    _emit({"phase": 6, "kernel": "merge_rank_counts", "cases": n_cases,
           "strained_cases": len(strained), "max_abs_err_vs_plain": 0,
           "tolerance": "exact; on a dip nondecreasing and a binary "
                        "search's answer"})

    # -- 7. B4 against its plain version, exact ------------------------------
    n_cases = 0

    def b4_case(tag, su, cs, cols):
        nonlocal n_cases
        check_b4(torch, ops, tag, su, cs, cols)
        n_cases += 1

    for (N, wkind), cs in cdfs.items():
        if wkind != "dirichlet0.05":
            continue
        cs1 = cs.clone()
        cs1[-1] = 1.0
        cols = _payloads(torch, dev, N)
        u = torch.rand(N, device=dev)
        for form, su in [("unsorted", u), ("sorted", u.sort().values),
                         ("M=4N", torch.rand(4 * N, device=dev))]:
            b4_case(f"B4 N={N} {form}", su, cs1, cols)
    # strained cases, N not a power of two
    N = N_MAIN - 513
    cols = _payloads(torch, dev, N)
    cs = cdfs[(N, "dirichlet1")].clone()
    cs[-1:].fill_(1.0)
    u = torch.rand(N, device=dev)
    strained = []
    for k in (0, N // 2, N - 1):
        W1 = torch.zeros(N, device=dev)
        W1[k:k + 1].fill_(1.0)
        strained.append((f"all weight on particle {k}", u,
                         ops.normalised_cumsum_exact(W1)))
    strained.append(("degenerate weights", u, cdfs[(N, "degenerate")]))
    tied = u.clone()
    tied[::2] = cs[torch.randint(0, N, (tied[::2].shape[0],), device=dev)]
    strained.append(("su tied with cs", tied, cs))
    top = cs[-1:]
    edges = torch.cat([torch.zeros(1, device=dev),
                       torch.nextafter(top, torch.zeros_like(top)), top,
                       torch.tensor([-0.5, 1.5], device=dev)])
    strained.append(("su at 0, an ulp below the top, negative and past it",
                     torch.cat([edges, u]), cs))
    cs_int = torch.from_numpy(np.cumsum(rng.multinomial(
        N, np.full(N, 1.0 / N))).astype(np.float32)).to(dev)
    strained.append(("integer cs at idx + 0.5",
                     torch.randperm(N, device=dev).float() + 0.5, cs_int))
    cs_zero = -torch.rand(N, device=dev).sort(descending=True).values
    cs_zero[-1:].fill_(0.0)
    strained.append(("cs[-1] = 0", 2 * torch.rand(N, device=dev) - 1,
                     cs_zero))
    strained.append(("M=4N", torch.rand(4 * N, device=dev), cs))
    for form, su, c in strained:
        b4_case(f"B4 {form} (N={N})", su, c, cols)
    _emit({"phase": 7, "kernel": "repeat_by_su", "cases": n_cases,
           "strained_cases": len(strained), "guide_buckets":
           ops.guide_buckets(N_MAIN), "max_abs_err_vs_plain": 0,
           "tolerance": "exact"})

    # -- 8. B6 against torch.cummax, exact -----------------------------------
    tile, cache_tiles, max_grid = ops.running_max_geometry(dev)
    n_cases = 0
    for N in Ns + [tile + 1, max_grid * tile + 1,
                   max_grid * cache_tiles * tile + 1, 2 ** 24]:
        inputs = [("whole range", torch.randint(
            -2 ** 31, 2 ** 31 - 1, (N,), device=dev, dtype=torch.int32))]
        if N > 1000:
            inputs += [
                ("all INT_MIN", torch.full((N,), -2 ** 31, device=dev,
                                           dtype=torch.int32)),
                ("descending", torch.linspace(
                    2 ** 31 - 1, -2 ** 31, N, device=dev,
                    dtype=torch.float64).to(torch.int32))]
        for form, z in inputs:
            zmax = ops.running_max(z)
            zmax_plain = ops.running_max_plain(z)
            torch.cuda.synchronize()
            _check(zmax.dtype == torch.int32 and torch.equal(zmax, zmax_plain),
                   f"B6 N={N} {form}: differs from plain")
            n_cases += 1
    _emit({"phase": 8, "kernel": "running_max", "cases": n_cases,
           "geometry": {"tile": tile, "cache_tiles": cache_tiles,
                        "max_grid": max_grid},
           "max_abs_err_vs_plain": 0, "tolerance": "exact"})

    # -- 9. every resampling scheme through multiSMC -------------------------
    def zero_counts():
        _zero_counts(ops)

    def read_counts():
        return _read_counts(ops)

    multiSMC(fk=ssms.Bootstrap(ssm=ssm, data=y[:20]), N=N_MAIN,
             resampling=SCHEMES, nruns=1)      # warm-up of every scheme
    snaps = []

    def snapshot(res):
        snaps.append(read_counts())
        return res

    fk_np = ssms.Bootstrap(ssm=ssm, data=y)    # numpy data, no device
    _check(fk_np.data.device.type == "cuda", "numpy data not on the card")
    zero_counts()
    snaps.append(read_counts())
    runs = multiSMC(fk=fk_np, N=N_MAIN, resampling=SCHEMES, nruns=1,
                    out_func=snapshot)
    multi_launches = read_counts()
    schemes_out = {}
    for k, entry in enumerate(runs):
        scheme, res = entry["resampling"], entry["output"]
        n_rs = int(res.rs_flags.sum())
        logLt = float(res.logLt)
        launched = {name: snaps[k + 1][name] - snaps[k][name]
                    for name in ops.KERNELS}
        _check(np.isfinite(logLt) and abs(logLt - kf_logLt) < LOGLT_TOL,
               f"{scheme}: logLt {logLt}, Kalman {kf_logLt}")
        _check(res.lw.device.type == "cuda", f"{scheme}: not on the card")
        for name, n in launched.items():
            want = n_rs if name in SCHEME_KERNELS[scheme] else 0
            _check(n == want and n_rs > 0,
                   f"{scheme}: {name} launched {n} times, {n_rs} "
                   f"resampling steps, expected {want}")
        schemes_out[scheme] = {
            "logLt": logLt, "abs_diff": abs(logLt - kf_logLt),
            "resampling_steps": n_rs, "launches": launched,
            "warm_wall_s": res.cpu_time,
            "ms_per_step": 1000.0 * res.cpu_time / T_MAIN}
    b5_uniforms = check_b5_on_scheme_uniforms(torch, fk_np)
    zero_counts()
    idiot = multiSMC(fk=ssms.Bootstrap(ssm=ssm, data=y[:T_IDIOTIC]),
                     N=N_MAIN, resampling="idiotic", nruns=1)[0]["output"]
    _check(all(n == 0 for n in read_counts().values()),
           f"idiotic launched kernels: {read_counts()}")
    _emit({"phase": 9, "N": N_MAIN, "T": T_MAIN, "kalman_logLt": kf_logLt,
           "tolerance": LOGLT_TOL, "nvidia_smi": smi, "schemes": schemes_out,
           "launches": multi_launches,
           "b5_on_the_runs_uniforms": b5_uniforms,
           "idiotic": {"T": T_IDIOTIC, "logLt": float(idiot.logLt),
                       "resampling_steps": int(idiot.rs_flags.sum()),
                       "warm_wall_s": idiot.cpu_time}})

    # -- 10. kernel times -----------------------------------------------------
    N = M = N_MAIN
    W = torch.from_numpy(_dirichlet_like(rng, "dirichlet1", N)).to(dev)
    u = torch.tensor(0.37, dtype=torch.float32, device=dev)
    z = ops.systematic_z_fused(W, u, M)
    x = torch.randn(N, device=dev)
    j = torch.arange(M, dtype=torch.int32, device=dev)
    cs = ops.normalised_cumsum_exact(W)
    cs1 = cs.clone()
    cs1[-1] = 1.0
    uu = torch.rand(M, device=dev)
    su = uu.sort().values
    zi = torch.randint(-2 ** 31, 2 ** 31 - 1, (N,), device=dev,
                       dtype=torch.int32)
    log2n = int(np.ceil(np.log2(N + 1)))
    # name: (kernel, plain, library call or None, bytes, operations)
    work = {
        "systematic_z": (
            lambda: ops.systematic_z_fused(W, u, M),
            lambda: ops.systematic_z_plain(W, u, M), None,
            8 * N, 7 * N),
        "repeat_by_z": (
            lambda: ops.ancestors_by_z(z, M),
            lambda: ops.repeat_cols_plain(z, M, [], want_anc=True),
            lambda: torch.searchsorted(z, j, right=True),
            4 * N + 8 * M, N + M),
        "normalised_cumsum": (
            lambda: ops.normalised_cumsum_exact(W),
            lambda: ops.normalised_cumsum_plain(W),
            lambda: torch.cumsum(W, 0),
            8 * N, 5 * N),
        "repeat_by_su": (
            lambda: ops.ancestors_by_su(uu, cs1),
            lambda: ops.repeat_cols_su_plain(uu, cs1, M, [], want_anc=True),
            lambda: torch.searchsorted(cs1, uu),
            4 * M + 4 * N + 8 * M, M * log2n),
        "merge_rank_counts": (
            lambda: ops.merge_rank_counts(su, cs, M),
            lambda: ops.merge_rank_counts_plain(su, cs, M),
            lambda: torch.searchsorted(su, cs, right=True),
            4 * M + 8 * N, N * log2n),
        "running_max": (
            lambda: ops.running_max(zi),
            lambda: ops.running_max_plain(zi),
            lambda: torch.cummax(zi, 0),
            8 * N, N),
    }
    meta = {
        "systematic_z": ("z_kernel.cu", "particles_tpu/ops/z_kernel.py:93",
                         err_plain, "main path"),
        "repeat_by_z": ("repeat_kernel.cu",
                        "particles_tpu/ops/repeat_kernel.py:70", b2_err,
                        "main path"),
        "normalised_cumsum": ("z_kernel.cu",
                              "particles_tpu/ops/z_kernel.py:106", b3_err,
                              "multiSMC"),
        "repeat_by_su": ("repeat_kernel.cu",
                         "particles_tpu/ops/repeat_kernel.py:70", 0,
                         "multiSMC"),
        "merge_rank_counts": ("merge_rank_kernel.cu",
                              "particles_tpu/ops/merge_rank_kernel.py:41", 0,
                              "multiSMC"),
        "running_max": ("cummax_kernel.cu",
                        "particles_tpu/ops/cummax_kernel.py:40", 0,
                        "multiSMC"),
    }
    kernels = []
    for name, (kern, plain, lib, nbytes, nops) in work.items():
        source, replaces, err, path = meta[name]
        ms, plain_ms = _time_ms(torch, kern), _time_ms(torch, plain)
        device_ms, per_call = _device_ms(torch, kern)
        if name in ("systematic_z", "normalised_cumsum", "repeat_by_z",
                    "merge_rank_counts", "running_max"):
            _check(per_call == 1, f"{name}: {per_call} CUDA kernels a call")
        if name == "repeat_by_su":   # the guide table's build, the serve
            _check(per_call == 2, f"{name}: {per_call} CUDA kernels a call")
        by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        by_ops = 1e3 * nops / OPS_PER_S
        path_launches = launches if path == "main path" else multi_launches
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"particles_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": path_launches[name],
            "launches_path": path, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None if lib is None else _time_ms(torch, lib),
            "device_ms": device_ms, "launches_per_call": per_call,
            "library_device_ms": (None if lib is None
                                  else _device_ms(torch, lib)[0])})
    # B2 as the main path calls it: one f32 column, on Dirichlet(1) z and
    # on the main path's degenerate weights (one particle takes nearly all)
    W_deg = torch.from_numpy(_dirichlet_like(rng, "degenerate", N)).to(dev)
    z_deg = ops.systematic_z_fused(W_deg, u, M)
    b2_col = {}
    for zname, zz in (("dirichlet1", z), ("degenerate", z_deg)):
        def one_col(zz=zz):
            return ops.repeat_cols(zz, M, [x])
        b2_col[zname] = {
            "ms": _time_ms(torch, one_col),
            "plain_ms": _time_ms(torch,
                                 lambda zz=zz: ops.repeat_cols_plain(zz, M,
                                                                     [x])),
            "device_ms": _device_ms(torch, one_col)[0]}
    # B5 on the degenerate CDF: one block's window is nearly all of su
    cs_deg = ops.normalised_cumsum_exact(W_deg)
    b5_deg = {
        "ms": _time_ms(torch, lambda: ops.merge_rank_counts(su, cs_deg, M)),
        "plain_ms": _time_ms(
            torch, lambda: ops.merge_rank_counts_plain(su, cs_deg, M)),
        "device_ms": _device_ms(
            torch, lambda: ops.merge_rank_counts(su, cs_deg, M))[0],
        "library_ms": _time_ms(
            torch, lambda: torch.searchsorted(su, cs_deg, right=True)),
        "library_device_ms": _device_ms(
            torch, lambda: torch.searchsorted(su, cs_deg, right=True))[0]}
    # B4 on sorted uniforms, and on the degenerate CDF (nearly every query
    # finds an empty range of cs)
    b4_more = {}
    for form, (q, c) in (("sorted", (su, cs1)), ("degenerate", (uu, cs_deg))):
        def b4(q=q, c=c):
            return ops.ancestors_by_su(q, c)

        def lib_b4(q=q, c=c):
            return torch.searchsorted(c, q)

        device_ms, per_call = _device_ms(torch, b4)
        _check(per_call == 2, f"repeat_by_su {form}: {per_call} CUDA "
                              f"kernels a call")
        b4_more[form] = {
            "ms": _time_ms(torch, b4),
            "plain_ms": _time_ms(torch, lambda q=q, c=c: (
                ops.repeat_cols_su_plain(q, c, M, [], want_anc=True))),
            "device_ms": device_ms, "launches_per_call": per_call,
            "library_ms": _time_ms(torch, lib_b4),
            "library_device_ms": _device_ms(torch, lib_b4)[0]}
    _emit({"phase": 10, "N": N_MAIN, "nvidia_smi": smi,
           "timing": "CUDA events, median of 25 batches of 10 calls; "
                     "device_ms: torch.profiler, 20 calls",
           "forms": "B2 and B4 ancestors only; B4 on unsorted uniforms",
           "repeat_by_z_one_f32_column": b2_col,
           "merge_rank_counts_degenerate": b5_deg,
           "repeat_by_su_sorted": b4_more["sorted"],
           "repeat_by_su_degenerate": b4_more["degenerate"],
           "bound": "max(bytes / 3.35 TB/s, operations / 67 TOP/s)"})
    smooth_launches = phase_history(torch, dev, smi, y, kf_logLt,
                                    1000.0 * wall / T_MAIN)
    checks = []
    for phase in (phase_offline, phase_online):
        launched, phase_checks = phase(torch, dev, smi)
        smooth_launches.update(launched)
        checks += phase_checks
    zoo_launches, zoo_checks = phase_zoo(torch, dev, smi, y, kf_logLt,
                                         1000.0 * wall / T_MAIN)
    checks += zoo_checks
    sqmc_launches, sqmc_checks = phase_sqmc(torch, dev, smi, y, kf_logLt,
                                            1000.0 * wall / T_MAIN)
    checks += sqmc_checks
    sampler_launches, sampler_checks, pima_logLt = phase_samplers(
        torch, dev, smi, 1000.0 * wall / T_MAIN)
    checks += sampler_checks
    outer_launches, outer_checks = phase_outer(torch, dev, smi, y)
    checks += outer_checks
    nested_launches, nested_checks = phase_nested(torch, dev, smi,
                                                  pima_logLt)
    checks += nested_checks
    dist_launches, more = phase_distributed(torch, dev, smi, y, kf_logLt,
                                            dist_more_jobs(y))
    dist_launches.update(phase_dist_more(torch, dev, smi, y, pima_logLt,
                                         more))
    helper_launches = phase_host_helpers(torch, dev, smi, y, kf_logLt)
    # the largest error against the plain version includes the smoothing,
    # zoo, SQMC, sampler, outer-loop and nested phases' checks on their own
    # inputs
    path_err = {"systematic_z": "systematic_z_err",
                "repeat_by_z": "repeat_by_z_err",
                "normalised_cumsum": "normalised_cumsum_err",
                "repeat_by_su": "repeat_by_su_err"}
    for k in kernels:
        k["launches_smoothing"] = {run: n[k["name"]]
                                   for run, n in smooth_launches.items()}
        k["launches_zoo"] = {run: n[k["name"]]
                             for run, n in zoo_launches.items()}
        k["launches_sqmc"] = {run: n[k["name"]]
                              for run, n in sqmc_launches.items()}
        k["launches_samplers"] = {run: n[k["name"]]
                                  for run, n in sampler_launches.items()}
        k["launches_outer"] = {run: n[k["name"]]
                               for run, n in outer_launches.items()}
        k["launches_nested"] = {run: n[k["name"]]
                                for run, n in nested_launches.items()}
        k["launches_distributed"] = {run: n[k["name"]]
                                     for run, n in dist_launches.items()}
        k["launches_host_helpers"] = {run: n[k["name"]]
                                      for run, n in helper_launches.items()}
        if k["name"] in path_err:
            k["max_abs_err"] = max([k["max_abs_err"]] + [
                c.get(path_err[k["name"]], 0) for c in checks])
    _emit({"kernels": kernels})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
