"""Smoke run of the PyTorch/CUDA port (fastoptsolver_tpu_torch) on one GPU.

    python3 chip_smoke.py      # one H100; about 9 minutes including the nvcc build

Phases, one line each (``--`` lines are detail):

1. device — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build  — nvcc builds the kernels from ``kernels/csrc``, one process per
   source, all at once (seconds; each instantiation's registers, named with
   its template arguments, e.g. ``fused_lasso_solve_kernel<5,1,false>`` for
   n=5 in restart mode, and any spill);
3. kernel vs twin — each CUDA kernel against its plain PyTorch twin on the
   card: the fused solve at three small shapes (nesterov, and delta with
   α₂=0.3; x to rtol 1e-5/atol 1e-6, ``converged`` identical, ``iters``
   within ``check_every``; restart and greedy at rel_gap_tol 1e-5,
   ``converged`` identical, ``iters`` within a burst, x to rtol 2e-4/atol
   2e-5), Armijo with table-β and with restart in the decisive regime (x to
   rtol 1e-4/atol 1e-5), a 75 + 125 resume bit-exact in every mode and with
   tiles at different k; the stream pass (to 1e-5 of each lane's absolute
   sum) with its 16-byte and 4-byte loads, both required, as the C export
   ``stream_copy_bytes`` reports them, then both at the bench shape; the
   Gram build at n ∈ {9, 20, 64}
   with B % 4 == 0 and at n = 9 with B = 301 (``gram_pairs``' 16-byte and
   4-byte copies, both required) and at the wide-n shape (Q, c, bᵀb to 1e-5
   of each lane's largest entry, λ to 1e-5 relative); the burst kernel at
   n = 20 in every mode (one burst: state to rtol 2e-4/atol 2e-5; fixed runs, ``check_every=0``: x to rtol
   2e-4/atol 2e-5; certified runs at rel_gap_tol=1e-5: ``converged``
   identical, ``iters`` within ``check_every``; Armijo in the decisive regime: x to rtol 1e-4/atol
   1e-5), a 40 + 60 resume bit-exact against 100 straight iterations, one
   burst in fixed Nesterov and in restart at n ∈ {5, 9, 33, 64, 96, 104},
   B = 301 (each lanes-a-CTA count of the window: 32, 16, 13, 6 and 5; the
   C exports ``fista_burst_group`` and ``fista_burst_smem_bytes`` printed),
   and fixed Nesterov at the wide-n shape; ``gram_power`` alone at
   n ∈ {1, 5, 31, 32, 33, 96, 113, 118}, B = 301, against the twin's power
   iteration on the same Gram and c (λ to 1e-5 relative), and its C exports
   ``gram_power_group``/``gram_power_smem_bytes`` equal to their Python
   mirrors for n = 1..128; the resident kernel at
   n ∈ {5, 33, 112, 113, 128, 150, 168} (groups of 32, 16, 8, 8, 6, 4 and 3
   lanes; 128 is the resident path's width), B = 300, every mode with L estimated in-kernel (certified
   runs at rel_gap_tol 1e-5: ``converged`` identical, ``iters`` within a
   burst, x to rtol 2e-4/atol 2e-5) and Armijo in the decisive regime (x to
   rtol 1e-4/atol 1e-5), against its twin at the kernel's lane grouping,
   once more at n = 128 on a Gram that is not bit-symmetric (both read the
   upper triangle), and the library's grouping equal to the twin's for every
   n of the window; the adaptive entry onto it at n = 96, B = 300 (restart
   and greedy, each timed, median of 5, beside its bound); the Q-streaming
   engine at n ∈ {200, 256}, B = 300, one burst per mode (state to rtol
   2e-4/atol 2e-5) and a certified run, then one burst per mode at
   n ∈ {120, 400, 600, 900}, B = 100 (the cluster kernel at each cluster
   size the rule reaches, 2, 4 and 8 CTAs a lane, and the streaming kernel
   past n = 660), each burst also bit for bit against the streaming kernel
   forced at the same n, both routes required, every n's cluster size,
   shared bytes a CTA and active clusters printed, and a fixed run with
   ``check_every=0`` at n = 120 (the window's route to this engine); a
   40 + 60 resume bit-exact for each engine;
4. main path — ``solve_lasso_batch`` at the bench configuration (n=5,
   m=1000, float32, fixed Nesterov momentum, check_every=25, rel_gap_tol=1e-6,
   max_iter=1000) on data the ported generator makes on the card; every lane
   must certify, none may fail, and 4096 sampled lanes are rechecked in
   float64; then one read-ceiling measurement, the bench path's roofline;
5. times — the headline's measurement (``bench/headline.py``: its data
   recipe made phase 4's inputs, its ``measure`` and ``kernel_ms`` time
   here): CUDA events, median of 5 solves interleaved with the stream
   ceiling and with one torch call for its sums (``A.sum((0, 1)) +
   b.sum(0)``): solve ms and instances/s (every timed solve must certify
   every lane), ceiling GB/s, pct_of_achievable, the twin's time, iteration
   median and maximum, the torch sums against the ceiling;
6. wide-n path — ``solve_lasso_batch`` at ``bench/wide_n.py``'s first width
   (n=96, m=192, B=54144: a 2 GB Gram; data from
   ``bench.wide_n.build_problems`` on the card; the default certified
   config): the two-kernel path, so the build kernels launch twice, the
   burst kernel once per burst and the fused kernel never. In f32 ~85% of
   these lanes reach 1e-6 within max_iter (the JAX reference certifies ~86%
   on its own recipe): none may fail, every certified lane is ≤ 1e-6, every
   lane ≤ 1e-5, at least 80% certify, 4096 sampled lanes are rechecked in
   float64 (≤ 1e-4), and ``solve_gram_batch`` on the built Gram must give
   the same x; then CUDA event medians of 3: the build kernels, and
   ``gram_pairs`` and ``gram_power`` each alone, vs their twins (the pairs'
   L2 read rate beside one ``torch.einsum`` of the same pair sums), the
   burst solve (median of 5) vs its twin, its launches back to back and a
   launch with no step (the Gram's copy-in; both medians of 5), the burst
   kernel's lanes a CTA, shared bytes and Q bytes read from device memory
   a launch, ``gram_power``'s lanes a CTA, shared bytes and the rate its
   matvecs read Q from shared memory (96·n²·B·4 bytes over its time) beside
   the shared-memory floor (those bytes at 128 B a clock on every SM at the
   largest SM clock), the routed call (median of 5; ms, certified instances/s) and
   the torch driver on the same Gram (the route this path replaces);
7. resident path — the same recipe at n=128, m=256, B=30464 (a 2 GB Gram):
   the einsum build without the power loop and one launch of the resident
   kernel, nothing else; the same checks with at least 80% certified (the
   JAX driver: 88% at B = 256), and ``solve_gram_batch(gb, est_l_iters=96)``
   on the ``estimate_l=False`` Gram must give the same x; then medians of 3:
   the routed call, the kernel solve alone, a one-step launch (the copy-in
   of the Gram and two matvecs), the twin and the kernel on the first 3840
   lanes (the twin is per-plane torch ops), and the torch driver; the
   kernel and the twin on those lanes are held as in phase 6 (below); the
   kernel's lanes a CTA, shared bytes, and the rate it reads Q from shared
   memory: lane-matvecs (96 power steps a lane, the steps each group runs,
   a gap every 25) × n² × 4 bytes over its time, beside the shared-memory
   floor; and two splits, a one-step launch after 96 power steps and 1000
   steps in every group (tol 0), as µs a CTA-step;
8. Q-streaming path — n=256, m=512, B=7552: the einsum build with its power
   loop and one Q-streaming launch per burst, nothing else; at least 75%
   certified (the JAX driver: 82%); then the routed call, the engine's solve
   alone (the re-layout and the launches), the twin and the kernel on the
   first 1920 lanes, held as in phase 6, and the torch driver; then the
   cluster kernel's parts: its cluster size, shared bytes a CTA and active
   clusters, Q bytes read from device memory a launch, the re-layout (median
   of 5), the bursts back to back and a launch with no step and no gap (the
   copy-in; both medians of 5), the matvecs' shared-memory read rate, the
   bursts at each cluster size 2, 4 and 8 (medians of 3), and the streaming
   kernel forced at n = 256 against the cluster kernel in turns (old, new,
   new, old), their bursts held bit-identical.
9. fused modes path — the bench configuration through ``solve_lasso_batch``
   in adaptive restart, greedy, Armijo (table-β) and Armijo with restart:
   one fused launch and nothing else per call, no lane failed, the certified
   share printed (restart and greedy held at the JAX reference's share on
   the same recipe less one point, ``REFERENCE_SHARE``; Armijo's stall is
   the reference's own), the certified lanes of 4096 sampled ones rechecked
   in float64 (≤ 1e-4 outside Armijo; Armijo's stalled lanes are reported),
   kernel vs twin on the first 3840 lanes (objective
   held as phase 3's bench-shape rule holds it, split lanes' gaps ≤ 1e-5
   outside Armijo), CUDA-event medians of 3 of the routed call and the
   kernel; then 100 iterations, the ``FusedSolveState``, resumed to 1000,
   bit-equal to a straight run (three fused launches).
10. cv — ``cv_lasso`` at the shape of UCI's YearPredictionMSD regression
   (515,345 × 90; A ~ N(0, 1), a 10%-sparse x_true with N(0, 9) entries,
   noise σ = 9, made on the card from seed 0) with the reference's defaults
   (5 folds, 50 alphas, eps 1e-3, max_iter 2000, check_every 25) and
   ``fit_intercept=True``: 300 lanes at n = 90, so the burst kernel and
   nothing else launches; once as lasso and once as an elastic-net ladder
   (``l1_ratio=0.5``, α₂ varying by lane), each held against
   ``backend="xla"`` (the torch driver) on the same data: certified counts
   within 1% of lanes, the float64 objective on lanes both certify within
   1e-5 relative, ``mse_mean`` within 1e-5 relative, the same ``best_idx``
   unless the two minima tie within that tolerance, and the refit lanes'
   float64 gap ≤ 1e-4; then the call's ms (median of 3) split into the
   folds and Grams, the Lipschitz loop and the routed solve (its bound, the
   burst twin and the driver on the same grid beside it), and
   ``lasso_path`` on the same data (the torch driver; every lane
   certified, no kernel launched).
11. solve — the single-problem layer, which reaches no kernel: ``solve``
   with each of its nine methods at its defaults on the YearPredictionMSD
   shape with AR(1) columns at ρ = 0.9 (``ar1_problem``; α₁ = 0.1·‖Aᵀb‖∞,
   lbfgs as ridge with α₂ = α₁, svrg and saga cut to one epoch): route
   (Gram or raw), iterations, ms (CUDA events, median of 3; cd one call),
   µs a step; each method held at its ``SOLVE_HOLDS`` limit on the relative
   objective difference and ‖x − x_ref‖∞/‖x_ref‖∞, fista, fista_delta, cd,
   owlqn and lbfgs against CD's float64 optimum (lbfgs: the ridge closed
   form), ista, svrg and saga against the same call in float64 on the
   card, admm against the same call on the CPU (its float64 run printed);
   each against a control with α 1% high that its hold must refuse, and
   fista and admm also read on Q rounded to TF32 (printed); fista, ista and
   cd also against the same call on the CPU (``SOLVE_CPU_RTOL``, the α-high
   call refused); ``solve_batch`` on the
   reference's 80 scenarios in float64 (fista, ista, lbfgs), every lane
   against its single solve (``SWEEP_RTOL``, iterations equal), both
   timed; ``compat`` in float32 on the card against float64 on the CPU and
   ``LBFGSSolver`` against ``scipy.optimize.fmin_l_bfgs_b``
   (``COMPAT_RTOL``); every kernel count stays 0 over these; then
   ``bench.large_lasso.run`` at 131072 × 2048 for 500 iterations (ms an
   iteration against its 0.641 ms bound, the read ceiling on A's bytes:
   the stream kernel launches there) with the timed run's x held as the
   table's are against the same iterations in float64 (``LARGE_HOLD``, an
   α-high control refused).
12. estimators — the estimator surface on phase 11's table, moved once to
   NumPy float64: ``LassoCV(cv=5, n_alphas=50)`` and
   ``ElasticNetCV(l1_ratio=[0.5, 0.9], n_alphas=50)`` through the burst
   kernel (its bursts a ``cv_lasso`` call and the lanes certified after
   each, more than one burst required, every other engine 0), held against
   the torch driver (``EST_CV_HOLD``) and against the same estimator in
   float64 on the CPU (``EST_FIT_HOLD``), each against its controls, the
   fit timed and split; the plain estimators (``EST_PLAIN_HOLDS``), the
   problem families through fista (``EST_FAMILY_HOLDS``), a sparse lasso
   at LIBSVM E2006-tfidf's shape (``SPARSE_HOLD``, ms an iteration against
   its bound) and the generalized lasso (``GENLASSO_HOLDS``), each against
   its float64 yardstick with a control refused; no kernel launches there.
13. streaming — ``bench.streaming_lasso.measure`` at the reference's
   default shape (m = 2²¹, n = 1280, 32 chunks of 65536 rows, A 10.7 GB
   pre-generated in host RAM) and at n = 10000 with m cut to 2¹⁷ (16
   chunks of 8192 rows; the check pass makes them anew through
   ``generator_chunks``): the pass (host cast into the pinned ring, copies
   on a side stream, one f32 AᵀA and a Kahan step a chunk) beside the
   pinned link ceiling and the host-cast rate, and the dense solve's µs an
   iteration beside its bound; Q, c and bᵀb held against a float64
   reduction of the same chunks on the card (``STREAM_ACC_HOLD`` against
   the exact sum of the chunks' f32 products, a plain f32 sum refused;
   ``STREAM_REL_HOLD`` against the float64 Gram, a TF32 product refused);
   the f32 x against ``fista_gram_dense`` in float64 on the float64 Gram
   (``STREAM_X_HOLD``, α₁ 1% high refused); every kernel count stays 0.
14. ablate, checkpoint, runtime, profile — ``bench.ablate.main`` with
   ``--mode routed,fused1,burst,adaptive,build-only`` and with
   ``--restart --mode routed,fused1`` at B = 65536 (every trial's ms a
   solve, each mode's launches counted: fused, build, burst and resident);
   phase 9's 100-iteration ``FusedSolveState`` through
   ``save_pytree``/``restore_pytree`` and resumed, bit-equal to 1000
   straight; the native host library built by ``runtime.ensure_built``
   and ``ScenarioLoader`` feeding 3 batches into ``solve_lasso_batch`` (one
   fused launch each, every lane certified); ``utils.trace`` around one
   routed solve, its top device ops printed.
   Phase 6 also
   times batched ``torch.linalg.eigvalsh`` on ``POWER_LIB_LANES`` of its
   Grams, the library call for ``gram_power``'s λ_max, between two
   launches of the kernel on the same lanes.

Phases 6-8 hold each engine against its twin on the path's own Grams, where
lanes near the f32 floor certify or not by the gap's last bits, which kernel
and twin reduce in other orders: some lanes certify on both sides, x agrees
there to rtol 2e-4/atol 2e-5, and where one side alone certifies, both gaps
are within 1e-5. ``converged`` and ``iters`` are reported there, not held:
they are held at B = 300 and rel_gap_tol 1e-5 in phase 3.

Launch counts are set to 0 just before each main-path call (phase 4's solve,
phase 4's ceiling measurement, phases 6, 7 and 8's solves, phase 9's solve
per mode and its checkpointed run, phase 10's two CV calls and its path,
phase 11's solves, phase 12's fits, phase 13's cells, phase 14's two
ablate runs, its loader and its traced solve) and read just after it. The script then
prints the per-kernel JSON line (``ms`` is the kernel's own time: the fused
and stream launches, the two build launches, and one certified solve of the
burst, resident and Q-streaming engines; ``e2e_ms`` is the routed call;
``bound_ms`` the larger of the bytes over 3.35 TB/s and the float32
operations of this run's data over 67 TFLOP/s, ``bound_by`` which;
``library_ms`` one torch call for the same function where there is one: the
sums of A and b for the stream pass, the pair sums as one ``torch.einsum``
for the build; the build's entry also gives ``gram_pairs`` and
``gram_power`` apart (``pairs_*``, ``power_*``); the burst entry its
``group_lanes``, ``smem_bytes``, ``q_bytes_per_launch`` and ``copy_in_ms``;
the build's ``power_group_lanes``, ``power_smem_bytes``,
``power_smem_read_gbps``, ``power_smem_floor_ms`` and ``power_library_ms``
(batched ``eigvalsh`` on ``power_library_lanes`` lanes, with
``power_turns_ms`` and the kernel's ``power_ms_at_library_lanes``); the resident entry its
``group_lanes``, ``smem_bytes``, ``smem_read_gbps``, ``lane_matvecs``,
``smem_floor_ms`` and the adaptive entry's phase-3 times
(``adaptive_entry``); the Q-streaming entry its ``cluster_size``,
``smem_bytes``, ``active_clusters``, ``q_bytes_per_launch``, ``copy_in_ms``,
``relayout_ms`` and phase 8's other splits; the fused entry's
``modes`` holds phase 9's times; the burst entry's ``cv`` phase 10's
launches, holds and times, its ``estimators`` phase 12's CV part and the
entry's ``launches`` phase 12's bursts too; the fused, build, burst and
resident entries' ``launches`` add phase 14's; phases 11-14 print their
records on ``-- solve record``, ``-- estimators record``, ``-- streaming
record`` and ``-- ablate record`` lines of their own), the card's name and power
limit, and,
last, ``{"ok": true, "device": {...}}``. It exits non-zero, printing no
result, when there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

FUSED_SRC = "fastoptsolver_tpu_torch/kernels/csrc/fused_solve.cu"
STREAM_SRC = "fastoptsolver_tpu_torch/kernels/csrc/stream.cu"
GRAM_SRC = "fastoptsolver_tpu_torch/kernels/csrc/gram_build.cu"
BURST_SRC = "fastoptsolver_tpu_torch/kernels/csrc/fista_burst.cu"
RESIDENT_SRC = "fastoptsolver_tpu_torch/kernels/csrc/resident.cu"
QSTREAM_SRC = "fastoptsolver_tpu_torch/kernels/csrc/qstream.cu"
SMALL_SHAPES = ((5, 250, 390), (1, 64, 128), (8, 333, 300))
BATCH = 262144  # the bench configuration's instances (bench.py:88)
# the last has B % 4 != 0: gram_pairs' 4-byte copies beside its 16-byte ones
BUILD_SHAPES = ((9, 33, 300), (20, 70, 200), (64, 128, 256), (9, 33, 301))
# with n = 20, a width for each lanes-a-CTA count of the burst kernel's window:
# 32 lanes (n <= 32), 16 (n = 33), 13 (n = 64), 6 (n = 96), 5 (n = 104)
BURST_WIDTHS = (5, 9, 33, 64, 96, 104)
# the resident kernel's widths in phase 3: each lanes-a-CTA count from 32 (n = 5)
# down to 3 (n = 168), the path's 128, and widths whose last warp is ragged. At
# the first three widths iters are held within a burst and Armijo's x as the
# decisive regime allows; at the others (the narrow ones, where a lane's gap can
# sit at the tolerance for two bursts, kernel and twin 50 iterations apart, and
# an Armijo accept at m = 2n rows can flip at the boundary) iters are reported
# and Armijo's x is held on the lanes whose steps τ agree, at most 1% of lanes
# flipped
RESIDENT_WIDTHS = (5, 33, 112, 113, 128, 150, 168)
RESIDENT_HELD = (112, 128, 168)
# gram_power's widths in phase 3: one warp a lane and its edges, the wide-n path's
# 96, and the window's top (113, 118: 8 lanes a CTA)
POWER_WIDTHS = (1, 5, 31, 32, 33, 96, 113, 118)
# bench/wide_n.py's first width: n = 96, m = 2n, B sized to a 2 GB Gram
WIDE_N = 96
WIDE_B = int(2e9 / (WIDE_N * WIDE_N * 4)) // 128 * 128  # 54144
# the lanes of phase 6's Grams on which batched eigvalsh (gram_power's library
# call) and the kernel are timed in turns
POWER_LIB_LANES = 1024
# the next widths of bench/wide_n.py's default list, each sized to a 2 GB Gram:
# the resident window (W1) and the Q-streaming engine (W2)
W1_N, W2_N = 128, 256
W1_B = int(2e9 / (W1_N * W1_N * 4)) // 128 * 128  # 30464
W2_B = int(2e9 / (W2_N * W2_N * 4)) // 128 * 128  # 7552
# phase 10: cv_lasso at the shape of UCI's YearPredictionMSD regression (515,345
# rows × 90 features) with the reference's defaults: 5 folds × 50 alphas, 300 lanes
CV_M, CV_N, CV_FOLDS, CV_ALPHAS = 515345, 90, 5, 50
# the kernel route's x against the torch driver's on lanes both certify: on
# this Gram (≈ m·I) the objective moves with the square of an error in x, so x
# is held too, each lane against the grid's largest |x| (``max_rel_dx``)
CV_X_RTOL = 1e-5
# phase 11: the single-problem layer on the YearPredictionMSD shape with AR(1)
# columns at ρ = 0.9 (a condition number near 361, where phase 10's i.i.d.
# columns give a Gram ≈ m·I that every solver leaves at once)
SOLVE_M, SOLVE_N, SOLVE_RHO = CV_M, CV_N, 0.9
SOLVE_METHODS = ("fista", "fista_delta", "ista", "cd", "admm", "owlqn", "lbfgs", "svrg", "saga")
# svrg and saga at their defaults run 50 epochs of m // 128 = 4026 steps: cut to 1
SOLVE_EPOCHS = 1

# each method's hold, (|f(x) − f_ref|/|f_ref|, ‖x − x_ref‖∞/‖x_ref‖∞) with f the
# float64 objective: the converging methods against the float64 optimum (lbfgs:
# ridge, against the closed form), ista, svrg and saga against the same call in
# float64 on the card, and admm against the same call on the CPU: its scaled
# dual (≈ α₁/ρ ≈ 1.5e3 against |x| ≤ 5) puts z on float32's 1.2e-4 grid, so
# its float32 path leaves float64's (PERF.md §6, PR 12). Each limit is near the
# geometric mean of the largest sound reading and the smallest α-1%-high
# control over the card's run and the CPU rehearsals at m and m/10 (readings
# and controls in PERF.md §6, PR 12)
SOLVE_AGAINST_F64_RUN = ("ista", "svrg", "saga")
SOLVE_AGAINST_CPU_RUN = ("admm",)
SOLVE_HOLDS = {"fista": (5e-8, 5e-4), "fista_delta": (5e-8, 5e-4), "cd": (7e-9, 1.2e-4),
               "owlqn": (1.5e-7, 7e-4), "lbfgs": (4e-7, 2e-3),
               "ista": (6e-7, 1.4e-4), "admm": (3e-5, 1e-4), "svrg": (1.1e-6, 1.5e-4),
               "saga": (2e-5, 3.4e-4)}
# the methods also read on Q rounded to TF32's mantissa (printed, not held)
SOLVE_TF32_CONTROL = ("fista", "admm")
# methods whose converged or float64 hold is also checked against the same call
# on the CPU: x within this share of max |x|, between the card's readings
# (≤ 8.0e-6) and the α-high call's (≥ 1.4e-3 in the CPU rehearsals)
SOLVE_ON_CPU = ("fista", "ista", "cd")
SOLVE_CPU_RTOL = 1e-4
# solve_batch's lanes against their single solves, float64 (max |dx| over
# max |x|; the CPU rehearsal: ≤ 1.7e-14)
SWEEP_RTOL = 1e-10
# bench.large_lasso at its default shape: iterations, and the timed run held as
# the table is against the same iterations in float64 (the CPU rehearsals at
# 8192 × 256 and 32768 × 1024: sound ≤ 3.7e-14 and ≤ 1.2e-7, the α-high
# control ≥ 8.3e-6 and ≥ 1.17e-3)
LARGE_ITERS = 500
LARGE_HOLD = (5e-10, 1e-5)

# phase 12: the estimator surface on phase 11's AR(1) table, moved once to NumPy
# float64 as a user's table arrives. Each hold is (relative objective, relative
# x) as phase 11's, its limit near the geometric mean of the largest sound
# reading and the smallest control reading over the CPU rehearsal and the card
# (readings in PERF.md §6). (a) LassoCV and ElasticNetCV: the kernel
# route against the torch driver on lanes both certify, and the fit against
# float64 on the CPU (mse_path_ over its least entry, coef_ over its largest,
# intercept_ over std(y), the float64 mean MSE at the card's choice over its
# minimum)
EST_L1_RATIOS = (0.5, 0.9)
EST_CV_HOLD = (5e-8, 4e-4)
# selection has no control reading (the ladder 1% high chooses alike): its limit
# lets the card choose an α whose float64 MSE is within 0.01% of the least
EST_FIT_HOLD = {"mse_path": 1e-4, "coef": 7.4e-5, "intercept": 4e-8, "selection": 1e-4}
# (b) the plain estimators against their float64 yardsticks, (c) the problem
# families through fista against the same solve in float64
EST_PLAIN_HOLDS = {"lasso": (3e-9, 1e-4), "elasticnet": (4e-9, 1.5e-4), "ridge": (7e-7, 2e-3),
                   "lasso_positive": (2e-10, 4e-5), "lasso_weighted": (2e-9, 7e-5),
                   "multitask": (5e-10, 4e-5)}
EST_FAMILY_HOLDS = {"nnls": (3e-10, 4e-5), "group": (2.5e-9, 7e-5), "box": (5e-8, 2.5e-4),
                    "slope": (4e-8, 2.4e-4), "weighted": (2e-9, 4.5e-5), "huber": (8e-9, 4e-5),
                    "quantile": (8e-7, 1e-4), "poisson": (1.6e-7, 4e-5)}
# fista's iterations a family (500, its default, unless named): the quantile
# loss's clip, of slope 1/μ = 10, amplifies rounding through the momentum, so
# its float32 and float64 runs part past ~200 iterations (x 5e-6 apart at 100,
# 6e-5 at 200, 2e-3 at 500 in the CPU rehearsal); Poisson's Armijo search, the
# reference's rule (τ never grows), collapses τ by iteration ~15-20 on this table
# in both precisions (to 1e-16 in float64), and the runs part after it
EST_FAMILY_ITERS = {"quantile": 100, "poisson": 10}
# (d) a sparse lasso at the shape of LIBSVM's E2006-tfidf regression set (16,087 ×
# 150,360), 1% of entries stored, 500 FISTA iterations against float64
SPARSE_M, SPARSE_N, SPARSE_DENSITY, SPARSE_ITERS = 16087, 150360, 0.01, 500
SPARSE_HOLD = (5e-9, 8e-5)
# (e) the generalized lasso: fused lasso on the table (ρ the mean eigenvalue of
# AᵀA, 2000 iterations, its default); TV denoising and trend
# filtering on a piecewise signal of GENLASSO_N samples at the reference tests'
# λ and ADMM's defaults (ρ = 1, 5000 iterations). The objective difference is
# read but its limit set loose: on a flat stretch the f32 x carries rounding
# noise that λ‖Dx‖₁ sums (the CPU rehearsal at n = 4096: TV's sound run 4.6e-5,
# its control 5.3e-5), so x is the measure that refuses the controls
GENLASSO_N = 4096
GENLASSO_LAM = {"tv_denoise": 2.0, "trend_filter": 10.0}
GENLASSO_HOLDS = {"fused_lasso": (4.4e-7, 3.5e-4), "tv_denoise": (1e-3, 8.9e-5),
                  "trend_filter": (1e-3, 1.4e-4)}

# compat in float32 on the card against float64 on the CPU (rel |dx| of max |x|,
# and LBFGSSolver's objective against SciPy's; the CPU rehearsal: ≤ 5.3e-7)
COMPAT_RTOL = 1e-5
# the fused kernel's modes besides fixed momentum, run at the bench configuration
FUSED_MODES = {"restart": dict(adaptive_restart=True), "greedy": dict(momentum="greedy"),
               "armijo": dict(backtracking=True),
               "armijo_restart": dict(backtracking=True, adaptive_restart=True)}
# the JAX reference's certified share on the bench recipe at B = 2048 (its
# fused engine in interpret mode on the CPU, tools/fused_modes_share.py);
# phase 9 holds restart and greedy at it less one point. Armijo certifies no
# lane there in 1000 iterations, in the reference too: printed, not held
REFERENCE_SHARE = {"restart": 1.0, "greedy": 1.0}
# the H100 SXM's data-sheet peaks: the
# bound of a kernel is the larger of its bytes over the memory rate and its
# float32 operations over the rate outside the tensor cores
# phase 13: streaming_lasso at its default shape (streaming_lasso.py:15-18 of the
# reference: m = 2^21, n = 1280, 65536-row chunks, A 10.7 GB in host RAM), then at
# the north-star width n = 10000 with m cut from 1e6 to 2^17 (8192-row chunks,
# A 5.2 GB): the f64 check pass and the generation of 1e10 normals would not fit
# the phase's share of the run
STREAM_CELLS = ((2 ** 21, 1280, 65536, None), (2 ** 17, 10000, 8192, 1_000_000))
STREAM_TOL = 1e-6
# the stored Q, c, bᵀb against the exact sum of the chunks' f32 products, in
# units of 2⁻²⁴·Σ|products|: a compensated sum is within Kahan's bound of 2
# (a plain f32 sum of N chunks only within N − 1)
STREAM_ACC_HOLD = 2.0
# their relative error (Frobenius, 2-norm, absolute) against the float64
# reduction of the same chunks; the TF32 control must exceed it. Near the
# geometric mean of the largest sound reading and the smallest control (on an
# H100 80GB HBM3 at 700 W: 3.666e-7 and 7.719e-6)
STREAM_REL_HOLD = 1.7e-6
# the f32 x of the timed solve against fista_gram_dense in float64 on the float64
# Gram (relative objective difference, relative |dx|), set as above (readings:
# 9.0e-14, 3.6e-7; α₁-1%-high controls 1.2e-5, 1.1e-3)
STREAM_X_HOLD = (1e-9, 2e-5)
# phase 14: ablate at a quarter of the bench batch; the loader's batches
ABLATE_BATCH = 65536
ABLATE_MODES = "routed,fused1,burst,adaptive,build-only"
LOADER_BATCH = 16384
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# shared memory serves an SM 128 bytes a clock (32 banks of 4 bytes); the floor
# of a kernel bound by its shared-memory reads is its bytes over that rate on
# every SM at the card's largest SM clock (nvidia-smi clocks.max.sm)
SMEM_BYTES_PER_CLOCK = 128


class PhaseFailed(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """A kernel's name with its template arguments from its mangled name,
    e.g. ``fused_lasso_solve_kernel<5,1,true>`` from ``..._kernelILi5ELi1ELb1EEEv...``."""
    import re

    m = re.search(r"([a-z][a-z_]*_kernel)(I(?:L[a-z]\d+E)+E)?", mangled)
    if m is None:
        return mangled
    args = re.findall(r"L([a-z])(\d+)E", m.group(2) or "")
    shown = [("true" if v == "1" else "false") if t == "b" else v for t, v in args]
    return m.group(1) + (f"<{','.join(shown)}>" if shown else "")


def median(xs):
    return sorted(xs)[len(xs) // 2]


def cuda_ms(fn, reps: int = 1):
    """(ms per call, last result) of ``fn`` timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps, out


def smem_floor_ms(n_bytes: float) -> float:
    """The least ms the card's shared memory takes to serve ``n_bytes`` of
    reads: 128 B a clock on every SM at the largest SM clock."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_bytes / (sms * SMEM_BYTES_PER_CLOCK * mhz * 1e6) * 1e3


def bound(n_bytes: float, n_ops: float):
    """(the least ms the card could take, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def group_steps(iters, group: int) -> int:
    """Lane-steps of a solve whose lanes iterate in groups of ``group``
    until the group's last lane is done: each group runs to its largest
    ``iters`` (lanes that never certify have iters = k_end)."""
    import torch

    it = iters.long()
    pad = (-it.numel()) % group
    full = torch.cat([it, it.new_zeros(pad)]).view(-1, group).amax(1)
    sizes = torch.full_like(full, group)
    sizes[-1] = group - pad
    return int((full * sizes).sum())


def solve_ops(n: int, lane_steps: int, chunk: int, extra_per_step: int = 0) -> float:
    """Float operations of certified FISTA steps on a Gram: a matvec (2n²)
    and ~9n elementwise per step, a gap (a matvec and ~15n) per burst."""
    return lane_steps * (2 * n * n + 9 * n + extra_per_step) + \
        lane_steps / chunk * (2 * n * n + 15 * n)


def small_problem(n: int, m: int, B: int, seed: int, device):
    """Random lasso instances, feature-leading, made with numpy from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m, B))
    for k in range(1, n):  # AR(1) features, ρ = 0.2: 25-50 iterations, and
        # conditioned so that f32 rounding moves x by < 1e-5 relative
        A[k] = 0.2 * A[k - 1] + np.sqrt(1 - 0.04) * A[k]
    A = A.astype(np.float32)
    xt = np.zeros((n, B), np.float32)
    xt[: max(n // 2, 1)] = rng.normal(size=(max(n // 2, 1), B))
    b = (np.einsum("nmb,nb->mb", A, xt)
         + 2.0 * rng.normal(size=(m, B))).astype(np.float32)
    a1 = 0.1 * np.abs(np.einsum("nmb,mb->nb", A, b)).max(axis=0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return t(A), t(b), t(a1.astype(np.float32))


def compare_fused(res_k, res_t, check_every: int, label: str) -> float:
    import torch

    xk, xt = res_k.x.float(), res_t.x.float()
    err = float((xk - xt).abs().max())
    close = torch.allclose(xk, xt, rtol=1e-5, atol=1e-6)
    same_conv = bool(torch.equal(res_k.converged, res_t.converged))
    d_iters = int((res_k.iters.long() - res_t.iters.long()).abs().max())
    print(f"-- fused {label}: max|dx|={err:.3e} allclose={close} "
          f"converged_equal={same_conv} max|d_iters|={d_iters} "
          f"certified={int(res_k.converged.sum())}/{res_k.converged.numel()}")
    require(close and same_conv and d_iters <= check_every,
            f"fused kernel disagrees with its twin at {label}")
    return err


def objective64(A, b, alpha1, x, chunk: int = 16384):
    """Per-lane lasso objective ½‖Ax − b‖² + α₁‖x‖₁ in float64, by lane chunks."""
    import torch

    out = []
    for s in range(0, x.shape[0], chunk):
        sl = slice(s, s + chunk)
        r = torch.einsum("nmb,bn->mb", A[:, :, sl].double(), x[sl].double()) - b[:, sl].double()
        out.append(0.5 * (r * r).sum(0) + alpha1[sl].double() * x[sl].double().abs().sum(1))
    return torch.cat(out)


def compare_fused_bench(A, b, alpha1, res_k, res_t, check_every: int):
    """Kernel vs twin at the bench shape. The bench data are correlated
    (ρ up to 0.9), and there f32 rounding of the Gram alone moves x by up to
    ~5e-4 (the twin against itself with a float64-accumulated Gram:
    tests/test_torch_slice.py::test_gram_rounding_moves_x_on_bench_inputs),
    so x is reported and the objective is held: both
    sides certify a relative gap ≤ 1e-6, which bounds each objective to
    1e-6·max(f, 1) above the optimum; the check allows 1e-6 between them.
    ``iters`` is reported, not held: on a slowly converging lane the f32 gap
    can sit near the tolerance for several bursts, so the burst at which it
    first certifies moves with the rounding (the twin against itself, as
    above, moves it by a burst)."""
    import torch

    dx = float((res_k.x - res_t.x).abs().max())
    f_k = objective64(A, b, alpha1, res_k.x)
    f_t = objective64(A, b, alpha1, res_t.x)
    dobj = float(((f_k - f_t).abs() / f_t.clamp_min(1.0)).max())
    same_conv = bool(torch.equal(res_k.converged, res_t.converged))
    d_iters = (res_k.iters.long() - res_t.iters.long()).abs()
    print(f"-- fused bench {tuple(A.shape)}: max|dx|={dx:.3e} max rel|dobj|={dobj:.3e} "
          f"converged_equal={same_conv} max|d_iters|={int(d_iters.max())} "
          f"lanes with |d_iters| > {check_every}: {int((d_iters > check_every).sum())}")
    require(dobj <= 1e-6 and same_conv,
            "fused kernel disagrees with its twin at the bench shape")
    return dx, dobj


def noise_free(n: int, m: int, B: int, seed: int, device, alpha1=None):
    """The reference's resume recipe (tests/test_fused_resume.py): i.i.d.
    features, a 2-sparse x_true, b without noise, α₁ = 0.1·‖Aᵀb‖∞ or the
    given constant; made with numpy from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m, B)).astype(np.float32)
    xt = np.zeros((n, B), np.float32)
    xt[:2] = rng.normal(size=(2, B))
    b = np.einsum("nmb,nb->mb", A, xt).astype(np.float32)
    a1 = 0.1 * np.abs(np.einsum("nmb,mb->nb", A, b)).max(axis=0)
    if alpha1 is not None:
        a1 = np.full(B, alpha1)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    return t(A), t(b), t(a1)


def check_fused_modes(dev) -> float:
    """The fused kernel against its twin in the modes past fixed momentum:
    restart and greedy certified at each small shape (rel_gap_tol 1e-5:
    ``converged`` identical, ``iters`` within a burst, x to rtol 2e-4/atol
    2e-5); Armijo with table-β and with restart in the decisive regime (α₁ =
    0.5, L understated 4×, 6 iterations: x to rtol 1e-4/atol 1e-5); a 75 +
    125 resume bit-exact against 200 straight iterations in every mode, and
    with tiles at different k. Returns the largest |dx|."""
    import dataclasses

    import torch

    from fastoptsolver_tpu_torch.batch import BatchFISTAConfig
    from fastoptsolver_tpu_torch.kernels import fused_solve

    worst = 0.0
    for i, (n, m, B) in enumerate(SMALL_SHAPES):
        A, b, a1 = small_problem(n, m, B, seed=i, device=dev)
        for name in ("restart", "greedy"):
            cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-5,
                                   **FUSED_MODES[name])
            rk = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=cfg)
            torch.cuda.synchronize()
            rt = fused_solve.fused_solve_reference(A, b, a1, 0.0, cfg=cfg)
            worst = max(worst, compare_certified(rk, rt, f"fused {(n, m, B)} {name}"))
    A, b, a1 = noise_free(5, 96, 300, seed=1, device=dev, alpha1=0.5)
    for restart in (False, True):
        cfg = BatchFISTAConfig(max_iter=6, check_every=6, backtracking=True,
                               t_init_factor=4.0, adaptive_restart=restart)
        rk = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=cfg)
        torch.cuda.synchronize()
        rt = fused_solve.fused_solve_reference(A, b, a1, 0.0, cfg=cfg)
        dx = float((rk.x - rt.x).abs().max())
        print(f"-- fused armijo decisive restart={restart}: max|dx|={dx:.3e} "
              f"bit-equal={bool(torch.equal(rk.x, rt.x))}")
        require(bool(torch.allclose(rk.x, rt.x, rtol=1e-4, atol=1e-5))
                and bool(torch.equal(rk.iters, rt.iters)),
                f"fused kernel armijo restart={restart}: decisive run differs from the twin")
        worst = max(worst, dx)
    A, b, a1 = noise_free(5, 96, 300, seed=1, device=dev)
    for name, kw in {"nesterov": {}, **FUSED_MODES}.items():
        full = BatchFISTAConfig(max_iter=200, check_every=25, **kw)
        straight, end = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=full,
                                                      return_state=True)
        _, mid = fused_solve.solve_lasso_fused(A, b, a1, 0.0, return_state=True,
                                               cfg=dataclasses.replace(full, max_iter=75))
        resumed, end2 = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=full, state0=mid,
                                                      return_state=True)
        same = all(bool(torch.equal(getattr(resumed, f), getattr(straight, f)))
                   for f in ("x", "iters", "rel_gap", "converged"))
        require(same and all(bool(torch.equal(u, v)) for u, v in zip(end, end2)),
                f"fused kernel resume 75 + 125 is not bit-exact ({name})")
    A, b, a1 = noise_free(5, 96, 300, seed=4, device=dev)
    a1 = torch.where(torch.arange(300, device=dev) < 128,
                     10.0 * torch.einsum("nmb,mb->nb", A, b).abs().amax(0), a1)
    cfg = lambda it: BatchFISTAConfig(max_iter=it, check_every=25)
    straight = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=cfg(400))
    _, mid = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=cfg(150), return_state=True)
    kvals = sorted(set(mid.k.tolist()))
    resumed = fused_solve.solve_lasso_fused(A, b, a1, 0.0, cfg=cfg(400), state0=mid)
    require(len(kvals) > 1 and bool(torch.equal(resumed.x, straight.x))
            and bool(torch.equal(resumed.iters, straight.iters)),
            f"fused kernel: the resume with tiles at k = {kvals} is not bit-exact")
    print(f"-- fused resume 75 + 125 == 200: bit-exact (every mode); tiles at k = {kvals} "
          f"resume bit-exact; launches so far {fused_solve.LAUNCHES}")
    return worst


def compare_stream(A, b, label: str) -> float:
    import torch

    from fastoptsolver_tpu_torch.bench.stream import stream_pass, stream_pass_reference

    out_k = stream_pass(A, b)
    out_t = stream_pass_reference(A, b)
    scale = A.abs().sum(dim=(0, 1)) + b.abs().sum(dim=0)
    err = (out_k - out_t).abs()
    worst = float((err / scale).max())
    print(f"-- stream {label}: max|d|={float(err.max()):.3e} "
          f"max|d|/sum|x|={worst:.3e}")
    require(bool(torch.isfinite(out_k).all()) and worst <= 1e-5,
            f"stream kernel disagrees with its twin at {label}")
    return float(err.max())


def compare_build(A, b, label: str, lam_tol: float = 1e-5) -> float:
    """The build kernels against their twin on the same (A, b): Q, c, bᵀb to
    1e-5 of each lane's largest entry (the row sums run in other f32
    orders), λ to ``lam_tol`` relative (the kernel's matvec rounds as the
    twin's; only the norm's order and the Gram's rounding differ). Returns
    the largest absolute difference of Q."""
    import torch

    from fastoptsolver_tpu_torch.kernels import gram_build

    pl_iters = 32 if A.shape[0] <= 7 else 96
    got = gram_build._launch(A, b, pl_iters)
    torch.cuda.synchronize()
    want = gram_build.gram_build_reference(A, b, pl_iters)
    scale = torch.maximum(want[0].abs().amax(dim=(0, 1)), want[2])
    rel = [float(((g - w).abs() / scale).max()) for g, w in zip(got[:3], want[:3])]
    dlam = float(((got[3] - want[3]).abs() / want[3].abs().clamp_min(1e-30)).max())
    err = float((got[0] - want[0]).abs().max())
    n_off = int((((got[3] - want[3]).abs() / want[3].abs().clamp_min(1e-30)) > 1e-5).sum())
    print(f"-- build {label}: max|dQ|/scale={rel[0]:.3e} |dc|={rel[1]:.3e} "
          f"|dbtb|={rel[2]:.3e} max rel|dlam|={dlam:.3e} (lanes above 1e-5: "
          f"{n_off}) symmetric={bool(torch.equal(got[0], got[0].transpose(0, 1)))}")
    require(max(rel) <= 1e-5 and dlam <= lam_tol and bool(torch.isfinite(got[0]).all()),
            f"build kernels disagree with their twin at {label}")
    return err


def burst_inputs(gb, cfg):
    """The per-lane rows of one burst from a GramBatch (fista_vmem's rules)."""
    import torch

    greedy = cfg.momentum == "greedy"
    tau = ((cfg.greedy_xi if greedy else cfg.t_init_factor) / gb.L)[None, :].contiguous()
    n, B = gb.c.shape
    rows = dict(tau=tau, thr=(tau * gb.alpha1[None, :]).contiguous(),
                a2=gb.alpha2[None, :].contiguous(), a1=gb.alpha1[None, :].contiguous(),
                btb=gb.btb[None, :].contiguous(), taumin=(1.0 / gb.L)[None, :].contiguous())
    g = torch.Generator(device=gb.c.device).manual_seed(7)
    X = 0.1 * torch.randn((n, B), generator=g, device=gb.c.device)
    Y = X + 0.01 * torch.randn((n, B), generator=g, device=gb.c.device)
    t = tau.clone() if greedy else torch.full_like(tau, 1.7)
    ps = torch.full_like(tau, 0.05)
    return rows, X, Y, t, ps


def check_bursts(dev):
    """The burst kernel against its twin at n = 20 in every mode. Returns the
    largest |dx| seen."""
    import dataclasses

    import torch

    from fastoptsolver_tpu_torch.batch import BatchFISTAConfig
    from fastoptsolver_tpu_torch.kernels import fista_vmem, gram_build
    from fastoptsolver_tpu_torch.kernels.fista_vmem import (
        _armijo_static, _beta_table, _burst_reference, _launch_burst,
        fista_gram_vmem, fista_gram_vmem_reference)

    A, b, a1 = small_problem(20, 150, 300, seed=11, device=dev)
    gbs = {a2: gram_build.make_gram_batch_fused(A, b, a1, a2) for a2 in (0.0, 0.3)}
    modes = {"nesterov": (dict(), 0.0), "delta_ridge": (dict(momentum="delta"), 0.3),
             "restart": (dict(adaptive_restart=True), 0.0),
             "greedy": (dict(momentum="greedy"), 0.0)}
    worst = 0.0
    for name, (kw, a2) in modes.items():
        gb = gbs[a2]
        # one burst of 25 from a non-trivial state, with the gap
        cfg = BatchFISTAConfig(max_iter=100, check_every=25, **kw)
        rows, X, Y, t, ps = burst_inputs(gb, cfg)
        static = dict(n_steps=25, with_gap=True,
                      restart_threshold=cfg.restart_threshold if cfg.adaptive_restart else None,
                      greedy=(cfg.greedy_S, cfg.greedy_shrink) if cfg.momentum == "greedy" else None,
                      armijo=_armijo_static(cfg))
        args = (_beta_table(100, cfg).to(dev), 25, gb.Q, gb.c, rows["tau"], rows["thr"],
                rows["a2"], rows["a1"], rows["btb"], X, Y, t, ps, rows["taumin"], rows["tau"])
        got = _launch_burst(*args, **static)
        torch.cuda.synchronize()
        want = _burst_reference(*args, **static)
        for label, g, w in zip(("X", "Y", "t", "ps", "tau", "gap"), got, want):
            require(torch.allclose(g, w, rtol=2e-4, atol=2e-5),
                    f"burst kernel {name}: {label} differs from the twin by "
                    f"{float((g - w).abs().max()):.3e}")
        worst = max(worst, float((got[0] - want[0]).abs().max()))
        # whole solves: certified, and a fixed run (check_every=0). The
        # certified runs use rel_gap_tol=1e-5: at 1e-6 a lane whose f32 gap
        # rounds about the tolerance may certify a burst apart in two engines
        # (tests/test_torch_fista_vmem.py)
        for cfg in (BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-5, **kw),
                    BatchFISTAConfig(max_iter=100, check_every=0, **kw)):
            rk = fista_gram_vmem(gb, cfg)
            torch.cuda.synchronize()
            rt = fista_gram_vmem_reference(gb, cfg)
            dx = float((rk.x - rt.x).abs().max())
            d_it = int((rk.iters.long() - rt.iters.long()).abs().max())
            same = bool(torch.equal(rk.converged, rt.converged))
            print(f"-- burst {name} check_every={cfg.check_every}: max|dx|={dx:.3e} "
                  f"converged_equal={same} max|d_iters|={d_it} "
                  f"certified={int(rk.converged.sum())}/{rk.converged.numel()}")
            if cfg.check_every > 0:
                require(same and d_it <= cfg.check_every,
                        f"burst kernel {name}: certified run differs from the twin")
            elif not cfg.backtracking:  # Armijo is held in the decisive regime below
                require(torch.allclose(rk.x, rt.x, rtol=2e-4, atol=2e-5),
                        f"burst kernel {name}: fixed run differs from the twin")
                worst = max(worst, dx)
    # Armijo only in the decisive regime (tests/test_kernel_armijo.py):
    # noise-free b, α₁ = 0.5, L understated 4×, 5 iterations. From any other
    # state one borderline accept flips between engines and τ never grows
    # back, so the trajectories part (the reference's own chaos)
    g = torch.Generator(device=dev).manual_seed(3)
    Ad = torch.randn((20, 150, 256), generator=g, device=dev)
    xt = torch.zeros((20, 256), device=dev)
    xt[:2] = torch.randn((2, 256), generator=g, device=dev)
    bd = torch.einsum("nmb,nb->mb", Ad, xt).contiguous()
    gd = gram_build.make_gram_batch_fused(Ad, bd, 0.5, 0.0)
    gd = dataclasses.replace(gd, L=gd.L / 4.0)
    for kw in (dict(), dict(adaptive_restart=True), dict(momentum="delta", delta=5.0)):
        cfg = BatchFISTAConfig(max_iter=5, check_every=0, backtracking=True, **kw)
        rk = fista_gram_vmem(gd, cfg)
        torch.cuda.synchronize()
        rt = fista_gram_vmem_reference(gd, cfg)
        dx = float((rk.x - rt.x).abs().max())
        print(f"-- burst armijo decisive {kw}: max|dx|={dx:.3e}")
        require(torch.allclose(rk.x, rt.x, rtol=1e-4, atol=1e-5),
                f"burst kernel armijo {kw}: decisive run differs from the twin")
        worst = max(worst, dx)
    # resume: 40 + 60 through a VmemSolveState equals 100 straight, kernel only
    for kw in (dict(), dict(adaptive_restart=True), dict(momentum="greedy")):
        full = BatchFISTAConfig(max_iter=100, check_every=0, **kw)
        straight = fista_gram_vmem(gbs[0.0], full)
        _, mid = fista_gram_vmem(gbs[0.0], BatchFISTAConfig(max_iter=40, check_every=0, **kw),
                                 return_state=True)
        resumed = fista_gram_vmem(gbs[0.0], full, state0=mid)
        require(bool(torch.equal(resumed.x, straight.x)),
                f"burst kernel resume 40 + 60 is not bit-exact ({kw})")
    print(f"-- burst resume 40 + 60 == 100: bit-exact (nesterov, restart, greedy); "
          f"launches so far {fista_vmem.LAUNCHES}")
    return worst


def check_burst_groups(dev) -> float:
    """The burst kernel at the window's other group sizes (n = 20, every
    mode, is ``check_bursts``): one burst per mode, fixed Nesterov and
    adaptive restart, at B = 301 (a ragged last CTA at every group size),
    held as :func:`burst_vs_twin` holds it. Returns the largest |dX|."""
    from fastoptsolver_tpu_torch.kernels import _build, fista_vmem

    lib = _build.library()
    worst, groups = 0.0, {}
    for n in BURST_WIDTHS:
        groups[n] = (lib.fista_burst_group(n), lib.fista_burst_smem_bytes(n))
        gb = random_gram(n, 301, 0.0, seed=70 + n, dev=dev)
        for name in ("nesterov", "restart"):
            worst = max(worst, burst_vs_twin(
                fista_vmem._launch_burst, fista_vmem._burst_reference, gb,
                WIDE_MODES[name][0], f"burst n={n} (group {groups[n][0]}) {name}"))
    print(f"-- burst (lanes a CTA, shared bytes) by n: {groups}; one burst per mode matches, "
          f"max|dX| {worst:.3e}")
    return worst


def wide_gram(n: int, B: int, a2: float, seed: int, dev, decisive: bool = False):
    """A GramBatch past the build kernels' window, by the torch precompute on
    the card: ``small_problem``'s AR(1) instances, or with ``decisive`` the
    Armijo regime (noise-free b, α₁ = 0.5, L understated 4×)."""
    import dataclasses

    import torch

    from fastoptsolver_tpu_torch.batch.fista_gram import make_gram_batch

    if decisive:
        g = torch.Generator(device=dev).manual_seed(seed)
        A = torch.randn((n, 2 * n, B), generator=g, device=dev)
        xt = torch.zeros((n, B), device=dev)
        xt[:2] = torch.randn((2, B), generator=g, device=dev)
        b = torch.einsum("nmb,nb->mb", A, xt)
        a1 = torch.full((B,), 0.5, device=dev)
    else:
        A, b, a1 = small_problem(n, 2 * n, B, seed=seed, device=dev)
    gb = make_gram_batch(A.permute(2, 1, 0), b.T, a1, a2)
    return dataclasses.replace(gb, Q=gb.Q.contiguous(), c=gb.c.contiguous(),
                               L=gb.L / (4.0 if decisive else 1.0))


WIDE_MODES = {"nesterov": (dict(), 0.0), "delta_ridge": (dict(momentum="delta"), 0.3),
              "restart": (dict(adaptive_restart=True), 0.0),
              "greedy": (dict(momentum="greedy"), 0.0)}


def compare_certified(rk, rt, label: str, check_every: int = 25,
                      hold_iters: bool = True) -> float:
    """A certified run (rel_gap_tol 1e-5) of a kernel against its twin:
    ``converged`` identical, x to rtol 2e-4/atol 2e-5, and ``iters`` within a
    burst (reported only, with the lanes more than a burst apart, when not
    ``hold_iters``). Returns max|dx|."""
    import torch

    dx = float((rk.x - rt.x).abs().max())
    d_its = (rk.iters.long() - rt.iters.long()).abs()
    d_it = int(d_its.max())
    same = bool(torch.equal(rk.converged, rt.converged))
    print(f"-- {label}: max|dx|={dx:.3e} converged_equal={same} max|d_iters|={d_it} "
          f"(lanes more than a burst apart {int((d_its > check_every).sum())}"
          f"{'' if hold_iters else ', reported'}) "
          f"certified={int(rk.converged.sum())}/{rk.converged.numel()}")
    require(same and (d_it <= check_every or not hold_iters)
            and bool(torch.allclose(rk.x, rt.x, rtol=2e-4, atol=2e-5)),
            f"{label}: the kernel disagrees with its twin")
    return dx


def compare_full_width(rk, rt, label: str) -> float:
    """A kernel against its twin on a path's own Grams (rel_gap_tol 1e-6):
    some lanes certify on both sides and x agrees there to rtol 2e-4/atol
    2e-5; where one side alone certifies, both gaps are within 1e-5 (the f32
    floor: the gap's last bits decide). ``iters`` on the lanes both certify
    is reported. Returns max|dx| on those lanes."""
    import torch

    both = rk.converged & rt.converged
    split = rk.converged ^ rt.converged
    split_gap = float(torch.maximum(rk.rel_gap, rt.rel_gap)[split].max()) if bool(
        split.any()) else 0.0
    dx = float((rk.x - rt.x)[both].abs().max()) if bool(both.any()) else float("inf")
    d_it = (rk.iters.long() - rt.iters.long())[both].abs()
    print(f"-- {label}, kernel vs twin: certified {int(rk.converged.sum())} vs "
          f"{int(rt.converged.sum())}, max|dx| on lanes both certified {dx:.3e}, max|d_iters| "
          f"there {int(d_it.max()) if d_it.numel() else 0} (lanes apart by more than a burst "
          f"{int((d_it > 25).sum())}), lanes certified by one only {int(split.sum())} "
          f"(max gap there {split_gap:.3e})")
    require(bool(both.any())
            and bool(torch.allclose(rk.x[both], rt.x[both], rtol=2e-4, atol=2e-5))
            and split_gap <= 1e-5,
            f"{label}: the kernel and its twin disagree")
    return dx


def check_resident(dev):
    """The resident kernel against its twin at the kernel's grouping, n in
    ``RESIDENT_WIDTHS``, every mode with L estimated in-kernel, Armijo decisive;
    a 40 + 60 resume bit-exact; the adaptive entry at n = 96, also timed.
    Returns the largest |dx| and the adaptive entry's times and bounds."""
    import dataclasses

    import torch

    from fastoptsolver_tpu_torch.batch import BatchFISTAConfig
    from fastoptsolver_tpu_torch.kernels import fista_vmem, gram_build, resident

    worst = 0.0
    groups = {n: resident.kernel_group(n, dev) for n in range(1, resident.MAX_N + 1)}
    off = {n: g for n, g in groups.items() if g != resident.group_lanes(n)}
    print(f"-- resident grouping from the card at n = {RESIDENT_WIDTHS}: "
          f"{[groups[n] for n in RESIDENT_WIDTHS]}")
    require(not off, f"the library groups other lanes than group_lanes at {off}")
    for n in RESIDENT_WIDTHS:
        for name, (kw, a2) in {**WIDE_MODES, "armijo": (dict(backtracking=True), 0.0)}.items():
            armijo = name == "armijo"
            gb = wide_gram(n, 300, a2, seed=30 + n, dev=dev, decisive=armijo)
            if armijo:
                cfg, est = BatchFISTAConfig(max_iter=5, check_every=5, **kw), None
            else:
                cfg, est = BatchFISTAConfig(max_iter=1000, check_every=25,
                                            rel_gap_tol=1e-5, **kw), 96
            rk, sk = resident.fista_gram_resident(gb, cfg, est_l_iters=est, return_state=True)
            torch.cuda.synchronize()
            rt, st = resident.fista_gram_resident_reference(gb, cfg, est_l_iters=est,
                                                            return_state=True)
            label = f"resident n={n} {name} (group {resident.group_lanes(n)})"
            held = n in RESIDENT_HELD
            if armijo:
                dx = float((rk.x - rt.x).abs().max())
                close = torch.isclose(rk.x, rt.x, rtol=1e-4, atol=1e-5).all(1)
                flipped = (sk.tau != st.tau)[0]
                print(f"-- {label} decisive: max|dx|={dx:.3e}, lanes whose step τ differs "
                      f"{int(flipped.sum())}{'' if held else ' (x held on the others)'}")
                require(bool(close.all()) if held else
                        bool((close | flipped).all()) and int(flipped.sum()) <= 0.01 * 300,
                        f"{label}: the kernel disagrees with its twin")
            else:
                dx = compare_certified(rk, rt, label, hold_iters=held)
            worst = max(worst, dx)
            full = BatchFISTAConfig(max_iter=100, check_every=20, rel_gap_tol=1e-12, **kw)
            straight = resident.fista_gram_resident(gb, full, est_l_iters=est)
            _, mid = resident.fista_gram_resident(
                gb, dataclasses.replace(full, max_iter=40), est_l_iters=est,
                return_state=True)
            resumed = resident.fista_gram_resident(gb, full, est_l_iters=est, state0=mid)
            require(bool(torch.equal(resumed.x, straight.x)),
                    f"{label}: resume 40 + 60 is not bit-exact")
    # a Gram that is not bit-symmetric: kernel and twin read its upper triangle
    gb = wide_gram(128, 300, 0.0, seed=45, dev=dev)
    g = torch.Generator(device=dev).manual_seed(46)
    Q = (gb.Q * (1.0 + 1e-3 * torch.rand(gb.Q.shape, generator=g, device=dev))).contiguous()
    require(not bool(torch.equal(Q, Q.transpose(0, 1))), "the perturbed Gram is symmetric")
    gb = dataclasses.replace(gb, Q=Q)
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-5)
    rk = resident.fista_gram_resident(gb, cfg, est_l_iters=96)
    torch.cuda.synchronize()
    rt = resident.fista_gram_resident_reference(gb, cfg, est_l_iters=96)
    worst = max(worst, compare_certified(rk, rt, "resident n=128 asymmetric Gram"))
    n, B = 96, 300
    A, b, a1 = small_problem(n, 2 * n, B, seed=41, device=dev)
    gb = gram_build.make_gram_batch_fused(A, b, a1, 0.0)
    adaptive = {}
    for name in ("restart", "greedy"):
        cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-5,
                               **WIDE_MODES[name][0])
        rk = fista_vmem.fista_gram_vmem_adaptive(gb, cfg)
        torch.cuda.synchronize()
        rt = resident.fista_gram_resident_reference(gb, cfg)
        worst = max(worst, compare_certified(rk, rt, f"adaptive entry n=96 {name}"))
        # its own time and bound: Q, c and the rows read once, x and the state
        # written; each group of the kernel's lanes runs to its last lane's iters
        ms, trials, _ = med_ms(lambda: fista_vmem.fista_gram_vmem_adaptive(gb, cfg), 5)
        bnd = bound(4 * (n * n * B + n * B + 6 * B + 2 * n * B + 7 * B),
                    solve_ops(n, group_steps(rk.iters, resident.kernel_group(n, dev)),
                              cfg.check_every))
        adaptive[name] = dict(ms=ms, bound_ms=bnd[0], bound_by=bnd[1], lanes=B)
        print(f"-- adaptive entry n={n} B={B} {name}: {ms:.3f} ms (median of 5, trials "
              f"{[round(x, 3) for x in trials]}), bound {bnd[0]:.4f} ms by {bnd[1]}")
    print(f"-- resident resume 40 + 60 == 100: bit-exact (every mode, n = {RESIDENT_WIDTHS}); "
          f"launches so far {resident.LAUNCHES}")
    return worst, adaptive


def check_power(dev) -> float:
    """``gram_power`` alone against the twin's power iteration on the same
    Gram and c (the kernel's own ``gram_pairs`` output, so only the norm's
    summation order separates them): λ to 1e-5 relative at n in
    ``POWER_WIDTHS``, B = 301 (a ragged last CTA); and the C exports
    ``gram_power_group``/``gram_power_smem_bytes`` equal to their Python
    mirrors for n = 1..128. Returns the largest relative |dλ|."""
    import torch

    from fastoptsolver_tpu_torch.kernels import _build, gram_build
    from fastoptsolver_tpu_torch.kernels._common import make_matvec, power_lambda_max

    lib = _build.library()
    exports = {n: (lib.gram_power_group(n), lib.gram_power_smem_bytes(n))
               for n in range(1, gram_build.POWER_MAX_N + 1)}
    off = {n: e for n, e in exports.items()
           if e != (gram_build.power_group_lanes(n), gram_build._power_smem_bytes(n))}
    require(not off, f"gram_power's C exports differ from their mirrors at {off}")
    worst = 0.0
    for n in POWER_WIDTHS:
        A, b = small_problem(n, max(2 * n, 16), 301, seed=50 + n, device=dev)[:2]
        Q, c, _, _ = gram_build._launch(A, b, 0)
        pl_iters = 32 if n <= 7 else 96
        lam = gram_build._launch_power(Q, c, pl_iters)
        torch.cuda.synchronize()
        want = power_lambda_max(make_matvec(Q, n), c, pl_iters)[0]
        rel = float(((lam - want).abs() / want.abs().clamp_min(1e-30)).max())
        worst = max(worst, rel)
        require(bool(torch.isfinite(lam).all()) and rel <= 1e-5,
                f"gram_power n={n}: max rel|dlam| {rel:.3e} against its twin")
    print(f"-- gram_power (lanes a CTA, shared bytes) by n: "
          f"{ {n: exports[n] for n in POWER_WIDTHS} }; λ against the twin on the same "
          f"Gram, B = 301: max rel|dlam| {worst:.3e}")
    return worst


def burst_vs_twin(launch, twin, gb, kw, label: str) -> float:
    """One burst of 25 from a non-trivial state, with the gap, of a burst
    kernel (``launch``) against its twin: every output to rtol 2e-4/atol
    2e-5. Returns max|dX|."""
    import torch

    from fastoptsolver_tpu_torch.batch import BatchFISTAConfig
    from fastoptsolver_tpu_torch.kernels import fista_vmem

    dev = gb.c.device
    cfg = BatchFISTAConfig(max_iter=100, check_every=25, **kw)
    rows, X, Y, t, ps = burst_inputs(gb, cfg)
    static = dict(n_steps=25, with_gap=True,
                  restart_threshold=cfg.restart_threshold if cfg.adaptive_restart else None,
                  greedy=(cfg.greedy_S, cfg.greedy_shrink) if cfg.momentum == "greedy" else None)
    args = (fista_vmem._beta_table(100, cfg).to(dev), 25, gb.Q, gb.c, rows["tau"],
            rows["thr"], rows["a2"], rows["a1"], rows["btb"], X, Y, t, ps,
            rows["taumin"], rows["tau"])
    got = launch(*args, **static)
    torch.cuda.synchronize()
    want = twin(*args, **static)
    for name, g, w in zip(("X", "Y", "t", "ps", "tau", "gap"), got, want):
        require(torch.allclose(g, w, rtol=2e-4, atol=2e-5),
                f"{label}: {name} differs from the twin by {float((g - w).abs().max()):.3e}")
    return float((got[0] - want[0]).abs().max())


def random_gram(n: int, B: int, a2: float, seed: int, dev):
    """A GramBatch of i.i.d. Gaussian instances (m = 2n, α₁ a tenth of
    ‖Aᵀb‖∞) made on the card, for widths where numpy would be slow."""
    import torch

    from fastoptsolver_tpu_torch.batch.fista_gram import make_gram_batch

    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((B, 2 * n, n), generator=g, device=dev)
    b = torch.randn((B, 2 * n), generator=g, device=dev)
    a1 = 0.1 * torch.einsum("bmn,bm->bn", A, b).abs().amax(1)
    gb = make_gram_batch(A, b, a1, a2)
    return type(gb)(*(v.contiguous() for v in (gb.Q, gb.c, gb.btb, gb.alpha1,
                                                gb.alpha2, gb.L)))


def check_qstream(dev) -> float:
    """The Q-streaming engine against its twin at n ∈ {200, 256}: one burst
    per mode, a certified run, a 40 + 60 resume bit-exact; then one burst per
    mode at n ∈ {120, 400, 600, 900} and a fixed ``check_every=0`` run at
    n = 120. Every burst runs on the route ``qstream_burst`` takes (the
    cluster kernel at n ≤ 660, each cluster size the rule reaches, and the
    streaming kernel at n = 900), and in the cluster window it must equal the
    streaming kernel forced at the same n bit for bit; both routes must run.
    Returns the largest |dx|."""
    import dataclasses

    import torch

    from fastoptsolver_tpu_torch.batch import BatchFISTAConfig
    from fastoptsolver_tpu_torch.kernels import _build, fista_vmem, qstream, resident

    lib = _build.library()

    def against_streaming(*args, **kw):
        got = qstream._launch_qstream(*args, **kw)
        streamed = qstream._launch_qstream(*args, cluster=0, **kw)
        torch.cuda.synchronize()
        require(all(torch.equal(g, s) for g, s in zip(got, streamed)),
                f"qstream n={args[3].shape[0]}: the cluster kernel's bits differ from the "
                "streaming kernel's")
        return got

    worst, routes = 0.0, {}
    for n in (200, 256, 120, 400, 600, 900):
        C = qstream.cluster_size(n)
        routes[n] = (C, lib.qstream_smem_bytes(n, C),
                     lib.qstream_active_clusters(n, C) if C else None)
        for name, (kw, a2) in WIDE_MODES.items():
            gb = (wide_gram(n, 300, a2, seed=50 + n, dev=dev) if n in (200, 256)
                  else random_gram(n, 100, a2, seed=60 + n, dev=dev))
            worst = max(worst, burst_vs_twin(
                against_streaming, qstream._qstream_burst_reference, gb, kw,
                f"qstream n={n} (cluster {C}) {name}"))
            if n not in (200, 256):
                continue
            cert = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-5, **kw)
            rk = fista_vmem.fista_gram_vmem(gb, cert)
            torch.cuda.synchronize()
            rt = fista_vmem.fista_gram_vmem_reference(gb, cert)
            worst = max(worst, compare_certified(rk, rt, f"qstream n={n} {name}"))
            full = BatchFISTAConfig(max_iter=100, check_every=0, **kw)
            straight = fista_vmem.fista_gram_vmem(gb, full)
            _, mid = fista_vmem.fista_gram_vmem(gb, dataclasses.replace(full, max_iter=40),
                                                return_state=True)
            require(bool(torch.equal(fista_vmem.fista_gram_vmem(gb, full, state0=mid).x,
                                     straight.x)),
                    f"qstream n={n} {name}: resume 40 + 60 is not bit-exact")
        if n == 120:  # check_every=0 in the resident window takes this engine
            fixed = BatchFISTAConfig(max_iter=100, check_every=0)
            before = (qstream.LAUNCHES, resident.LAUNCHES)
            rk = fista_vmem.fista_gram_vmem(gb, fixed)
            torch.cuda.synchronize()
            launched = (qstream.LAUNCHES - before[0], resident.LAUNCHES - before[1])
            rt = fista_vmem.fista_gram_vmem_reference(gb, fixed)
            dx = float((rk.x - rt.x).abs().max())
            print(f"-- qstream n=120 check_every=0 nesterov: launches (qstream, resident) "
                  f"{launched}, max|dx|={dx:.3e}")
            require(launched[0] > 0 and launched[1] == 0
                    and bool(torch.allclose(rk.x, rt.x, rtol=2e-4, atol=2e-5)),
                    "qstream n=120 check_every=0: not the qstream kernel, or off its twin")
            worst = max(worst, dx)
    sizes = {C for C, _, _ in routes.values()}
    require(0 in sizes and len(sizes) > 1,
            f"phase 3 reaches the qstream routes {sorted(sizes)}: not both the cluster and "
            "the streaming kernel")
    require(all(a is None or a > 0 for _, _, a in routes.values()),
            f"a cluster size the card holds no cluster of: {routes}")
    print(f"-- qstream (cluster size, shared bytes a CTA, active clusters) by n: {routes}; "
          f"every burst equals the streaming kernel's bits in the cluster window")
    print(f"-- qstream resume 40 + 60 == 100: bit-exact (every mode, n = 200 and 256); "
          f"bursts at n = 120, 400, 600, 900 match; launches so far {qstream.LAUNCHES}")
    return worst


def check_wide(res, A, b, a1, share: float, label: str) -> dict:
    """The wide cells' checks on a routed result: x finite of shape (B, n),
    no lane failed, every certified lane at ≤ 1e-6, every lane ≤ 1e-5, at
    least ``share`` certified (the f32 floor: PERF.md §6), and a float64
    recheck of 4096 sampled lanes ≤ 1e-4."""
    import torch

    from fastoptsolver_tpu_torch.batch.fista_gram import _rel_gap, make_gram_batch

    n, _, B = A.shape
    dev = A.device
    n_conv, n_failed = int(res.converged.sum()), int(res.failed.sum())
    max_gap = float(res.rel_gap.max())
    gap_ok = float(res.rel_gap[res.converged].max()) if n_conv else float("inf")
    require(res.x.shape == (B, n) and bool(torch.isfinite(res.x).all()),
            f"{label}: x is not finite of shape (B, n)")
    require(n_conv >= share * B and n_failed == 0 and gap_ok <= 1e-6 and max_gap <= 1e-5,
            f"{label}: {n_conv}/{B} certified, {n_failed} failed, max rel_gap "
            f"{max_gap:.3e} ({gap_ok:.3e} on certified lanes)")
    idx = torch.randperm(B, generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)[:4096]
    gb64 = make_gram_batch(A[:, :, idx].double().permute(2, 1, 0), b[:, idx].double().T,
                           a1[idx].double(), 0.0,
                           L=torch.ones(idx.numel(), dtype=torch.float64, device=dev))
    gap64 = float(_rel_gap(gb64, res.x[idx].double().T).max())
    require(gap64 <= 1e-4, f"{label} float64 recheck: max rel_gap {gap64:.3e} > 1e-4")
    it = res.iters.float()
    return dict(certified=n_conv, failed=n_failed, max_gap=max_gap, gap_ok=gap_ok,
                gap64=gap64, iters_median=int(it.median()), iters_max=int(it.max()))


def med_ms(fn, trials: int = 3):
    """(median ms of ``trials`` timed calls after a warm one, the trials, the
    last result)."""
    fn()
    runs = [cuda_ms(fn) for _ in range(trials)]
    ms = [r[0] for r in runs]
    return median(ms), ms, runs[-1][1]


def lanes(gb, B: int):
    """The first ``B`` lanes of a GramBatch, contiguous."""
    from fastoptsolver_tpu_torch.batch.fista_gram import GramBatch

    return GramBatch(*(v[..., :B].contiguous() for v in (gb.Q, gb.c, gb.btb, gb.alpha1,
                                                         gb.alpha2, gb.L)))


def zero_counts(mods) -> None:
    for mod in mods.values():
        mod.LAUNCHES = 0


def resident_path(dev, cfg, mods) -> dict:
    """Phase 7: W1 through solve_lasso_batch, counted, checked, then timed."""
    import torch

    from fastoptsolver_tpu_torch.batch import solve_gram_batch, solve_lasso_batch
    from fastoptsolver_tpu_torch.batch.fista_gram import (
        _batched_power_L, fista_gram_batch, make_gram_batch)
    from fastoptsolver_tpu_torch.bench.wide_n import build_problems
    from fastoptsolver_tpu_torch.kernels import resident

    n, B = W1_N, W1_B
    A, b, a1 = build_problems(torch.Generator(device=dev).manual_seed(0), B, 2 * n, n)
    torch.cuda.synchronize()
    zero_counts(mods)
    res = solve_lasso_batch(A, b, a1, 0.0, cfg=cfg, feature_major=True)
    torch.cuda.synchronize()
    counts = {k: m.LAUNCHES for k, m in mods.items()}
    require(counts == dict(counts, resident=1) and sum(counts.values()) == 1,
            f"resident path: launches {counts} (want resident 1, every other 0)")
    chk = check_wide(res, A, b, a1, 0.80, "resident path")
    # Q read once, c and the rows; 96 power steps, then each group of the
    # kernel's lanes runs to its last lane's iters
    group = resident.kernel_group(n, dev)
    steps = group_steps(res.iters, group)
    bnd = bound(4 * (n * n * B + n * B + 6 * B + 2 * n * B + 7 * B),
                B * 96 * (2 * n * n + 3 * n) + solve_ops(n, steps, cfg.check_every))
    # lane-matvecs, each reading the lane's n² words of Q from shared memory:
    # 96 power steps, one a step, one a gap
    lane_mv = 96 * B + steps + steps // cfg.check_every
    gb = make_gram_batch(A.permute(2, 1, 0), b.T, a1, 0.0, estimate_l=False)
    res_g = solve_gram_batch(gb, cfg, est_l_iters=96)
    require(bool(torch.equal(res_g.x, res.x)), "solve_gram_batch(est_l_iters=96) on the "
            "estimate_l=False Gram gives another x than solve_lasso_batch")
    print(f"[7 resident path] n={n} m={2 * n} B={B}: launches {counts} | certified "
          f"{chk['certified']}/{B}, failed {chk['failed']}, max rel_gap {chk['max_gap']:.3e} "
          f"({chk['gap_ok']:.3e} on certified lanes), f64 recheck max rel_gap "
          f"{chk['gap64']:.3e} on 4096 lanes | solve_gram_batch x equal | iters median "
          f"{chk['iters_median']} max {chk['iters_max']}")
    del res, res_g
    routed_ms, routed_trials, _ = med_ms(lambda: solve_lasso_batch(A, b, a1, 0.0, cfg=cfg,
                                                                   feature_major=True))
    del A, b
    torch.cuda.empty_cache()
    gb = type(gb)(*(v.contiguous() for v in (gb.Q, gb.c, gb.btb, gb.alpha1, gb.alpha2, gb.L)))
    kernel_ms, kernel_trials, _ = med_ms(lambda: resident.fista_gram_resident(
        gb, cfg, est_l_iters=96))
    from fastoptsolver_tpu_torch.batch import BatchFISTAConfig

    one = BatchFISTAConfig(max_iter=1, check_every=1)
    copy_ms, _, _ = med_ms(lambda: resident.fista_gram_resident(gb, one))
    # the same launch after 96 power steps, and 1000 steps in every group (no
    # lane certifies at tol 0): the time of a power step and of a step
    power_ms, _, _ = med_ms(lambda: resident.fista_gram_resident(gb, one, est_l_iters=96))
    all_steps = BatchFISTAConfig(max_iter=cfg.max_iter, check_every=cfg.check_every,
                                 rel_gap_tol=0.0)
    steps_ms, _, _ = med_ms(lambda: resident.fista_gram_resident(gb, all_steps,
                                                                 est_l_iters=96))
    small = lanes(gb, 3840)
    k_small_ms, _, rk = med_ms(lambda: resident.fista_gram_resident(small, cfg, est_l_iters=96))
    plain_ms, _, rt = med_ms(lambda: resident.fista_gram_resident_reference(
        small, cfg, est_l_iters=96))
    dx = compare_full_width(rk, rt, "resident path, the first 3840 lanes")
    gen = torch.Generator(device=dev).manual_seed(0)
    v0 = torch.randn((n, B), generator=gen, device=dev)
    gbL = type(gb)(gb.Q, gb.c, gb.btb, gb.alpha1, gb.alpha2,
                   _batched_power_L(gb.Q, v0, 100, 1e-6) + gb.alpha2)
    driver_ms, _, res_d = med_ms(lambda: fista_gram_batch(gbL, cfg))
    print(f"[7 times] routed solve_lasso_batch {routed_ms:.3f} ms ({chk['certified'] / routed_ms * 1e3:.4g} "
          f"certified instances/s) | resident kernel solve {kernel_ms:.3f} ms (one launch; "
          f"a one-step launch, the Gram's copy-in and 2 matvecs, {copy_ms:.3f} ms = "
          f"{100.0 * copy_ms / kernel_ms:.1f}%) | on 3840 lanes kernel {k_small_ms:.3f} ms vs "
          f"twin {plain_ms:.3f} ms | torch driver on the same Gram {driver_ms:.3f} ms "
          f"(certified {int(res_d.converged.sum())}/{B}) | trials routed "
          f"{[round(x, 3) for x in routed_trials]} kernel {[round(x, 3) for x in kernel_trials]}")
    smem_read = lane_mv * n * n * 4
    smem_gbps = smem_read / kernel_ms / 1e6
    floor_ms = smem_floor_ms(smem_read)
    smem_bytes = group * resident._smem_per_lane(n)
    # a CTA-step: one step (or power step) of a CTA's lanes, the waves of CTAs
    # one an SM running in turn
    ctas = -(-B // group)
    waves = -(-ctas // torch.cuda.get_device_properties(0).multi_processor_count)
    steps_all = cfg.max_iter + cfg.max_iter // cfg.check_every + 96
    cta_step_us = steps_ms / (waves * steps_all) * 1e3
    power_step_us = (power_ms - copy_ms) / 96 / waves * 1e3
    print(f"-- resident bound {bnd[0]:.3f} ms by {bnd[1]}; {group} lanes a CTA, {smem_bytes} "
          f"bytes of shared memory; {lane_mv} lane-matvecs read {smem_read / 1e12:.3f} TB of Q "
          f"from shared memory at {smem_gbps:.1f} GB/s (the shared-memory floor "
          f"{floor_ms:.3f} ms) | splits (medians of 3): the one-step launch after 96 power "
          f"steps {power_ms:.3f} ms, so {power_step_us:.3f} us a power step a CTA over "
          f"{waves} waves; {cfg.max_iter} steps in every group {steps_ms:.3f} ms, "
          f"{cta_step_us:.3f} us a CTA-step ({B * steps_all * n * n * 4 / steps_ms / 1e6:.1f} "
          f"GB/s of Q from shared memory)")
    return dict(launches=counts["resident"], ms=kernel_ms, plain_ms=plain_ms,
                group_lanes=group, smem_bytes=smem_bytes, smem_read_gbps=smem_gbps,
                lane_matvecs=lane_mv, smem_floor_ms=floor_ms, power_launch_ms=power_ms,
                all_steps_ms=steps_ms, cta_step_us=cta_step_us,
                bound_ms=bnd[0], bound_by=bnd[1],
                plain_lanes=3840, ms_at_plain_lanes=k_small_ms, e2e_ms=routed_ms,
                driver_ms=driver_ms, copy_in_ms=copy_ms, dx_small=dx)


def qstream_path(dev, cfg, mods) -> dict:
    """Phase 8: W2 through solve_lasso_batch, counted, checked, then timed."""
    import torch

    from fastoptsolver_tpu_torch.batch import solve_gram_batch, solve_lasso_batch
    from fastoptsolver_tpu_torch.batch.fista_gram import fista_gram_batch, make_gram_batch
    from fastoptsolver_tpu_torch.bench.wide_n import build_problems
    from fastoptsolver_tpu_torch.kernels import _build, fista_vmem, qstream

    n, B = W2_N, W2_B
    A, b, a1 = build_problems(torch.Generator(device=dev).manual_seed(0), B, 2 * n, n)
    torch.cuda.synchronize()
    zero_counts(mods)
    res = solve_lasso_batch(A, b, a1, 0.0, cfg=cfg, feature_major=True)
    torch.cuda.synchronize()
    counts = {k: m.LAUNCHES for k, m in mods.items()}
    bursts = int(res.n_iters_total) // cfg.check_every
    require(counts == dict(counts, qstream=bursts) and sum(counts.values()) == bursts,
            f"qstream path: launches {counts} (want qstream {bursts} = bursts, every other 0)")
    chk = check_wide(res, A, b, a1, 0.75, "qstream path")
    # Q read once, c and the rows; every lane runs every burst
    bnd = bound(4 * (n * n * B + n * B + 6 * B + 2 * n * B + 4 * B),
                solve_ops(n, B * int(res.n_iters_total), cfg.check_every))
    gb = make_gram_batch(A.permute(2, 1, 0), b.T, a1, 0.0)
    res_g = solve_gram_batch(gb, cfg)
    require(bool(torch.equal(res_g.x, res.x)),
            "solve_gram_batch on the built Gram gives another x than solve_lasso_batch")
    print(f"[8 qstream path] n={n} m={2 * n} B={B}: launches {counts} = bursts {bursts} | "
          f"certified {chk['certified']}/{B}, failed {chk['failed']}, max rel_gap "
          f"{chk['max_gap']:.3e} ({chk['gap_ok']:.3e} on certified lanes), f64 recheck max "
          f"rel_gap {chk['gap64']:.3e} on 4096 lanes | solve_gram_batch x equal | iters "
          f"median {chk['iters_median']} max {chk['iters_max']}")
    del res, res_g
    routed_ms, routed_trials, _ = med_ms(lambda: solve_lasso_batch(A, b, a1, 0.0, cfg=cfg,
                                                                   feature_major=True))
    del A, b
    torch.cuda.empty_cache()
    gb = type(gb)(*(v.contiguous() for v in (gb.Q, gb.c, gb.btb, gb.alpha1, gb.alpha2, gb.L)))
    kernel_ms, kernel_trials, rk_full = med_ms(lambda: fista_vmem.fista_gram_vmem(gb, cfg))
    q_gb = gb.Q.numel() * 4 / 1e9
    read_ms, _, _ = med_ms(lambda: gb.Q.sum())
    small = lanes(gb, 1920)
    k_small_ms, _, rk = med_ms(lambda: fista_vmem.fista_gram_vmem(small, cfg))
    plain_ms, _, rt = med_ms(lambda: fista_vmem.fista_gram_vmem_reference(small, cfg))
    dx = compare_full_width(rk, rt, "qstream path, the first 1920 lanes")
    del rk, rt, small
    driver_ms, _, res_d = med_ms(lambda: fista_gram_batch(gb, cfg))
    del res_d
    print(f"[8 times] routed solve_lasso_batch {routed_ms:.3f} ms ({chk['certified'] / routed_ms * 1e3:.4g} "
          f"certified instances/s) | qstream solve {kernel_ms:.3f} ms ({bursts} launches and "
          f"the re-layout) | on 1920 lanes kernel {k_small_ms:.3f} ms vs twin {plain_ms:.3f} ms "
          f"| torch driver on the same Gram {driver_ms:.3f} ms | trials routed "
          f"{[round(x, 3) for x in routed_trials]} kernel {[round(x, 3) for x in kernel_trials]}")
    print(f"-- qstream bound {bnd[0]:.3f} ms by {bnd[1]}")

    # the engine's parts: the re-layout, the launches back to back on one re-laid
    # copy, a launch with no step and no gap (the copy-in), each cluster size, and
    # old (the streaming kernel, forced) against new in turns
    lib = _build.library()
    C = qstream.cluster_size(n)
    smem, active = lib.qstream_smem_bytes(n, C), lib.qstream_active_clusters(n, C)
    relayout_ms, relayout_trials, Qt = med_ms(lambda: qstream.relayout(gb.Q, C), 5)
    rows, X0, Y0, _, _ = burst_inputs(gb, cfg)
    one = torch.ones_like(rows["tau"])
    betas = fista_vmem._beta_table(bursts * cfg.check_every, cfg).to(dev)
    with_rows = lambda X, Y, k: (betas, k, gb.Q, gb.c, rows["tau"], rows["thr"], rows["a2"],
                                 rows["a1"], rows["btb"], X, Y, one, 0 * one, None, rows["tau"])

    def bursts_only(**kw):
        X, Y = X0, Y0
        for i in range(bursts):
            X, Y, *_ = qstream._launch_qstream(*with_rows(X, Y, i * cfg.check_every),
                                               n_steps=cfg.check_every, with_gap=True, **kw)
        return X, Y

    new, streamed = bursts_only(Qt=Qt), bursts_only(cluster=0)
    torch.cuda.synchronize()
    require(torch.equal(new[0], streamed[0]) and torch.equal(new[1], streamed[1]),
            f"qstream path: {bursts} bursts of the cluster kernel differ from the streaming "
            "kernel's bits")
    del new, streamed
    ab = [med_ms(lambda kw=kw: bursts_only(**kw), 1)[0]
          for kw in (dict(cluster=0), dict(Qt=Qt), dict(Qt=Qt), dict(cluster=0))]
    launches_ms, launches_trials, _ = med_ms(lambda: bursts_only(Qt=Qt), 5)
    copy_ms, copy_trials, _ = med_ms(lambda: qstream._launch_qstream(
        *with_rows(X0, Y0, 0), n_steps=0, Qt=Qt), 5)
    q_bytes = Qt.numel() * 4
    del Qt
    torch.cuda.empty_cache()
    by_size, size_fit = {}, {}
    for size in (2, 4, 8):
        Qs = qstream.relayout(gb.Q, size)
        by_size[size] = med_ms(lambda: bursts_only(Qt=Qs, cluster=size), 3)[0]
        size_fit[size] = (lib.qstream_smem_bytes(n, size),
                          lib.qstream_active_clusters(n, size))
        del Qs
        torch.cuda.empty_cache()
    # each launch copies every lane's Q from device memory once; each matvec (one
    # per iteration, one per gap) reads it from shared memory
    matvecs = int(rk_full.n_iters_total) + bursts
    smem_gbps = matvecs * q_gb / launches_ms * 1e3
    smem_gbps_steps = matvecs * q_gb / (launches_ms - bursts * copy_ms) * 1e3
    print(f"-- qstream cluster kernel at n={n}: C = {C} CTAs a lane, {smem} shared bytes a "
          f"CTA, {active} clusters active at once; Q read from device memory once a launch, "
          f"{q_bytes / 1e9:.3f} GB ({bursts * q_bytes / 1e9:.1f} GB a solve); the re-layout "
          f"{relayout_ms:.3f} ms (trials {[round(x, 3) for x in relayout_trials]}); "
          f"{bursts} launches back to back {launches_ms:.3f} ms (trials "
          f"{[round(x, 3) for x in launches_trials]}), so the host loop costs "
          f"{kernel_ms - launches_ms - relayout_ms:.3f} ms; a launch with no step (the "
          f"copy-in) {copy_ms:.3f} ms = {q_bytes / copy_ms / 1e6:.1f} GB/s (a plain Q.sum() "
          f"{q_gb / read_ms * 1e3:.1f} GB/s), {100.0 * bursts * copy_ms / launches_ms:.1f}% of "
          f"the launches; {matvecs} matvecs read Q from shared memory at {smem_gbps:.1f} GB/s "
          f"over the launches, {smem_gbps_steps:.1f} GB/s without the copy-ins")
    print(f"-- qstream {bursts} bursts by cluster size (medians of 3): "
          + ", ".join(f"C={k} {v:.3f} ms ({size_fit[k][0]} shared bytes a CTA, "
                      f"{size_fit[k][1]} clusters active)" for k, v in by_size.items())
          + f" | streaming kernel (old) against the cluster kernel (new) in turns: old "
          f"{ab[0]:.3f}, new {ab[1]:.3f}, new {ab[2]:.3f}, old {ab[3]:.3f} ms; the "
          f"{bursts} bursts bit-identical")
    return dict(launches=counts["qstream"], ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1],
                plain_lanes=1920, ms_at_plain_lanes=k_small_ms, e2e_ms=routed_ms,
                driver_ms=driver_ms, cluster_size=C, smem_bytes=smem,
                active_clusters=active, q_bytes_per_launch=q_bytes, copy_in_ms=copy_ms,
                relayout_ms=relayout_ms, launches_only_ms=launches_ms,
                smem_read_gbps=smem_gbps, q_sum_gbps=q_gb / read_ms * 1e3,
                bursts_ms_by_cluster_size=by_size, streaming_ms=[ab[0], ab[3]],
                cluster_ms=[ab[1], ab[2]], dx_small=dx)


def fused_bound(A, res, cfg, extra_per_step: int = 0):
    """(bound_ms, bound_by) of one fused solve on ``A`` (n, m, B) whose
    result is ``res``: A and b read once, α rows read, x and three rows
    written; the build's pair sums, the power steps and the steps each CTA of
    128 lanes ran (``extra_per_step`` for an Armijo trial)."""
    n, m, B = A.shape
    na = n + 1
    pl_iters = 32 if n <= 7 else 96
    n_bytes = 4 * (n * m * B + m * B + 2 * B + n * B + 3 * B)
    n_ops = B * (2 * m * na * (na + 1) // 2 + pl_iters * (2 * n * n + 3 * n)) + \
        solve_ops(n, group_steps(res.iters, 128), cfg.check_every, extra_per_step)
    return bound(n_bytes, n_ops)


def compare_bench_lanes(A, b, alpha1, rk, rt, label: str, hold: bool) -> float:
    """A kernel against its twin on bench-data lanes. On these correlated
    data f32 rounding moves x by ~5e-4 (phase 3's bench-shape rule), so the
    objective is held where phases 6-8 hold x: within 1e-6 relative on the
    lanes both certify; where one side alone certifies, both gaps ≤ 1e-5.
    With ``hold`` False (Armijo, outside its decisive regime, where one
    flipped accept parts the trajectories) these are reported. The failed
    lanes must be the same. Returns max rel|dobj|."""
    import torch

    both = rk.converged & rt.converged
    split = rk.converged ^ rt.converged
    split_gap = float(torch.maximum(rk.rel_gap, rt.rel_gap)[split].max()) if bool(
        split.any()) else 0.0
    f_k = objective64(A, b, alpha1, rk.x)
    f_t = objective64(A, b, alpha1, rt.x)
    rel = (f_k - f_t).abs() / f_t.clamp_min(1.0)
    dobj = float(rel[both].max()) if bool(both.any()) else 0.0
    print(f"-- {label}, kernel vs twin: certified {int(rk.converged.sum())} vs "
          f"{int(rt.converged.sum())}, max rel|dobj| on lanes both certified {dobj:.3e} "
          f"(on every lane {float(rel.max()):.3e}), max|dx| {float((rk.x - rt.x).abs().max()):.3e}, "
          f"lanes certified by one only {int(split.sum())} (max gap there {split_gap:.3e})")
    require(bool(torch.equal(rk.failed, rt.failed)), f"{label}: other lanes failed")
    if hold:
        require(bool(both.any()) and dobj <= 1e-6 and split_gap <= 1e-5,
                f"{label}: the kernel and its twin disagree")
    return dobj


def fused_modes_path(A, b, alpha1, dev, mods) -> dict:
    """Phase 9: the bench configuration through solve_lasso_batch in each
    mode the fused kernel gained, counted, checked and timed; then a
    checkpointed run (100 iterations, the state, resumed to 1000, in memory
    and through a file) against a straight one. Returns the modes' record
    and the file round trip's."""
    import dataclasses
    import os
    import tempfile

    import torch

    from fastoptsolver_tpu_torch.batch import BatchFISTAConfig, solve_lasso_batch
    from fastoptsolver_tpu_torch.batch.fista_gram import _rel_gap, make_gram_batch
    from fastoptsolver_tpu_torch.kernels import fused_solve
    from fastoptsolver_tpu_torch.utils import restore_pytree, save_pytree

    n, m, B = A.shape
    idx = torch.randperm(B, generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)[:4096]
    gb64 = make_gram_batch(A[:, :, idx].double().permute(2, 1, 0), b[:, idx].double().T,
                           alpha1[idx].double(), 0.0,
                           L=torch.ones(idx.numel(), dtype=torch.float64, device=dev))
    few = slice(0, 3840)
    As, bs, a1s = A[:, :, few].contiguous(), b[:, few].contiguous(), alpha1[few].contiguous()
    out = {}
    for name, kw in FUSED_MODES.items():
        cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6, **kw)
        zero_counts(mods)
        res = solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg, feature_major=True)
        torch.cuda.synchronize()
        counts = {k: mod.LAUNCHES for k, mod in mods.items()}
        require(counts == dict(counts, fused=1) and sum(counts.values()) == 1,
                f"fused modes path {name}: launches {counts} (want fused 1, every other 0)")
        n_conv, n_failed = int(res.converged.sum()), int(res.failed.sum())
        share = n_conv / B
        require(res.x.shape == (B, n) and bool(torch.isfinite(res.x).all()) and n_failed == 0,
                f"fused modes path {name}: x not finite of shape (B, n), or {n_failed} failed")
        if name in REFERENCE_SHARE:
            require(share >= REFERENCE_SHARE[name] - 0.01,
                    f"fused modes path {name}: {100 * share:.2f}% certified, the reference "
                    f"{100 * REFERENCE_SHARE[name]:.2f}%")
        gap64 = _rel_gap(gb64, res.x[idx].double().T)
        conv = res.converged[idx]
        gap64_cert = float(gap64[conv].max()) if bool(conv.any()) else 0.0
        n_off = int((gap64[conv] > 1e-4).sum())
        it = res.iters.float()
        armijo = "backtracking" in kw
        # Armijo's lanes stall far from the optimum (ROADMAP Queue 3), where
        # the f32 gap of a lane with a large bᵀb can pass 1e-6 by rounding:
        # reported, as its share is, not held
        require(armijo or gap64_cert <= 1e-4, f"fused modes path {name}: float64 "
                f"recheck of the certified lanes {gap64_cert:.3e} > 1e-4")
        bound_ms, bound_by = fused_bound(A, res, cfg, extra_per_step=2 * n * n + 12 * n
                                         if armijo else 0)
        print(f"[9 fused modes path] {name}: launches {counts} | certified {n_conv}/{B} "
              f"({100 * share:.2f}%), failed {n_failed}, max rel_gap "
              f"{float(res.rel_gap.max()):.3e}, f64 recheck {gap64_cert:.3e} on the "
              f"{int(conv.sum())} certified of 4096 sampled lanes ({n_off} above 1e-4; all "
              f"4096: {float(gap64.max()):.3e}) | iters median "
              f"{int(it.median())} max {int(it.max())}")
        del res
        k_ms, _, rk = med_ms(lambda: solve_lasso_batch(As, bs, a1s, 0.0, cfg=cfg,
                                                       feature_major=True))
        plain_ms, rt = cuda_ms(lambda: fused_solve.fused_solve_reference(As, bs, a1s, 0.0,
                                                                         cfg=cfg))
        dobj = compare_bench_lanes(As, bs, a1s, rk, rt, f"fused {name}, the first 3840 lanes",
                                   hold=not armijo)
        routed_ms, routed_trials, _ = med_ms(lambda: solve_lasso_batch(
            A, b, alpha1, 0.0, cfg=cfg, feature_major=True))
        plan = fused_solve._plan(A, alpha1, 0.0, cfg, None, 1.02, None)
        kernel_ms, kernel_trials, _ = med_ms(lambda: fused_solve._launch(A, b, **plan))
        del plan
        print(f"[9 times] {name}: routed solve_lasso_batch {routed_ms:.3f} ms "
              f"({n_conv / routed_ms * 1e3:.4g} certified instances/s) | fused kernel alone "
              f"{kernel_ms:.3f} ms (bound {bound_ms:.3f} ms by {bound_by}) | on 3840 lanes "
              f"kernel {k_ms:.3f} ms vs twin {plain_ms:.1f} ms | trials routed "
              f"{[round(x, 3) for x in routed_trials]} kernel "
              f"{[round(x, 3) for x in kernel_trials]}")
        out[name] = dict(launches=counts["fused"], certified_share=share, ms=kernel_ms,
                         e2e_ms=routed_ms, bound_ms=bound_ms, bound_by=bound_by,
                         plain_ms=plain_ms, plain_lanes=3840, ms_at_plain_lanes=k_ms,
                         max_rel_dobj=dobj, f64_certified_max_gap=gap64_cert)
    # a checkpointed run against a straight one, fixed momentum
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)
    zero_counts(mods)
    straight = solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg, feature_major=True)
    _, mid = solve_lasso_batch(A, b, alpha1, 0.0, cfg=dataclasses.replace(cfg, max_iter=100),
                               feature_major=True, return_state=True)
    resumed = solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg, feature_major=True, state0=mid)
    # the same state through a file (phase 14 reports it): restored onto the card
    # in the example's dtypes, then resumed
    with tempfile.TemporaryDirectory() as tmp:
        path = save_pytree(os.path.join(tmp, "fused_state"), mid)
        n_bytes = os.path.getsize(path)
        back = restore_pytree(path, type(mid)(*(torch.zeros_like(v) for v in mid)))
    from_disk = solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg, feature_major=True, state0=back)
    torch.cuda.synchronize()
    counts = {k: mod.LAUNCHES for k, mod in mods.items()}
    fields = ("x", "iters", "rel_gap", "converged")
    same = {f: bool(torch.equal(getattr(resumed, f), getattr(straight, f))) for f in fields}
    same_disk = {f: bool(torch.equal(getattr(from_disk, f), getattr(straight, f)))
                 for f in fields}
    kvals = sorted(set(mid.k.tolist()))
    print(f"[9 resume] 100 + 900 == 1000 straight: {same}; fused launches {counts['fused']}, "
          f"the checkpoint's tiles at k = {kvals}")
    require(all(same.values()) and all(same_disk.values()) and counts == dict(counts, fused=4)
            and sum(counts.values()) == 4, "fused modes path: the resumed run (in memory "
            f"{same}, from disk {same_disk}) is not bit-equal to the straight one, or launched "
            f"{counts}")
    return out, dict(same=same_disk, bytes=n_bytes, launches=counts["fused"])


def cv_problem(dev):
    """Phase 10's data, on the card from seed 0, at the shape of UCI's
    YearPredictionMSD regression (``CV_M`` rows × ``CV_N`` features): A ~ N(0, 1),
    a 10%-sparse x_true with N(0, 9) entries, noise σ = 9."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((CV_M, CV_N), generator=g, device=dev)
    keep = torch.rand((CV_N,), generator=g, device=dev) < 0.1
    x_true = torch.where(keep, 3.0 * torch.randn((CV_N,), generator=g, device=dev), 0.0)
    b = A @ x_true + 9.0 * torch.randn((CV_M,), generator=g, device=dev)
    return A, b


def cv_grid64(A, b, alphas, l1_ratio: float):
    """The CV grid of ``cv_lasso(fit_intercept=True)`` in float64: float64
    fold Grams by ``batch.cv``'s own fold and penalty rules, (k+1)·K lanes,
    group-major, with L = 1 (no solve reads it)."""
    import torch

    from fastoptsolver_tpu_torch.batch import cv

    A64, b64 = A.double(), b.double()
    A64, b64 = A64 - A64.mean(dim=0), b64 - b64.mean()
    folds = cv._folds(A64, b64, CV_FOLDS)
    Q, c, btb = cv._train_grams(A64, b64, folds)
    a1, a2 = cv._penalties(alphas.double(), folds.sizes, CV_M, 0.0, l1_ratio)
    return cv._grid(Q, c, btb, torch.ones_like(btb), a1, a2)


def cv_x(res):
    """A ``cv_lasso`` result's x over its whole grid, (lanes, n), group-major."""
    import torch

    return torch.cat([res.coef_folds, res.coef_path[None]]).reshape(-1, CV_N)


def cv_lanes64(gb, X):
    """Every lane's objective and relative gap on the float64 grid ``gb`` at
    the f32 x ``X`` (lanes, n)."""
    import torch

    from fastoptsolver_tpu_torch.batch.fista_gram import _rel_gap

    X = X.double().T
    QX = torch.einsum("ijb,jb->ib", gb.Q, X)
    f = (0.5 * (X * QX).sum(0) - (gb.c * X).sum(0) + 0.5 * gb.btb
         + 0.5 * gb.alpha2 * (X * X).sum(0) + gb.alpha1 * X.abs().sum(0))
    return f, _rel_gap(gb, X)


def max_rel_dobj(fa, fb, lanes) -> float:
    """max over ``lanes`` of |fa − fb| / max(|fb|, 1)."""
    return float(((fa - fb).abs() / fb.abs().clamp_min(1.0))[lanes].max()) if lanes.any() else 0.0


def max_rel_dx(Xa, Xb, lanes) -> float:
    """max over ``lanes`` of ‖xa − xb‖∞ over the grid's largest |x|. f32
    rounding moves every lane's x by about ε·α_max/λ_min(Q), which on this
    Gram is ε times the grid's largest |x| whatever the lane's own size: a
    lane near α_max holds one small entry, c_i − α₁ by cancellation."""
    d = (Xa - Xb).abs().amax(-1) / Xb.abs().max()
    return float(d[lanes].max()) if lanes.any() else 0.0


def compare_cv(A, b, rk, rx, l1_ratio: float, label: str) -> dict:
    """The kernel route's CV result against the torch driver's on the same
    data: certified counts within 1% of lanes; on lanes both certify, the
    per-lane objective within 1e-5 relative and x within ``CV_X_RTOL``
    (``max_rel_dx``); ``mse_mean`` within 1e-5 relative; the same
    ``best_idx`` unless the two minima tie within that tolerance; and the
    refit lanes' float64 gap ≤ 1e-4."""
    import torch

    lanes_n = rk.converged_grid.numel()
    ck, cx = int(rk.converged_grid.sum()), int(rx.converged_grid.sum())
    require(bool(torch.equal(rk.alphas, rx.alphas)), f"cv {label}: the routes' ladders differ")
    gb64 = cv_grid64(A, b, rk.alphas, l1_ratio)
    fk, gk = cv_lanes64(gb64, cv_x(rk))
    fx, _ = cv_lanes64(gb64, cv_x(rx))
    both = (rk.converged_grid & rx.converged_grid).reshape(-1)
    dobj = max_rel_dobj(fk, fx, both)
    dx = max_rel_dx(cv_x(rk), cv_x(rx), both)
    dmse = float(((rk.mse_mean - rx.mse_mean).abs() / rx.mse_mean).max())
    ik, ix = int(rk.best_idx), int(rx.best_idx)
    # another index is allowed only where the driver's two minima tie
    tied = abs(float(rx.mse_mean[ik] - rx.mse_mean[ix])) <= 1e-5 * float(rx.mse_mean[ix])
    refit_gap64 = float(gk[-rk.alphas.numel():].max())
    print(f"-- cv {label}: certified kernel {ck}/{lanes_n}, driver {cx}/{lanes_n} | on "
          f"{int(both.sum())} lanes both certify: max rel |dobj| {dobj:.3e}, max rel |dx| "
          f"{dx:.3e} (limit {CV_X_RTOL:g}) | max rel |dmse_mean| {dmse:.3e} | best_idx "
          f"kernel {ik} driver {ix} | refit f64 max rel_gap {refit_gap64:.3e} | best alpha "
          f"{float(rk.best_alpha):.6g}, iters max {int(rk.iters.max())}")
    require(abs(ck - cx) <= 0.01 * lanes_n and dobj <= 1e-5 and dx <= CV_X_RTOL
            and dmse <= 1e-5 and (ik == ix or tied) and refit_gap64 <= 1e-4,
            f"cv {label}: the kernel route disagrees with the torch driver")
    return dict(certified=ck, driver_certified=cx, lanes=lanes_n, max_rel_dobj=dobj,
                max_rel_dx=dx, max_rel_dmse=dmse, best_idx=ik, refit_gap64=refit_gap64)


def round_tf32(Q):
    """Q as a TF32 matmul reads it: a 10-bit mantissa, rounded to nearest."""
    import torch

    return ((Q.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def cv_controls(A, b, rk, l1_ratio: float, cfg) -> dict:
    """Two faults the x hold must see and the objective hold may not: the
    torch driver on ``rk``'s grid with Q read as a TF32 matvec reads it (a
    10-bit mantissa, rounded to nearest), and with every lane's α₂ read 1%
    high. Each is read against ``rk`` on the lanes ``rk`` certifies, by
    ``compare_cv``'s two measures; printed, not held. (``allow_tf32`` alone
    would change nothing here: the driver's batched (n × n)·(n × 1) matvec
    runs without tensor cores.)"""
    import dataclasses

    import torch

    from fastoptsolver_tpu_torch.batch import cv, fista_gram_batch
    from fastoptsolver_tpu_torch.ops import estimate_lipschitz_gram

    Ac, bc = A - A.mean(dim=0), b - b.mean()
    folds = cv._folds(Ac, bc, CV_FOLDS)
    Q, c, btb = cv._train_grams(Ac, bc, folds)
    gb = cv._grid(Q, c, btb, estimate_lipschitz_gram(Q),
                  *cv._penalties(rk.alphas, folds.sizes, CV_M, 0.0, l1_ratio))
    x_tf32 = fista_gram_batch(dataclasses.replace(gb, Q=round_tf32(gb.Q)), cfg).x
    x_a2 = fista_gram_batch(dataclasses.replace(gb, alpha2=gb.alpha2 * 1.01), cfg).x
    gb64 = cv_grid64(A, b, rk.alphas, l1_ratio)
    xk = cv_x(rk)
    fk, _ = cv_lanes64(gb64, xk)
    lanes = rk.converged_grid.reshape(-1)
    out = {}
    for name, X in (("tf32_q", x_tf32), ("alpha2_1pct_high", x_a2)):
        f, _ = cv_lanes64(gb64, X)
        out[name] = dict(max_rel_dobj=max_rel_dobj(fk, f, lanes), max_rel_dx=max_rel_dx(xk, X, lanes))
    print("-- cv controls (faults held against the kernel route's x on the lanes it "
          "certifies): " + ", ".join(f"{k}: max rel |dobj| {v['max_rel_dobj']:.3e}, max rel "
                                      f"|dx| {v['max_rel_dx']:.3e}" for k, v in out.items()))
    return out


def cv_path(dev, mods) -> dict:
    """Phase 10: ``cv_lasso`` at the YearPredictionMSD shape through the burst
    kernel (lasso with an intercept, then an elastic-net ladder), held against
    the torch driver, timed and split; then ``lasso_path`` on the same data."""
    import torch

    from fastoptsolver_tpu_torch.batch import (
        BatchFISTAConfig, cv, cv_lasso, fista_gram_batch, lasso_path, solve_gram_batch)
    from fastoptsolver_tpu_torch.kernels import fista_vmem
    from fastoptsolver_tpu_torch.ops import estimate_lipschitz_gram, lipschitz
    from fastoptsolver_tpu_torch.problems import LeastSquares

    A, b = cv_problem(dev)
    torch.cuda.synchronize()
    cfg = BatchFISTAConfig(max_iter=2000, check_every=25)
    kw = dict(k_folds=CV_FOLDS, n_alphas=CV_ALPHAS, eps=1e-3, cfg=cfg, fit_intercept=True)
    out = {}
    for label, l1_ratio in (("lasso", 1.0), ("enet", 0.5)):
        zero_counts(mods)
        rk = cv_lasso(A, b, l1_ratio=l1_ratio, **kw)
        torch.cuda.synchronize()
        counts = {k: m.LAUNCHES for k, m in mods.items()}
        require(counts["burst"] > 0 and sum(counts.values()) == counts["burst"],
                f"cv {label}: launches {counts} (want burst > 0, every other 0)")
        lanes = (CV_FOLDS + 1) * CV_ALPHAS
        require(rk.coef_folds.shape == (CV_FOLDS, CV_ALPHAS, CV_N)
                and bool(torch.isfinite(rk.coef_path).all()) and bool(torch.isfinite(rk.mse_path).all()),
                f"cv {label}: results not finite of the expected shapes")
        if l1_ratio < 1.0:
            a2 = rk.alphas * (1.0 - l1_ratio) / l1_ratio
            require(float(a2.max() / a2.min()) > 100.0, "cv enet: α₂ does not vary by lane")
        rx = cv_lasso(A, b, l1_ratio=l1_ratio, backend="xla", **kw)
        out[label] = dict(compare_cv(A, b, rk, rx, l1_ratio, label), launches=counts["burst"])
        if l1_ratio < 1.0:
            out[label]["controls"] = cv_controls(A, b, rk, l1_ratio, cfg)
        print(f"-- cv {label}: {lanes} lanes at n={CV_N}, burst launches {counts['burst']}")
        del rk, rx

    # the split of one call: folds and Grams, the Lipschitz loop, the solve
    cv_ms, cv_trials, _ = med_ms(lambda: cv_lasso(A, b, **kw))
    Ac, bc = A - A.mean(dim=0), b - b.mean()
    grams_ms, _, (Q_all, c_all, btb_all) = med_ms(
        lambda: cv._train_grams(Ac, bc, cv._folds(Ac, bc, CV_FOLDS)))
    # the loop reads its stop on the host every _STOP_EVERY steps; beside it,
    # in turns, a read every step (the masks make both the same bits)
    every = lipschitz._STOP_EVERY
    lip = {every: [], 1: []}
    try:
        for k in (every, 1, 1, every):
            lipschitz._STOP_EVERY = k
            ms, _, L_all = med_ms(lambda: estimate_lipschitz_gram(Q_all))
            lip[k].append(ms)
    finally:
        lipschitz._STOP_EVERY = every
    lip_ms, lip1_ms = median(lip[every]), median(lip[1])
    folds = cv._folds(Ac, bc, CV_FOLDS)
    alphas = cv._ladder(c_all[-1].abs().amax(), CV_ALPHAS, 1e-3, A.dtype)
    gb = cv._grid(Q_all, c_all, btb_all, L_all, *cv._penalties(alphas, folds.sizes, CV_M,
                                                              0.0, 1.0))
    solve_ms, _, res_s = med_ms(lambda: solve_gram_batch(gb, cfg))
    plain_ms, _, _ = med_ms(lambda: fista_vmem.fista_gram_vmem_reference(gb, cfg))
    driver_ms, _, _ = med_ms(lambda: fista_gram_batch(gb, cfg))
    # the routed solve: Q, c and the rows read once, x written once; every
    # lane runs every burst's steps
    B = gb.c.shape[1]
    bnd = bound(4 * (CV_N * CV_N * B + 2 * CV_N * B + 6 * B),
                solve_ops(CV_N, B * int(res_s.n_iters_total), cfg.check_every))
    print(f"[10 cv] cv_lasso at ({CV_M}, {CV_N}), {CV_FOLDS} folds × {CV_ALPHAS} alphas = "
          f"{(CV_FOLDS + 1) * CV_ALPHAS} lanes: {cv_ms:.3f} ms median of 3 (trials "
          f"{[round(x, 3) for x in cv_trials]}) = folds and Grams {grams_ms:.3f} + Lipschitz "
          f"loop {lip_ms:.3f} (a stop read every step: {lip1_ms:.3f}) + burst solve {solve_ms:.3f} (bound {bnd[0]:.4f} ms by {bnd[1]}; "
          f"its twin {plain_ms:.3f}, the torch driver on the same grid {driver_ms:.3f}) | "
          f"burst launches lasso {out['lasso']['launches']}, enet "
          f"{out['enet']['launches']} | certified lasso {out['lasso']['certified']}, enet "
          f"{out['enet']['certified']}")
    del Ac, bc, folds, gb, Q_all

    zero_counts(mods)
    path_ms, (alphas_p, rp) = cuda_ms(lambda: lasso_path(LeastSquares.create(A, b, "lasso")))
    counts = {k: m.LAUNCHES for k, m in mods.items()}
    n_p = int(rp.converged.sum())
    require(sum(counts.values()) == 0, f"lasso_path launched {counts} (the driver's path)")
    require(n_p == alphas_p.numel() and bool(torch.isfinite(rp.x).all()),
            f"lasso_path: {n_p}/{alphas_p.numel()} certified")
    print(f"-- lasso_path at ({CV_M}, {CV_N}): {n_p}/{alphas_p.numel()} certified, "
          f"{path_ms:.3f} ms, iters max {int(rp.iters.max())} (the torch driver, no kernel)")
    return dict(out, e2e_ms=cv_ms, trials_ms=cv_trials, grams_ms=grams_ms, lipschitz_ms=lip_ms,
                lipschitz_every_step_ms=lip1_ms,
                solve_ms=solve_ms, plain_ms=plain_ms, driver_ms=driver_ms, bound_ms=bnd[0],
                bound_by=bnd[1], lanes=(CV_FOLDS + 1) * CV_ALPHAS,
                n=CV_N, m=CV_M, lasso_path_ms=path_ms, lasso_path_certified=n_p)


# ---- phase 11: the single-problem layer ----

def ar1_problem(dev, m: int, n: int, rho: float):
    """A tall float32 lasso table on the card from seed 0: columns AR(1)
    correlated, a_j = ρ·a_{j−1} + √(1−ρ²)·z_j with z ~ N(0, 1) (corr(a_i,
    a_j) = ρ^|i−j|), a 10%-sparse x_true with N(0, 9) entries, noise σ = 9.
    Returns ``(A, b)``. Phase 11 uses it at the YearPredictionMSD shape with
    ρ = 0.9; the CV cell's correlated columns (ROADMAP) can take it as it is."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    Z = torch.randn((m, n), generator=g, device=dev)
    A = torch.empty_like(Z)
    A[:, 0] = Z[:, 0]
    for j in range(1, n):
        A[:, j] = rho * A[:, j - 1] + (1.0 - rho * rho) ** 0.5 * Z[:, j]
    del Z
    keep = torch.rand((n,), generator=g, device=dev) < 0.1
    x_true = torch.where(keep, 3.0 * torch.randn((n,), generator=g, device=dev), 0.0)
    b = A @ x_true + 9.0 * torch.randn((m,), generator=g, device=dev)
    return A, b


def hold_reading(x, x_ref, f_of, f_ref) -> dict:
    """A solution's distance from a float64 yardstick: the relative objective
    difference |f(x) − f_ref|/|f_ref| (f the float64 objective) and
    ‖x − x_ref‖∞/‖x_ref‖∞."""
    gap = abs(float(f_of(x.double())) - float(f_ref)) / abs(float(f_ref))
    dx = float((x.double() - x_ref).abs().max() / x_ref.abs().max())
    return dict(rel_gap=gap, rel_dx=dx)


def passes(reading: dict, limit) -> bool:
    return reading["rel_gap"] <= limit[0] and reading["rel_dx"] <= limit[1]


def verdict(reading: dict, limit) -> str:
    return (f"rel gap {reading['rel_gap']:.3e}, rel |dx| {reading['rel_dx']:.3e}, "
            + ("passes" if passes(reading, limit) else "refused"))


def solve_table(dev) -> dict:
    """Phase 11's table: ``solve`` with each of its nine methods at its
    defaults on the AR(1) table (lbfgs as ridge), timed and held at its
    ``SOLVE_HOLDS`` limit: the converging methods against the float64
    optimum, ista, svrg and saga against the same call in float64 on the
    card, admm against the same call on the CPU. Each hold must refuse its
    control, the same call with α 1% high; fista and admm also read the
    solver on Q rounded to TF32 (printed). fista, ista and cd are also held
    against the same call on the CPU, with the α-high call as that hold's
    control."""
    import dataclasses

    import torch

    from fastoptsolver_tpu_torch import api, solve, solvers
    from fastoptsolver_tpu_torch.ops import relative_gap
    from fastoptsolver_tpu_torch.problems import LeastSquares
    from fastoptsolver_tpu_torch.solvers import CDConfig, certified_optimum

    m, n = SOLVE_M, SOLVE_N
    A, b = ar1_problem(dev, m, n, SOLVE_RHO)
    a1 = float(0.1 * (A.T @ b).abs().max())
    a2 = a1  # the ridge weight of lbfgs' run: the same scale as α₁
    # the yardsticks, float64 on the card: CD's certified lasso optimum, the
    # ridge closed form
    p64 = LeastSquares.create(A, b, "lasso", a1, dtype=torch.float64)
    g64 = p64.to_gram()
    x_star, f_star = certified_optimum(g64, CDConfig(max_sweeps=5000, tol=1e-12))
    gap_star = float(relative_gap(g64, x_star))
    Q64, c64 = g64.Q, g64.c
    xr_star = torch.linalg.solve(Q64 + a2 * torch.eye(n, dtype=Q64.dtype, device=dev), c64)
    ridge_f = lambda x: (0.5 * (x @ (Q64 @ x)) - c64 @ x + 0.5 * g64.btb + 0.5 * a2 * (x @ x))
    fr_star = ridge_f(xr_star)
    torch.cuda.synchronize()
    print(f"-- solve yardsticks (float64 on the card): lasso f* {float(f_star):.10g} from CD "
          f"(relative gap {gap_star:.2e}, {int((x_star != 0).sum())} nonzeros of {n}); ridge "
          f"f* {float(fr_star):.10g} from the closed form; α₁ = α₂ = {a1:.6g}")
    require(gap_star <= 1e-10, f"solve: CD's float64 optimum has a relative gap {gap_star:.3e}")
    g_tf32 = LeastSquares.create(A, b, "lasso", a1).to_gram()
    g_tf32 = dataclasses.replace(g_tf32, Q=round_tf32(g_tf32.Q))

    out = {}
    for method in SOLVE_METHODS:
        ridge = method == "lbfgs"
        reg, key, a = ("ridge", "alpha2", a2) if ridge else ("lasso", "alpha1", a1)
        kw = dict(epochs=SOLVE_EPOCHS) if method in ("svrg", "saga") else {}
        call = lambda s=1.0, A=A, b=b, **d: solve(A, b, reg, method=method, **{key: a * s},
                                                  **kw, **d)
        if method == "cd":  # all 1000 sweeps in float32 (its move never falls
            # below tol 1e-12), ~11-14 s on the card: one timed call, not a median of 3
            ms, res = cuda_ms(call)
            trials = [ms]
        else:
            ms, trials, res = med_ms(call)
        iters = int(res.n_iters)
        steps = iters * (m // 128) if method in ("svrg", "saga") else iters
        require(bool(torch.isfinite(res.x).all()) and res.x.shape == (n,),
                f"solve {method}: x not finite of shape ({n},)")
        on_cpu = method in SOLVE_ON_CPU or method in SOLVE_AGAINST_CPU_RUN
        x_cpu = call(A=A.cpu(), b=b.cpu()).x if on_cpu else None
        if method in SOLVE_AGAINST_F64_RUN:
            x_ref, f_of, against = call(dtype=torch.float64).x, g64.objective, "the float64 run"
            f_ref = f_of(x_ref)
        elif method in SOLVE_AGAINST_CPU_RUN:
            x_ref, f_of, against = x_cpu.to(dev).double(), g64.objective, "the same call on the CPU"
            f_ref = f_of(x_ref)
        elif ridge:
            x_ref, f_of, f_ref, against = xr_star, ridge_f, fr_star, "the ridge closed form"
        else:
            x_ref, f_of, f_ref, against = x_star, g64.objective, f_star, "the float64 optimum"
        limit = SOLVE_HOLDS[method]
        reading = hold_reading(res.x, x_ref, f_of, f_ref)
        x_high = call(1.01).x
        control = hold_reading(x_high, x_ref, f_of, f_ref)
        row = dict(route="gram" if api.uses_gram(method, m, n) else "raw", iters=iters,
                   steps=steps, ms=ms, trials_ms=trials, us_per_step=ms * 1e3 / max(steps, 1),
                   against=against, limit=limit, control=control, **reading)
        require(passes(reading, limit), f"solve {method}: {reading} beyond its limit {limit}")
        require(not passes(control, limit),
                f"solve {method}: the control (α 1% high) passes the hold: {control}")
        note = f"control (α 1% high) {verdict(control, limit)}"
        if method in SOLVE_TF32_CONTROL:
            row["tf32_q"] = hold_reading(getattr(solvers, method)(g_tf32).x, x_ref, f_of, f_ref)
            note += f"; control (Q rounded to TF32) {verdict(row['tf32_q'], limit)}"
        if method in SOLVE_AGAINST_CPU_RUN:
            x64 = call(dtype=torch.float64).x
            row["f64_run"] = hold_reading(res.x, x64, g64.objective, g64.objective(x64))
            note += (f" | the float64 run (not held): rel gap {row['f64_run']['rel_gap']:.3e}, "
                     f"rel |dx| {row['f64_run']['rel_dx']:.3e}")
        if method in SOLVE_ON_CPU:
            dx = lambda x: float((x.cpu() - x_cpu).abs().max() / x_cpu.abs().max())
            row.update(cpu_rel_dx=dx(res.x), cpu_control_rel_dx=dx(x_high))
            require(row["cpu_rel_dx"] <= SOLVE_CPU_RTOL,
                    f"solve {method}: card and CPU differ by {row['cpu_rel_dx']:.3e} of max |x|")
            require(row["cpu_control_rel_dx"] > SOLVE_CPU_RTOL,
                    f"solve {method}: the α-high call passes the CPU hold "
                    f"({row['cpu_control_rel_dx']:.3e})")
            note += (f" | card vs CPU {row['cpu_rel_dx']:.3e} of max |x| (limit "
                     f"{SOLVE_CPU_RTOL:g}; control {row['cpu_control_rel_dx']:.3e}, refused)")
        out[method] = row
        print(f"-- solve {method:11s} {row['route']:4s} iters {iters:5d} ({steps} steps) "
              f"{ms:9.3f} ms ({row['us_per_step']:9.3f} us a step; trials "
              f"{[round(t, 3) for t in trials]}) | against {against}: rel gap "
              f"{reading['rel_gap']:.3e}, rel |dx| {reading['rel_dx']:.3e}, held at {limit}; "
              + note)
    return out


def scenario_sweep(dev) -> dict:
    """``solve_batch`` over the reference's 80 scenarios (``scenario_grid``
    through ``generate_scenario_batch``, m = 1000, n = 5, columns
    standardized, the sweep's α₁ = 1.0 lasso, α₂ = 0.5 ridge for lbfgs), each
    lane held against the same solver on its own problem with the same L:
    x and the iteration count. In float64: in float32 L-BFGS's factr rule
    fires on a decrease of an ulp, so a lane and its single solve, rounded
    apart by the batched matmul, stop at other iterations (66 of 80 lanes in
    the CPU rehearsal, x apart by up to 4.6%)."""
    import torch

    from fastoptsolver_tpu_torch import solvers
    from fastoptsolver_tpu_torch.batch import batch_lipschitz, solve_batch, stack_problems
    from fastoptsolver_tpu_torch.problems import (
        LeastSquares, generate_scenario_batch, scenario_grid)

    grid = scenario_grid()
    B = len(grid)
    A, b, _ = generate_scenario_batch(torch.Generator(device=dev).manual_seed(0), B, m=1000,
                                      noise_std=[g[1] for g in grid],
                                      rho1=[g[2] for g in grid], rho2=[g[3] for g in grid],
                                      dtype=torch.float64)
    A = (A - A.mean(1, keepdim=True)) / A.std(1, unbiased=False, keepdim=True)
    out = {}
    for method in ("fista", "ista", "lbfgs"):
        reg, a1, a2 = ("ridge", 0.0, 0.5) if method == "lbfgs" else ("lasso", 1.0, 0.0)
        probs = [LeastSquares.create(A[i], b[i], reg, a1, a2, dtype=torch.float64)
                 for i in range(B)]
        pb = stack_problems(probs)
        L = batch_lipschitz(pb) if method != "lbfgs" else None
        batch_ms, trials, res = med_ms(lambda: solve_batch(pb, method, L=L))
        single = getattr(solvers, method)
        kw = (lambda i: {}) if method == "lbfgs" else (lambda i: dict(L=L[i]))
        singles_ms, ones = cuda_ms(lambda: [single(p, **kw(i)) for i, p in enumerate(probs)])
        X1 = torch.stack([r.x for r in ones])
        d = float(((res.x - X1).abs().amax(1) / X1.abs().amax(1)).max())
        it_eq = bool(torch.equal(res.n_iters, torch.stack([r.n_iters for r in ones])))
        out[method] = dict(batch_ms=batch_ms, trials_ms=trials, singles_ms=singles_ms,
                           max_rel_dx=d, iters_equal=it_eq,
                           iters_max=int(res.n_iters.max()))
        print(f"-- solve_batch {method}: {B} lanes in {batch_ms:.3f} ms (trials "
              f"{[round(t, 3) for t in trials]}) vs the {B} single calls {singles_ms:.3f} ms | "
              f"each lane against its single solve: max rel |dx| {d:.3e} (limit "
              f"{SWEEP_RTOL:g}), iterations equal {it_eq}, max {int(res.n_iters.max())}")
        require(d <= SWEEP_RTOL and it_eq,
                f"solve_batch {method}: lanes part from their single solves ({d:.3e}, "
                f"iterations equal {it_eq})")
    return out


def large_lasso_hold(dev) -> dict:
    """``bench.large_lasso.run`` at its default 131072 × 2048 for
    ``LARGE_ITERS`` iterations: the timed run's x held against the same
    iterations in float64 on the card from the same data and L
    (``LARGE_HOLD``), with the float32 run at α₁ 1% high as the control."""
    import dataclasses

    import torch

    from fastoptsolver_tpu_torch.bench import large_lasso
    from fastoptsolver_tpu_torch.problems import LeastSquares
    from fastoptsolver_tpu_torch.solvers import FISTAConfig, fista

    rec, p32, x32 = large_lasso.run(iters=LARGE_ITERS)
    cfg = FISTAConfig(max_iter=LARGE_ITERS)
    x_high = fista(dataclasses.replace(p32, alpha1=p32.alpha1 * 1.01), cfg, L=rec["L"]).x
    p64 = LeastSquares(A=p32.A.double(), b=p32.b.double(), alpha1=p32.alpha1.double(),
                       alpha2=torch.zeros((), dtype=torch.float64, device=dev))
    x64 = fista(p64, cfg, L=rec["L"]).x
    f64 = p64.objective(x64)
    reading = hold_reading(x32, x64, p64.objective, f64)
    control = hold_reading(x_high, x64, p64.objective, f64)
    print(f"[11 large lasso] {rec['m']} x {rec['n']} float32 ({rec['a_bytes'] / 2 ** 30:.2f} "
          f"GiB), {LARGE_ITERS} iterations: {rec['seconds'] * 1e3:.3f} ms, "
          f"{rec['iters_per_s']:.1f} iterations/s, {rec['ms_per_iter']:.4f} ms an iteration "
          f"against the {rec['bound_ms_per_iter']:.4f} ms bound ({rec['pct_of_bound']:.1f}%), "
          f"{rec['achieved_gbps']:.1f} GB/s = {rec['pct_of_ceiling']:.1f}% of the "
          f"{rec['stream_ceiling_gbps']:.1f} GB/s read ceiling | Lipschitz loop "
          f"{rec['lipschitz_seconds'] * 1e3:.3f} ms | the timed run against the float64 run: "
          f"rel gap {reading['rel_gap']:.3e}, rel |dx| {reading['rel_dx']:.3e}, held at "
          f"{LARGE_HOLD}; control (α 1% high) {verdict(control, LARGE_HOLD)}")
    require(passes(reading, LARGE_HOLD), f"large lasso: {reading} beyond {LARGE_HOLD}")
    require(not passes(control, LARGE_HOLD),
            f"large lasso: the control (α 1% high) passes the hold: {control}")
    del p32, p64, x64
    torch.cuda.empty_cache()
    return dict(rec, hold=reading, control=control, limit=LARGE_HOLD)


def lasso_closures(A, b, a1: float, device):
    """The reference ISTA's closures ``g``, ``grad_g`` and ``prox_h`` for the
    lasso on ``(A, b)``, over torch tensors on ``device`` in the default dtype."""
    import torch

    At = torch.as_tensor(A, dtype=torch.get_default_dtype(), device=device)
    bt = torch.as_tensor(b, dtype=torch.get_default_dtype(), device=device)
    return (lambda x: 0.5 * ((At @ x - bt) @ (At @ x - bt)),
            lambda x: At.T @ (At @ x - bt),
            lambda v, t: torch.sign(v) * torch.clamp_min(torch.abs(v) - t * a1, 0.0))


def compat_checks(dev) -> dict:
    """``compat`` on ``generate_correlated_boston_like_data(m=1000)`` (columns
    standardized) in the default float32 on the card: fista, fista_delta and
    ista with histories against the same calls in float64 on the CPU, and
    ``LBFGSSolver("ridge")``'s final objective against
    ``scipy.optimize.fmin_l_bfgs_b``, the upstream's own call."""
    import numpy as np
    import torch
    from scipy.optimize import fmin_l_bfgs_b

    from fastoptsolver_tpu_torch import compat

    A, b, _ = compat.generate_correlated_boston_like_data(m=1000)
    A = (A - A.mean(0)) / A.std(0)
    L = compat.estimate_lipschitz(A)
    a1 = 0.5
    runs = {
        "fista": lambda **d: compat.fista(A, b, "lasso", a1, 0.0, max_iter=200,
                                          return_history=True, **d),
        "fista_delta": lambda **d: compat.fista_delta(A, b, "lasso", a1, 0.0, 3.0, max_iter=200,
                                                      return_history=True, **d),
        "ista": lambda **d: compat.ista(np.zeros(5), *lasso_closures(A, b, a1, d.get("device", dev)),
                                        L, max_iter=200, return_history=True, **d),
    }
    out, x = {}, None
    old = torch.get_default_dtype()
    for name, run in runs.items():
        x, hist = run()
        torch.set_default_dtype(torch.float64)
        try:
            x64, _ = run(device="cpu")
        finally:
            torch.set_default_dtype(old)
        out[name] = dict(rel_dx=float(np.abs(x - x64).max() / np.abs(x64).max()),
                         **{f"history_{k}": len(v) for k, v in hist.items()})

    def fg(z):
        r = A @ z - b
        return 0.5 * r @ r + 0.5 * z @ z, A.T @ r + z

    _, f_sp, _ = fmin_l_bfgs_b(fg, np.zeros(5))
    solver = compat.LBFGSSolver("ridge", 0.0, 1.0).fit(A, b)
    rel = abs(solver.final_obj_ - f_sp) / abs(f_sp)
    out["lbfgs"] = dict(final_obj=solver.final_obj_, scipy_obj=float(f_sp), rel=rel,
                        iters=len(solver.history_))
    ok = (out["fista"]["history_x"] == 201 and out["fista"]["history_obj"] == 200
          and out["fista_delta"]["history_x"] == 200 and out["fista_delta"]["history_obj"] == 200
          and out["ista"]["history_x"] == 201
          and out["ista"]["history_t"] == 201 and out["ista"]["history_delta"] == 200
          and max(out[k]["rel_dx"] for k in ("fista", "fista_delta", "ista")) <= COMPAT_RTOL
          and rel <= COMPAT_RTOL and x.dtype == np.float32)
    print(f"-- compat (float32 on the card vs float64 on the CPU, rel |dx| of max |x|): fista "
          f"{out['fista']['rel_dx']:.3e} (history x {out['fista']['history_x']}, obj "
          f"{out['fista']['history_obj']}), fista_delta {out['fista_delta']['rel_dx']:.3e} "
          f"(history x {out['fista_delta']['history_x']}), ista {out['ista']['rel_dx']:.3e} "
          f"(history x {out['ista']['history_x']}, t {out['ista']['history_t']}, delta "
          f"{out['ista']['history_delta']}) | LBFGSSolver ridge final objective "
          f"{solver.final_obj_:.10g} vs scipy fmin_l_bfgs_b {f_sp:.10g}: rel {rel:.3e} "
          f"({len(solver.history_)} iterations) | limit {COMPAT_RTOL:g}")
    require(ok, f"compat: {out}")
    return out


def solve_path(dev, mods) -> dict:
    """Phase 11: the single-problem layer on the card. No hand-written
    kernel is on this path: every count stays 0 over the solves; the
    large-lasso bench's read ceiling launches the stream kernel after them."""
    t0 = time.perf_counter()
    zero_counts(mods)
    table = solve_table(dev)
    sweep = scenario_sweep(dev)
    comp = compat_checks(dev)
    import torch

    torch.cuda.synchronize()
    counts = {k: m.LAUNCHES for k, m in mods.items()}
    require(sum(counts.values()) == 0, f"phase 11 launched kernels: {counts}")
    large = large_lasso_hold(dev)
    print(f"[11 solve] AR(1) table ({SOLVE_M}, {SOLVE_N}), ρ = {SOLVE_RHO}: nine methods "
          f"held ({len(SOLVE_AGAINST_F64_RUN)} against their float64 runs, "
          f"{len(SOLVE_AGAINST_CPU_RUN)} against its CPU run), each control "
          f"refused; solve_batch on 80 "
          f"scenarios; compat; large lasso {large['pct_of_bound']:.1f}% of its bound | kernel "
          f"launches over the solves {counts} | {time.perf_counter() - t0:.1f} s")
    return dict(table=table, sweep=sweep, compat=comp, large_lasso=large, launches=counts)


# ---- phase 12: the estimator surface, the problem families, sparse, genlasso ----

def burst_recorder(calls: list):
    """A stand-in for ``fista_vmem._launch_burst`` that launches it and keeps
    each launch's gap row; a launch at iteration 0 opens a new solve in
    ``calls``. Returns ``(install, remove)``."""
    from fastoptsolver_tpu_torch.kernels import fista_vmem

    launch = fista_vmem._launch_burst

    def recorded(*args, **kw):
        out = launch(*args, **kw)
        if args[1] == 0:
            calls.append([])
        calls[-1].append(out[-1][0].clone())
        return out

    def install():
        fista_vmem._launch_burst = recorded

    def remove():
        fista_vmem._launch_burst = launch
    return install, remove


def certified_by_burst(gaps, tol: float) -> list:
    """Lanes certified after each burst of one solve (a lane certifies at the
    first burst whose gap is ≤ ``tol``, as ``_solve_on_device`` counts)."""
    done, out = None, []
    for g in gaps:
        ok = g <= tol
        done = ok if done is None else done | ok
        out.append(int(done.sum()))
    return out


def est_cv_grid(Ap, bp, alphas, l1_ratio: float, cfg, scale: float = 1.0, tf32: bool = False):
    """The f32 CV grid of ``cv_lasso(fit_intercept=True)`` on rows already
    permuted, by ``batch.cv``'s own rules; α₁ (and the ladder's α₂) times
    ``scale``, Q rounded to TF32 if asked: the controls' grids."""
    import dataclasses

    from fastoptsolver_tpu_torch.batch import cv
    from fastoptsolver_tpu_torch.ops import estimate_lipschitz_gram

    Ac, bc = Ap - Ap.mean(dim=0), bp - bp.mean()
    folds = cv._folds(Ac, bc, CV_FOLDS)
    Q, c, btb = cv._train_grams(Ac, bc, folds)
    gb = cv._grid(Q, c, btb, estimate_lipschitz_gram(Q),
                  *cv._penalties(alphas * scale, folds.sizes, Ap.shape[0], 0.0, l1_ratio))
    return dataclasses.replace(gb, Q=round_tf32(gb.Q)) if tf32 else gb


def est_cv_reading(gb64, rk, fk, X, lanes) -> dict:
    """``X`` (lanes, n) against the kernel route's x on ``lanes``: the
    float64 objective on the grid ``gb64`` (``fk`` the kernel route's) and
    x (``max_rel_dobj``, ``max_rel_dx``)."""
    f, _ = cv_lanes64(gb64, X)
    return dict(max_rel_dobj=max_rel_dobj(fk, f, lanes), max_rel_dx=max_rel_dx(cv_x(rk), X, lanes))


def est_cv_passes(r: dict) -> bool:
    return r["max_rel_dobj"] <= EST_CV_HOLD[0] and r["max_rel_dx"] <= EST_CV_HOLD[1]


def est_fit_reading(mse_by_ratio: dict, fit, ratio: float, fits64: dict, Xp, yp) -> dict:
    """A CV fit's attributes against the float64 fits on the CPU (``fits64``,
    one a ratio): every ratio's ``mse_path_`` (max |Δ| over the least MSE),
    and at the fit's chosen (ratio, α index) its ``coef_`` (over the largest
    |coef|), ``intercept_`` (over std(y)) and the float64 mean MSE there over
    the float64 minimum (``selection``: 0 where both choose alike)."""
    import numpy as np

    mse = max(float(np.abs(mse_by_ratio[r] - f.mse_path_).max() / f.mse_path_.min())
              for r, f in fits64.items())
    e64 = fits64[ratio]
    idx = int(np.argmin(mse_by_ratio[ratio].mean(1)))
    c64 = e64.coef_path_[idx]
    best64 = min(float(f.mse_path_.mean(1).min()) for f in fits64.values())
    return dict(
        mse_path=mse, coef=float(np.abs(fit.coef_ - c64).max() / np.abs(c64).max()),
        intercept=abs(fit.intercept_ - float(np.mean(yp) - np.mean(Xp, 0) @ c64)) / float(np.std(yp)),
        selection=(float(e64.mse_path_.mean(1)[idx]) - best64) / best64, alpha_index=idx)


def est_fit_passes(r: dict) -> bool:
    return all(r[k] <= v for k, v in EST_FIT_HOLD.items())


def est_fit_line(r: dict) -> str:
    return (f"max |dmse_path_| / min mse {r['mse_path']:.3e}, coef_ {r['coef']:.3e} of max |coef|, "
            f"intercept_ {r['intercept']:.3e} of std(y), selection {r['selection']:.3e} "
            f"(α index {r['alpha_index']})")


def est_cv(dev, mods, A, b, X, y, perm, iid_cv_ms=None) -> dict:
    """Phase 12 (a): ``LassoCV`` and ``ElasticNetCV`` on the AR(1) table, the
    burst kernel counted and read burst by burst; each ``cv_lasso`` call of
    the fit repeated directly (the estimator's attributes are its bits), held
    against the torch driver on the same grid (``EST_CV_HOLD``, with an
    α₁-1%-high and a TF32-Q control), the fitted attributes against the same
    estimator in float64 on the CPU, and the fit timed and split, the
    ``cv_lasso`` call beside phase 10's on i.i.d. columns (``iid_cv_ms``)."""
    import numpy as np
    import torch

    from fastoptsolver_tpu_torch import ElasticNetCV, LassoCV
    from fastoptsolver_tpu_torch.batch import (
        BatchFISTAConfig, cv_lasso, fista_gram_batch, solve_gram_batch)
    from fastoptsolver_tpu_torch.kernels import fista_vmem
    from fastoptsolver_tpu_torch.problems.base import as_tensor

    # the CV estimators' grid configuration (estimators._CVRegressor._cv)
    cfg = BatchFISTAConfig(max_iter=2000, check_every=25, rel_gap_tol=1e-7)
    Ap, bp = A[perm], b[perm]
    perm_np = perm.cpu().numpy()
    Xp, yp = X[perm_np], y[perm_np]
    out = {}
    for label, cls, ratios in (("lassocv", LassoCV, (1.0,)),
                               ("enetcv", ElasticNetCV, EST_L1_RATIOS)):
        kw = dict(cv=CV_FOLDS, n_alphas=CV_ALPHAS)
        if cls is ElasticNetCV:
            kw["l1_ratio"] = list(ratios)
        make = lambda **d: cls(**kw, **d)
        calls = []
        install, remove = burst_recorder(calls)
        zero_counts(mods)
        install()
        try:
            est = make().fit(X, y)
            torch.cuda.synchronize()
        finally:
            remove()
        counts = {k: m.LAUNCHES for k, m in mods.items()}
        bursts = [len(c) for c in calls]
        cert = [certified_by_burst(c, cfg.rel_gap_tol) for c in calls]
        lanes_n = (CV_FOLDS + 1) * CV_ALPHAS
        print(f"-- {label}: burst launches {counts['burst']} over {len(calls)} cv_lasso "
              f"call(s), bursts a call {bursts}; lanes certified (of {lanes_n}) after each "
              f"burst: {cert}")
        require(len(calls) == len(ratios) and counts["burst"] == sum(bursts)
                and sum(counts.values()) == counts["burst"],
                f"{label}: launches {counts} over {len(calls)} cv_lasso calls (want the burst "
                f"kernel in each of {len(ratios)}, every other engine 0)")
        require(min(bursts) > 1,
                f"{label}: a cv_lasso call certified every lane in one burst ({bursts}): the "
                "AR(1) table is not doing its job")
        row = dict(launches=counts["burst"], bursts=bursts, certified_by_burst=cert, ratios={})
        for r in ratios:
            gen = lambda: torch.Generator(device=dev).manual_seed(0)
            ckw = dict(k_folds=CV_FOLDS, n_alphas=CV_ALPHAS, eps=1e-3, cfg=cfg,
                       fit_intercept=True, l1_ratio=r)
            rk = cv_lasso(A, b, generator=gen(), **ckw)
            rx = cv_lasso(A, b, generator=gen(), backend="xla", **ckw)
            i = ratios.index(r)
            mse = est.mse_path_[i] if len(ratios) > 1 else est.mse_path_
            require(np.array_equal(mse, rk.mse_path.double().cpu().numpy().T),
                    f"{label} ratio {r}: the estimator's mse_path_ is not its cv_lasso call's")
            # lanes both routes certify at the same iteration: there the two x
            # differ by rounding alone (a lane certified a burst apart differs by
            # a burst's progress, up to sqrt(2·gap·f/λ_min) ≈ 4e-3 of |x| here)
            both_any = (rk.converged_grid & rx.converged_grid).reshape(-1)
            both = both_any & (rk.iters == rx.iters).reshape(-1)
            gb64 = cv_grid64(Ap, bp, rk.alphas, r)
            fk, _ = cv_lanes64(gb64, cv_x(rk))
            reading = est_cv_reading(gb64, rk, fk, cv_x(rx), both)
            mine = rk.converged_grid.reshape(-1)
            controls = {}
            for name, kwc in (("alpha1_1pct_high", dict(scale=1.01)), ("tf32_q", dict(tf32=True))):
                gbc = est_cv_grid(Ap, bp, rk.alphas, r, cfg, **kwc)
                controls[name] = est_cv_reading(gb64, rk, fk, fista_gram_batch(gbc, cfg).x, mine)
                del gbc
            del gb64
            ck, cx = int(rk.converged_grid.sum()), int(rx.converged_grid.sum())
            print(f"-- {label} ratio {r}: kernel route vs the torch driver (same generator): "
                  f"certified {ck}/{lanes_n} vs {cx}/{lanes_n}; on {int(both.sum())} lanes both "
                  f"certify at the same iteration (of {int(both_any.sum())} both certify) max rel "
                  f"|dobj| {reading['max_rel_dobj']:.3e}, max rel |dx| "
                  f"{reading['max_rel_dx']:.3e}, held at {EST_CV_HOLD} | controls on the "
                  f"kernel's certified lanes: " + ", ".join(
                      f"{k} dobj {v['max_rel_dobj']:.3e} dx {v['max_rel_dx']:.3e} "
                      f"({'passes' if est_cv_passes(v) else 'refused'})"
                      for k, v in controls.items()))
            require(both.sum() > 0 and est_cv_passes(reading),
                    f"{label} ratio {r}: the kernel route disagrees with the torch driver: {reading}")
            require(not any(est_cv_passes(v) for v in controls.values()),
                    f"{label} ratio {r}: a control passes the hold: {controls}")
            row["ratios"][r] = dict(hold=reading, controls=controls, certified=ck,
                                    driver_certified=cx, held_lanes=int(both.sum()),
                                    both_certified=int(both_any.sum()),
                                    iters_max=int(rk.iters.max()))
            if r == 1.0:
                lasso_alphas = rk.alphas
            del rk, rx

        t_f64 = time.perf_counter()
        # the fitted attributes against float64 on the CPU, on the same folds
        # (rows permuted here as the card's generator permuted them); the
        # control: the card's fit on each ratio's ladder 1% high
        mse_of = lambda e, i: e.mse_path_[i] if e.mse_path_.ndim == 3 else e.mse_path_
        fits64, highs = {}, {}
        for i, r in enumerate(ratios):
            one = dict(l1_ratio=r) if cls is ElasticNetCV else {}
            fits64[r] = cls(**dict(kw, **one, shuffle_seed=None, dtype=torch.float64,
                                   device="cpu")).fit(Xp, yp)
            ladder = est.alphas_[i] if est.alphas_.ndim == 2 else est.alphas_
            highs[r] = cls(**dict(kw, **one, alphas=1.01 * ladder)).fit(X, y)
        ratio = getattr(est, "l1_ratio_", 1.0)
        reading64 = est_fit_reading({r: mse_of(est, i) for i, r in enumerate(ratios)},
                                    est, ratio, fits64, Xp, yp)
        control64 = est_fit_reading({r: highs[r].mse_path_ for r in ratios}, highs[ratio], ratio,
                                    fits64, Xp, yp)
        print(f"-- {label} against float64 on the CPU: alpha_ {est.alpha_:.6g} vs "
              f"{float(fits64[ratio].alpha_):.6g}, l1_ratio_ {ratio}; " + est_fit_line(reading64)
              + f" | limits {EST_FIT_HOLD} | control (ladder 1% high) " + est_fit_line(control64)
              + (" passes" if est_fit_passes(control64) else " refused"))
        require(est_fit_passes(reading64), f"{label}: the card's fit leaves the float64 fit: "
                f"{reading64}")
        require(not est_fit_passes(control64), f"{label}: the control passes: {control64}")
        row.update(float64=reading64, float64_control=control64,
                   float64_seconds=time.perf_counter() - t_f64)
        del fits64, highs

        # time the fit, and its parts: the copy to the card, the cv_lasso calls
        fit_ms, fit_trials, _ = med_ms(lambda: make().fit(X, y))
        copy_ms, _, _ = med_ms(lambda: (as_tensor(X, torch.float32, dev),
                                        as_tensor(y, torch.float32, dev)))
        cv_ms = 0.0
        for r in ratios:
            ms, _, _ = med_ms(lambda: cv_lasso(
                A, b, k_folds=CV_FOLDS, n_alphas=CV_ALPHAS, eps=1e-3, cfg=cfg, fit_intercept=True,
                l1_ratio=r, generator=torch.Generator(device=dev).manual_seed(0)))
            cv_ms += ms
        # each cv_lasso call of the fit copies the table to the card
        copies = len(ratios) * copy_ms
        row.update(fit_ms=fit_ms, fit_trials_ms=fit_trials, copy_ms=copies, cv_lasso_ms=cv_ms,
                   host_ms=fit_ms - copies - cv_ms)
        print(f"-- {label} fit {fit_ms:.3f} ms median of 3 (trials "
              f"{[round(t, 3) for t in fit_trials]}) = host→card copy {len(ratios)} × "
              f"{copy_ms:.3f} + cv_lasso on the card {cv_ms:.3f} ({len(ratios)} call(s)) + host "
              f"{row['host_ms']:.3f} (phase 10's cv_lasso on i.i.d. columns: "
              f"{'not run' if iid_cv_ms is None else f'{iid_cv_ms:.3f} ms'}) | the float64 fits "
              f"on the CPU and the controls {row['float64_seconds']:.1f} s")
        out[label] = row
        del est

    # the lasso grid's solve alone: the multi-burst kernel beside its bound
    gb = est_cv_grid(Ap, bp, lasso_alphas, 1.0, cfg)
    zero_counts(mods)
    res = solve_gram_batch(gb, cfg)
    torch.cuda.synchronize()
    launches = fista_vmem.LAUNCHES
    solve_ms, solve_trials, _ = med_ms(lambda: solve_gram_batch(gb, cfg))
    B = gb.c.shape[1]
    bnd = bound(4 * (CV_N * CV_N * B + 2 * CV_N * B + 6 * B),
                solve_ops(CV_N, B * int(res.n_iters_total), cfg.check_every))
    out["solve"] = dict(ms=solve_ms, trials_ms=solve_trials, launches=launches,
                        iters=int(res.n_iters_total), certified=int(res.converged.sum()),
                        bound_ms=bnd[0], bound_by=bnd[1], lanes=B)
    print(f"-- lassocv grid solve alone (solve_gram_batch, {B} lanes, n={CV_N}): {solve_ms:.3f} ms "
          f"median of 3 (trials {[round(t, 3) for t in solve_trials]}), {launches} burst "
          f"launches, {int(res.n_iters_total)} iterations, certified {int(res.converged.sum())}"
          f"/{B} | bound {bnd[0]:.4f} ms by {bnd[1]}")
    return out


def est_alpha(Xc, yc) -> float:
    """sklearn's α for phase 11's α₁ = 0.1·‖Xcᵀyc‖∞ on the centered table:
    α₁ = n_samples·α."""
    import numpy as np

    return float(0.1 * np.abs(Xc.T @ yc).max() / Xc.shape[0])


def est_plain(dev, X, y, Y, w) -> dict:
    """Phase 12 (b): the plain estimators on the table, each against its
    float64 yardstick (CD's certified optimum for the L1 fits, the closed
    form for Ridge, the same estimator in float64 on the card for the
    positive and multi-task fits) at its ``EST_PLAIN_HOLDS`` limit, with the
    fit at α 1% high as the control; µs a step."""
    import numpy as np
    import torch

    from fastoptsolver_tpu_torch import ElasticNet, Lasso, MultiTaskLasso, Ridge
    from fastoptsolver_tpu_torch.problems import (
        LeastSquares, MultiTaskLeastSquares, NonNegativeLeastSquares)
    from fastoptsolver_tpu_torch.solvers import CDConfig, certified_optimum

    m = X.shape[0]
    Xc, yc = X - X.mean(0), y - y.mean()
    alpha = est_alpha(Xc, yc)
    a1 = m * alpha
    wn = w * (m / w.sum())
    Xw = X - np.average(X, 0, weights=wn)
    yw = y - np.average(y, weights=wn)
    Xw, yw = Xw * np.sqrt(wn)[:, None], yw * np.sqrt(wn)
    t = lambda v: torch.as_tensor(v, dtype=torch.float64, device=dev)

    def cd_optimum(Xd, yd, reg, a1_, a2_=0.0):
        g = LeastSquares.create(t(Xd), t(yd), reg, a1_, a2_, dtype=torch.float64).to_gram()
        g_cpu = type(g)(*(v.cpu() for v in (g.Q, g.c, g.btb, g.alpha1, g.alpha2)))
        x, f = certified_optimum(g_cpu, CDConfig(max_sweeps=5000, tol=1e-12))
        return x.to(dev), g.objective, f.to(dev)

    Q64 = t(Xc).T @ t(Xc)
    c64 = t(Xc).T @ t(yc)
    ridge_f = lambda x: 0.5 * (x @ (Q64 @ x)) - c64 @ x + 0.5 * float(yc @ yc) + 0.5 * a1 * (x @ x)
    xr = torch.linalg.solve(Q64 + a1 * torch.eye(X.shape[1], dtype=torch.float64, device=dev), c64)
    Yc = Y - Y.mean(0)
    cases = {
        "lasso": (lambda s: Lasso(alpha=alpha * s), {}, lambda: cd_optimum(Xc, yc, "lasso", a1)),
        "elasticnet": (lambda s: ElasticNet(alpha=alpha * s, l1_ratio=0.5), {},
                       lambda: cd_optimum(Xc, yc, "elasticnet", a1 / 2, a1 / 2)),
        "ridge": (lambda s: Ridge(alpha=a1 * s), {}, lambda: (xr, ridge_f, ridge_f(xr))),
        "lasso_positive": (lambda s, **d: Lasso(alpha=alpha * s, positive=True, **d), {}, None),
        "lasso_weighted": (lambda s: Lasso(alpha=alpha * s), dict(sample_weight=w),
                           lambda: cd_optimum(Xw, yw, "lasso", a1)),
        "multitask": (lambda s, **d: MultiTaskLasso(alpha=alpha * s, **d), {}, None),
    }
    out = {}
    for name, (make, fit_kw, yard) in cases.items():
        target = Y if name == "multitask" else y
        ms, est = cuda_ms(lambda: make(1.0).fit(X, target, **fit_kw))
        high = make(1.01).fit(X, target, **fit_kw)
        if yard is not None:
            x_ref, f_of, f_ref = yard()
            against = "the closed form" if name == "ridge" else "CD's float64 optimum"
        else:  # the same estimator in float64 on the card, its objective
            e64 = make(1.0, dtype=torch.float64, device=dev).fit(X, target, **fit_kw)
            if name == "multitask":
                p64 = MultiTaskLeastSquares.create(t(Xc), t(Yc), alpha1=a1, dtype=torch.float64)
                x_ref = t(e64.coef_.T)
            else:
                p64 = NonNegativeLeastSquares.create(t(Xc), t(yc), alpha1=a1, dtype=torch.float64)
                x_ref = t(e64.coef_)
            f_of, f_ref, against = p64.objective, p64.objective(x_ref), "its float64 run"
        coef = lambda e: t(e.coef_.T if name == "multitask" else e.coef_)
        reading = hold_reading(coef(est), x_ref, f_of, f_ref)
        control = hold_reading(coef(high), x_ref, f_of, f_ref)
        limit = EST_PLAIN_HOLDS[name]
        steps = max(int(est.n_iter_), 1)
        out[name] = dict(reading, control=control, limit=limit, ms=ms, iters=int(est.n_iter_),
                         us_per_step=ms * 1e3 / steps, against=against)
        print(f"-- {name:14s} iters {int(est.n_iter_):5d} {ms:9.3f} ms ({ms * 1e3 / steps:8.3f} us "
              f"a step) | against {against}: rel gap {reading['rel_gap']:.3e}, rel |dx| "
              f"{reading['rel_dx']:.3e}, held at {limit}; control (α 1% high) "
              f"{verdict(control, limit)}")
        require(passes(reading, limit), f"estimator {name}: {reading} beyond {limit}")
        require(not passes(control, limit), f"estimator {name}: the control passes: {control}")
    return out


def est_families(dev, A, b) -> dict:
    """Phase 12 (c): each problem family through ``fista`` on the table in
    float32, held against the same solve in float64 (``EST_FAMILY_HOLDS``),
    α at 0.1·‖∇g(0)‖∞ for each family's own loss, the control the same solve
    with α 1% high (the box: its bounds 1% wider); µs a step."""
    import dataclasses

    import torch

    from fastoptsolver_tpu_torch import problems as P
    from fastoptsolver_tpu_torch.ops import lipschitz_for
    from fastoptsolver_tpu_torch.solvers import FISTAConfig, fista

    m, n = A.shape
    g = torch.Generator(device=dev).manual_seed(12)
    w = 0.5 + 1.5 * torch.rand((m,), generator=g, device=dev)
    keep = torch.rand((n,), generator=g, device=dev) < 0.1
    x_p = torch.where(keep, torch.randn((n,), generator=g, device=dev), 0.0)
    x_p = x_p * (3.0 / (A @ x_p).abs().max())  # |A·x_p| ≤ 3
    counts = torch.poisson(torch.exp(A @ x_p), generator=g)
    bh = P.slope_lambda_bh(n, device=dev, dtype=torch.float32)

    def grad0_inf(p):
        return float(p.smooth_grad(p.x0()).abs().max())

    fams = {
        "nnls": lambda a, s: P.NonNegativeLeastSquares.create(A, b, alpha1=a * s),
        "group": lambda a, s: P.GroupLassoLeastSquares.create(A, b, alpha_g=a * s, group_size=9),
        "box": lambda a, s: P.BoxConstrainedLeastSquares.create(A, b, lower=-1.0 * s, upper=1.0 * s),
        "slope": lambda a, s: P.SlopeLeastSquares.create(A, b, lam=bh / bh[0] * a * s),
        "weighted": lambda a, s: P.WeightedLeastSquares.create(A, b, w, "lasso", alpha1=a * s),
        "huber": lambda a, s: P.HuberRegression.create(A, b, delta=9.0, alpha1=a * s),
        "quantile": lambda a, s: P.QuantileRegression.create(A, b, tau=0.5, mu=0.1, alpha1=a * s),
        "poisson": lambda a, s: P.PoissonRegression.create(A, counts, alpha1=a * s),
    }
    to64 = lambda p: dataclasses.replace(p, **{
        f.name: getattr(p, f.name).double() for f in dataclasses.fields(p)
        if isinstance(getattr(p, f.name), torch.Tensor)})
    out = {}
    for name, make in fams.items():
        a = 0.1 * grad0_inf(make(0.0, 1.0))
        cfg = FISTAConfig(backtracking=name == "poisson", max_iter=EST_FAMILY_ITERS.get(name, 500))
        p = make(a, 1.0)
        L = lipschitz_for(p)  # one L for the three runs: they differ by rounding alone
        ms, res = cuda_ms(lambda: fista(p, cfg, L=L))
        r64 = fista(to64(p), cfg, L=L.double())
        high = fista(make(a, 1.01), cfg, L=L)
        f_of = to64(p).objective
        reading = hold_reading(res.x, r64.x, f_of, f_of(r64.x))
        control = hold_reading(high.x, r64.x, f_of, f_of(r64.x))
        limit = EST_FAMILY_HOLDS[name]
        steps = int(res.n_iters)
        out[name] = dict(reading, control=control, limit=limit, ms=ms, iters=steps,
                         us_per_step=ms * 1e3 / steps, alpha=a, ls_trials=int(res.metrics.ls_iters_total))
        print(f"-- family {name:8s} α {a:.6g} iters {steps} {ms:9.3f} ms ({ms * 1e3 / steps:8.3f} "
              f"us a step) | against its float64 run: rel gap {reading['rel_gap']:.3e}, rel |dx| "
              f"{reading['rel_dx']:.3e}, held at {limit}; control ("
              f"{'bounds 1% wider' if name == 'box' else 'α 1% high'}) {verdict(control, limit)}")
        require(bool(torch.isfinite(res.x).all()), f"family {name}: x not finite")
        require(passes(reading, limit), f"family {name}: {reading} beyond {limit}")
        require(not passes(control, limit), f"family {name}: the control passes: {control}")
    return out


def sparse_problem(dev, m: int, n: int, density: float, seed: int = 0):
    """A float32 CSR design made on the card from ``seed``: ``density``·m·n
    entries at uniform positions (duplicates summed), N(0, 1) values; b from
    a 1%-sparse x_true (N(0, 1) entries) plus noise σ = 0.1."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    nnz = int(density * m * n)
    rows = torch.randint(m, (nnz,), generator=g, device=dev)
    cols = torch.randint(n, (nnz,), generator=g, device=dev)
    vals = torch.randn((nnz,), generator=g, device=dev)
    A = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (m, n)).coalesce()
    del rows, cols, vals
    keep = torch.rand((n,), generator=g, device=dev) < 0.01
    x_true = torch.where(keep, torch.randn((n,), generator=g, device=dev), 0.0)
    b = torch.mv(A, x_true) + 0.1 * torch.randn((m,), generator=g, device=dev)
    return A, b


def est_sparse(dev) -> dict:
    """Phase 12 (d): ``SparseLeastSquares`` at LIBSVM E2006-tfidf's shape,
    ``SPARSE_ITERS`` FISTA iterations in float32 held against the same run in
    float64 on the card (``SPARSE_HOLD``; α 1% high the control), ms an
    iteration against its bound: A's and Aᵀ's values and indices read once
    an iteration each at 3.35 TB/s."""
    import dataclasses

    import torch

    from fastoptsolver_tpu_torch.problems import SparseLeastSquares
    from fastoptsolver_tpu_torch.solvers import FISTAConfig, fista

    m, n = SPARSE_M, SPARSE_N
    A, b = sparse_problem(dev, m, n, SPARSE_DENSITY)
    p0 = SparseLeastSquares.create(A, b)
    del A
    a1 = float(0.1 * (p0.At @ b).abs().max())
    p = dataclasses.replace(p0, alpha1=p0.alpha1.new_tensor(a1))
    L = p.lipschitz()
    cfg = FISTAConfig(max_iter=SPARSE_ITERS)
    ms, res = cuda_ms(lambda: fista(p, cfg, L=L))
    p64 = SparseLeastSquares.create(p.A.to(torch.float64), b.double(), "lasso", a1,
                                    dtype=torch.float64)
    x64 = fista(p64, cfg, L=L.double()).x
    high = fista(dataclasses.replace(p, alpha1=p.alpha1 * 1.01), cfg, L=L).x
    reading = hold_reading(res.x, x64, p64.objective, p64.objective(x64))
    control = hold_reading(high, x64, p64.objective, p64.objective(x64))
    idx_bytes = p.A.col_indices().element_size()
    a_bytes = p.nnz * (4 + idx_bytes) + (m + 1) * idx_bytes
    at_bytes = p.nnz * (4 + idx_bytes) + (n + 1) * idx_bytes
    bound_ms = (a_bytes + at_bytes) / PEAK_BYTES_PER_S * 1e3
    it_ms = ms / SPARSE_ITERS
    out = dict(reading, control=control, limit=SPARSE_HOLD, m=m, n=n, nnz=p.nnz,
               density=p.density, ms=ms, ms_per_iter=it_ms, bound_ms_per_iter=bound_ms,
               pct_of_bound=100.0 * bound_ms / it_ms, nonzeros=int((res.x != 0).sum()))
    print(f"-- sparse {m} x {n}, {p.nnz} stored entries (density {p.density:.5f}), CSR with Aᵀ "
          f"its own CSR: {SPARSE_ITERS} FISTA iterations {ms:.3f} ms, {it_ms:.4f} ms an iteration "
          f"against the {bound_ms:.4f} ms bound ({out['pct_of_bound']:.1f}%) | against its "
          f"float64 run: rel gap {reading['rel_gap']:.3e}, rel |dx| {reading['rel_dx']:.3e}, "
          f"held at {SPARSE_HOLD}; control (α 1% high) {verdict(control, SPARSE_HOLD)} | "
          f"{out['nonzeros']} nonzeros in x")
    require(passes(reading, SPARSE_HOLD), f"sparse: {reading} beyond {SPARSE_HOLD}")
    require(not passes(control, SPARSE_HOLD), f"sparse: the control passes: {control}")
    return out


def piecewise_signal(dev, n: int):
    """A float32 piecewise-linear signal of ``n`` samples (8 segments of
    random level and slope, seed 3) plus N(0, 0.3²) noise, on the card."""
    import torch

    g = torch.Generator(device=dev).manual_seed(3)
    t = torch.arange(n, device=dev, dtype=torch.float32) / n
    knots = torch.sort(torch.rand((7,), generator=g, device=dev)).values
    seg = torch.bucketize(t, knots)
    level = torch.randn((8,), generator=g, device=dev)
    slope = 4.0 * torch.randn((8,), generator=g, device=dev)
    y = level[seg] + slope[seg] * (t - torch.cat([t.new_zeros(1), knots])[seg])
    return y + 0.3 * torch.randn((n,), generator=g, device=dev)


def est_genlasso(dev, A, b) -> dict:
    """Phase 12 (e): ``fused_lasso`` on the table (ρ the mean eigenvalue of
    AᵀA, α_fuse = α₁ = 0.1·‖Aᵀb‖∞, α_sparse = α₁/10), ``tv_denoise`` and
    ``trend_filter(order=2)`` on a piecewise signal of ``GENLASSO_N``
    samples at ``GENLASSO_LAM``, each in float32 held against its float64
    run on the card (``GENLASSO_HOLDS``), the penalty 1% high the control."""
    import numpy as np
    import torch

    from fastoptsolver_tpu_torch.solvers import (
        GenLassoConfig, difference_matrix, fused_lasso, trend_filter, tv_denoise)

    n = A.shape[1]
    a1 = float(0.1 * (A.T @ b).abs().max())
    rho = float(torch.trace(A.T @ A) / n)
    y = piecewise_signal(dev, GENLASSO_N)
    t = lambda v: torch.as_tensor(v, dtype=torch.float64, device=dev)
    D_fused = t(np.vstack([difference_matrix(n, 1, np.float64), np.eye(n)]))
    w_fused = t(np.concatenate([np.full(n - 1, a1), np.full(n, 0.1 * a1)]))
    A64, b64, y64 = A.double(), b.double(), y.double()
    Ds = {name: t(difference_matrix(GENLASSO_N, order, np.float64))
          for name, order in (("tv_denoise", 1), ("trend_filter", 2))}
    objective = {
        "fused_lasso": lambda x: (0.5 * ((A64 @ x - b64) ** 2).sum()
                                  + (w_fused * (D_fused @ x).abs()).sum()),
        **{name: (lambda x, name=name: 0.5 * ((x - y64) ** 2).sum()
                  + GENLASSO_LAM[name] * (Ds[name] @ x).abs().sum()) for name in Ds},
    }
    calls = {
        "fused_lasso": lambda s=1.0, dtype=torch.float32: fused_lasso(
            A, b, alpha_fuse=a1 * s, alpha_sparse=0.1 * a1 * s, config=GenLassoConfig(rho=rho),
            dtype=dtype),
        "tv_denoise": lambda s=1.0, dtype=torch.float32: tv_denoise(
            y, GENLASSO_LAM["tv_denoise"] * s, dtype=dtype),
        "trend_filter": lambda s=1.0, dtype=torch.float32: trend_filter(
            y, GENLASSO_LAM["trend_filter"] * s, order=2, dtype=dtype),
    }
    out = {}
    for name, call in calls.items():
        ms, res = cuda_ms(call)
        high = call(1.01)
        x64 = call(dtype=torch.float64).x
        f_of = objective[name]
        reading = hold_reading(res.x, x64, f_of, f_of(x64))
        control = hold_reading(high.x, x64, f_of, f_of(x64))
        limit = GENLASSO_HOLDS[name]
        steps = int(res.n_iters)
        out[name] = dict(reading, control=control, limit=limit, ms=ms, iters=steps,
                         converged=bool(res.converged), us_per_step=ms * 1e3 / steps)
        print(f"-- {name:12s} iters {steps} (converged {bool(res.converged)}) {ms:9.3f} ms "
              f"({ms * 1e3 / steps:8.3f} us a step, the eigh included) | against its float64 run: "
              f"rel gap {reading['rel_gap']:.3e}, rel |dx| {reading['rel_dx']:.3e}, held at "
              f"{limit}; control (penalty 1% high) {verdict(control, limit)}")
        require(bool(torch.isfinite(res.x).all()), f"{name}: x not finite")
        require(passes(reading, limit), f"{name}: {reading} beyond {limit}")
        require(not passes(control, limit), f"{name}: the control passes: {control}")
    return out


def estimators_path(dev, mods, iid_cv_ms=None) -> dict:
    """Phase 12: the estimator surface on phase 11's AR(1) table, moved once
    to NumPy float64 as a user's table arrives: the CV estimators through the
    burst kernel (the only launches of the phase), the plain estimators, the
    problem families, a sparse problem and the generalized lasso."""
    import torch

    t0 = time.perf_counter()
    A, b = ar1_problem(dev, SOLVE_M, SOLVE_N, SOLVE_RHO)
    X, y = A.double().cpu().numpy(), b.double().cpu().numpy()
    perm = torch.randperm(SOLVE_M, generator=torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    secs = {}
    cv_out = est_cv(dev, mods, A, b, X, y, perm, iid_cv_ms)
    torch.cuda.empty_cache()
    secs["cv"] = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(11)
    keep = torch.rand((SOLVE_N, 1), generator=g, device=dev) < 0.1
    W = torch.where(keep, 3.0 * torch.randn((SOLVE_N, 4), generator=g, device=dev), 0.0)
    Y = (A @ W + 9.0 * torch.randn((SOLVE_M, 4), generator=g, device=dev)).double().cpu().numpy()
    w = (0.5 + 1.5 * torch.rand((SOLVE_M,), generator=g, device=dev)).double().cpu().numpy()
    zero_counts(mods)
    parts = {}
    for name, run in (("plain", lambda: est_plain(dev, X, y, Y, w)),
                      ("families", lambda: est_families(dev, A, b)),
                      ("sparse", lambda: est_sparse(dev)),
                      ("genlasso", lambda: est_genlasso(dev, A, b))):
        t1 = time.perf_counter()
        parts[name] = run()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t1
    plain, fams, sparse, gl = (parts[k] for k in ("plain", "families", "sparse", "genlasso"))
    counts = {k: m.LAUNCHES for k, m in mods.items()}
    require(sum(counts.values()) == 0, f"phase 12 (b)-(e) launched kernels: {counts}")
    secs["all"] = time.perf_counter() - t0
    print(f"[12 estimators] AR(1) table ({SOLVE_M}, {SOLVE_N}), ρ = {SOLVE_RHO}: LassoCV "
          f"{cv_out['lassocv']['bursts']} bursts, ElasticNetCV {cv_out['enetcv']['bursts']} "
          f"bursts, burst launches {cv_out['lassocv']['launches'] + cv_out['enetcv']['launches']} "
          f"(every other engine 0), held against the torch driver and float64; {len(plain)} plain "
          f"estimators, {len(fams)} problem families, sparse at {SPARSE_M} x {SPARSE_N}, "
          f"{len(gl)} generalized-lasso solves held, every control refused | kernel launches "
          f"over (b)-(e) {counts} | {secs['all']:.1f} s (" + ", ".join(
              f"{k} {v:.1f}" for k, v in secs.items() if k != "all") + ")")
    return dict(cv=cv_out, plain=plain, families=fams, sparse=sparse, genlasso=gl, seconds=secs)


# ---- phase 13: the out-of-memory Gram path ----

def host_ram_gib() -> float:
    """Free host memory, GiB."""
    import os

    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / 2 ** 30


def stream_readings(chunks, gram, dev) -> dict:
    """One more pass over the chunks on the card, beside ``gram`` (the
    streamed reduction): per chunk the f32 products as ``stream_gram`` forms
    them, summed exactly in float64 (with Σ|product|, the unit of one
    rounding) and plainly in f32 (the first control); the products of the
    chunk rounded to TF32 (a 10-bit mantissa, as a TF32 matmul reads it)
    summed with ``stream_gram``'s Kahan step (the second control); and the
    float64 reduction. Readings: ``acc``, the largest |stored − exact| over
    Q, c and bᵀb in units of 2⁻²⁴·Σ|products|; ``rel``, the largest relative
    error of Q (Frobenius), c and bᵀb against the float64 reduction."""
    import numpy as np
    import torch

    from fastoptsolver_tpu_torch.problems.streaming import DenseGram, _kahan

    n = gram.dim
    f32, f64 = torch.float32, torch.float64
    shapes = ((n, n), (n,), ())
    zeros = lambda dt: [torch.zeros(s, dtype=dt, device=dev) for s in shapes]
    exact, absum, ref = zeros(f64), zeros(f64), zeros(f64)
    plain, tf, tfc = zeros(f32), zeros(f32), zeros(f32)
    dQ = torch.empty((n, n), dtype=f32, device=dev)
    rows = 0
    for A_i, b_i in chunks:
        A = torch.from_numpy(np.ascontiguousarray(A_i, np.float32)).to(dev)
        b = torch.from_numpy(np.ascontiguousarray(b_i, np.float32)).to(dev)
        torch.matmul(A.T, A, out=dQ)
        for k, p in enumerate((dQ, torch.matmul(A.T, b), torch.dot(b, b))):
            p64 = p.double()
            exact[k].add_(p64)
            absum[k].add_(p64.abs())
            plain[k].add_(p)
        At, bt = round_tf32(A), round_tf32(b)
        for k, p in enumerate((At.T @ At, At.T @ bt, torch.dot(bt, bt))):
            _kahan(tf[k], tfc[k], p)
        del At, bt
        A64, b64 = A.double(), b.double()
        ref[0].addmm_(A64.T, A64)
        ref[1].add_(A64.T @ b64)
        ref[2].add_(torch.dot(b64, b64))
        rows += A.shape[0]
        del A, b, A64, b64

    def acc(stored):
        return max(float(((s.double() - e).abs() / (a * 2.0 ** -24).clamp_min(1e-300)).max())
                   for s, e, a in zip(stored, exact, absum))

    def rel(stored):
        return [float(torch.linalg.vector_norm(s.double() - r) / torch.linalg.vector_norm(r))
                for s, r in zip(stored, ref)]

    stored = (gram.Q, gram.c, gram.btb)
    out = dict(acc=acc(stored), acc_plain=acc(plain), rel=rel(stored), rel_plain=rel(plain),
               rel_tf32=rel(tf))
    g64 = DenseGram(Q=ref[0], c=ref[1], btb=ref[2],
                    m=torch.tensor(rows, dtype=torch.int64, device=dev))
    del exact, absum, plain, tf, tfc, dQ
    return out, g64


def stream_cell(dev, mods, m: int, n: int, rows: int, cut_from) -> dict:
    """Phase 13 at one shape: ``streaming_lasso.measure`` (the pass and the
    certified solve, timed), the Gram held against the float64 reduction of
    the same chunks between its controls, the f32 x against
    ``fista_gram_dense`` in float64 on the float64 Gram with an α₁-1%-high
    control. No hand-written kernel is on this path: every count stays 0."""
    import torch

    from fastoptsolver_tpu_torch.bench import streaming_lasso
    from fastoptsolver_tpu_torch.problems import generator_chunks
    from fastoptsolver_tpu_torch.solvers import DenseGramConfig, fista_gram_dense
    from fastoptsolver_tpu_torch.solvers.gram_dense import _rel_gap_dense

    t0 = time.perf_counter()
    ram = host_ram_gib()
    require(ram > 1.5 * m * n * 4 / 2 ** 30 + 8,
            f"streaming {m} x {n}: {ram:.1f} GiB of host RAM free, too little for A")
    zero_counts(mods)
    run = streaming_lasso.measure(m, n, rows, STREAM_TOL, device=dev)
    torch.cuda.synchronize()
    counts = {k: mod.LAUNCHES for k, mod in mods.items()}
    require(sum(counts.values()) == 0, f"phase 13 launched kernels: {counts}")
    rec = run.record
    if cut_from is None:
        chunks = run.chunks
    else:  # the cut cell's check pass makes its chunks anew from the same seeds
        make_chunk, n_chunks = streaming_lasso.make_chunks(m, n, rows)
        chunks = generator_chunks(make_chunk, n_chunks)
    gram = run.gram
    t1 = time.perf_counter()
    readings, g64 = stream_readings(chunks, gram, dev)
    del chunks
    check_s = time.perf_counter() - t1
    rel = max(readings["rel"])
    rel_tf32 = max(readings["rel_tf32"])
    acc_ok = readings["acc"] <= STREAM_ACC_HOLD
    rel_ok = rel <= STREAM_REL_HOLD
    require(int(g64.m) == int(gram.m) == m, f"streaming: {int(gram.m)} rows reduced, not {m}")
    cfg64 = DenseGramConfig(max_iter=20000, check_every=100, rel_gap_tol=1e-12)
    r64 = fista_gram_dense(g64, run.alpha1, 0.0, cfg64)
    r_high = fista_gram_dense(g64, run.alpha1 * 1.01, 0.0, cfg64)
    require(bool(r64.converged) and bool(r_high.converged),
            f"streaming: the float64 solves did not certify at 1e-12 "
            f"({float(r64.rel_gap):.3e}, {float(r_high.rel_gap):.3e})")
    a1 = run.alpha1

    def f64_objective(x):
        return (0.5 * (x @ (g64.Q @ x)) - g64.c @ x + 0.5 * g64.btb + a1 * x.abs().sum())

    f_ref = f64_objective(r64.x)
    x32 = run.result.x
    gap64 = float(_rel_gap_dense(g64.Q, g64.c, g64.btb, a1, 0.0, x32.double()))
    reading = hold_reading(x32, r64.x, f64_objective, f_ref)
    control = hold_reading(r_high.x, r64.x, f64_objective, f_ref)
    link = rec["link_ceiling_gbps"]
    a_bytes = m * n * 4
    pass_bound_s, pass_bound_by = max(
        (a_bytes / (link * 1e9), "the link"),
        ((2.0 * m * n * (n + 1)) / PEAK_F32_PER_S, "operations"))
    cut = "" if cut_from is None else f", m cut from {cut_from} (reduced)"
    print(f"[13 streaming] {m} x {n}{cut}: A {rec['a_gb']:.3f} GB in {rec['chunks']} "
          f"chunks of {rows} rows ({ram:.1f} GiB host RAM free), exceeds the card's memory: "
          f"{rec['exceeds_hbm']} | pass {rec['stream_s']:.3f} s = {rec['stream_gbps']:.3f} GB/s, "
          f"{rec['stream_pct_of_link']:.1f}% of the {link:.3f} GB/s pinned link ceiling; host "
          f"cast into pinned memory {rec['host_copy_gbps']:.3f} GB/s; the pass's bound "
          f"{pass_bound_s:.3f} s by {pass_bound_by} | Q, c, bᵀb: accumulation "
          f"{readings['acc']:.3f} units of 2^-24·Σ|products| (limit {STREAM_ACC_HOLD}; plain f32 "
          f"control {readings['acc_plain']:.3f}, "
          f"{'refused' if readings['acc_plain'] > STREAM_ACC_HOLD else 'PASSES'}), against "
          f"float64 Q/c/bᵀb {readings['rel'][0]:.3e}/{readings['rel'][1]:.3e}/"
          f"{readings['rel'][2]:.3e} (limit {STREAM_REL_HOLD}; TF32 control "
          f"{readings['rel_tf32'][0]:.3e}/{readings['rel_tf32'][1]:.3e}/"
          f"{readings['rel_tf32'][2]:.3e}, {'refused' if rel_tf32 > STREAM_REL_HOLD else 'PASSES'}"
          f"; plain f32 {max(readings['rel_plain']):.3e})")
    print(f"-- solve: {rec['solve_iters']} iterations in {rec['solve_s'] * 1e3:.3f} ms (the "
          f"power loop and the float64 up-cast {rec['solve_setup_s'] * 1e3:.3f} ms of it), rel "
          f"gap {rec['rel_gap']:.3e} on the f32 triple, converged {rec['converged']}; the same x "
          f"on the float64 Gram {gap64:.3e}; {rec['solve_us_per_iter']:.3f} µs an iteration "
          f"against {rec['solve_bound_us_per_iter']:.3f} µs ({rec['solve_bound_by']}) "
          f"| x against float64 (r64 {int(r64.iters)} iterations, gap {float(r64.rel_gap):.1e}): "
          f"{verdict(reading, STREAM_X_HOLD)} at {STREAM_X_HOLD}; control (α₁ 1% high) "
          f"{verdict(control, STREAM_X_HOLD)} | nnz {rec['nnz_frac']:.4f} | kernel launches "
          f"{counts} | check pass {check_s:.1f} s, cell {time.perf_counter() - t0:.1f} s")
    # the reference's shape certifies at 1e-6; at n = 10000 the f32 certificate
    # stalls near 2e-6 (the f32 rounding of x and of the stored triple; the same x
    # reads about as high on the float64 Gram), while its objective is within the
    # x hold's limit of the float64 optimum: reported there, held by the x hold and
    # the float64 recheck's 1e-4 of phases 4-9
    require(rec["converged"] or cut_from is not None,
            f"streaming {m} x {n}: the f32 solve did not certify")
    require(gap64 <= 1e-4, f"streaming {m} x {n}: float64 recheck {gap64:.3e} > 1e-4")
    require(acc_ok, f"streaming {m} x {n}: accumulation {readings['acc']:.3f} units > "
            f"{STREAM_ACC_HOLD}")
    require(readings["acc_plain"] > STREAM_ACC_HOLD,
            "streaming: the plain-accumulation control passes the accumulation hold")
    require(rel_ok, f"streaming {m} x {n}: Gram error {rel:.3e} > {STREAM_REL_HOLD}")
    require(rel_tf32 > STREAM_REL_HOLD, "streaming: the TF32 control passes the Gram hold")
    require(passes(reading, STREAM_X_HOLD), f"streaming {m} x {n}: x {reading} beyond "
            f"{STREAM_X_HOLD}")
    require(not passes(control, STREAM_X_HOLD),
            f"streaming: the α₁-high control passes the x hold: {control}")
    keep = {k: rec[k] for k in rec}
    del run, gram, g64, r64, r_high
    torch.cuda.empty_cache()
    return dict(keep, launches=counts, pass_bound_s=pass_bound_s, pass_bound_by=pass_bound_by,
                f64_gap_of_f32_x=gap64,
                readings=readings, x_hold=reading, x_control=control, limits=dict(
                    acc=STREAM_ACC_HOLD, rel=STREAM_REL_HOLD, x=STREAM_X_HOLD),
                check_s=check_s, host_ram_free_gib=ram, reduced=None if cut_from is None
                else f"m {cut_from} -> {m}")


def streaming_path(dev, mods) -> dict:
    """Phase 13: the streamed Gram and its certified solve at each shape."""
    t0 = time.perf_counter()
    cells = [stream_cell(dev, mods, *shape) for shape in STREAM_CELLS]
    print(f"-- phase 13 {time.perf_counter() - t0:.1f} s")
    return {f"{c['m']}x{c['n']}": c for c in cells}


# ---- phase 14: the A/B harness, disk checkpoints, the host runtime, a trace ----

def ablate_runtime_path(dev, mods, disk: dict) -> dict:
    """Phase 14: ``bench.ablate`` in interleaved trials (counted: every mode
    goes through its kernels), phase 9's disk round trip reported, the
    native host runtime and its loader feeding ``solve_lasso_batch``, and a
    ``utils.trace`` window around one routed solve."""
    import contextlib
    import io
    import os
    import tempfile

    import torch

    from fastoptsolver_tpu_torch import runtime
    from fastoptsolver_tpu_torch.batch import BatchFISTAConfig, solve_lasso_batch
    from fastoptsolver_tpu_torch.bench import ablate, headline
    from fastoptsolver_tpu_torch.utils import trace

    t0 = time.perf_counter()
    out = {}
    calls = 1 + 3 * 25  # ablate's warm call and its default trials × reps
    for label, argv in (("fixed", ["--mode", ABLATE_MODES]),
                        ("restart", ["--restart", "--mode", "routed,fused1"])):
        zero_counts(mods)
        with contextlib.redirect_stdout(io.StringIO()):
            recs = ablate.main([*argv, "--batch", str(ABLATE_BATCH)])
        torch.cuda.synchronize()
        counts = {k: mod.LAUNCHES for k, mod in mods.items()}
        modes = [r["mode"] for r in recs]
        want = dict(counts, fused=calls * sum(md in ("routed", "fused1") for md in modes),
                    gram=2 * calls * sum(md in ("burst", "adaptive", "build-only")
                                         for md in modes),
                    resident=calls * ("adaptive" in modes), stream=0, qstream=0)
        require(counts == want and ("burst" not in modes or counts["burst"] % calls == 0
                                    and counts["burst"] > 0)
                and ("burst" in modes or counts["burst"] == 0),
                f"ablate {label}: launches {counts}, want {want} and bursts a multiple of {calls}")
        for r in recs:
            require(r["converged"] == ABLATE_BATCH or r["mode"] == "build-only",
                    f"ablate {label} {r['mode']}: {r['converged']}/{ABLATE_BATCH} certified")
            print(f"-- ablate {label} {r['mode']}: {r['ms']:.3f} ms a solve (best trial; trials "
                  f"{[round(t, 3) for t in r['trial_ms']]}), {r['inst_per_s_M']:.2f} M "
                  f"certified/s" + (f", iters median {r['iters_median']} max {r['iters_max']}"
                                    if "iters_max" in r else ""))
        print(f"[14 ablate] {label}: modes {modes} at B = {ABLATE_BATCH}, 3 interleaved trials "
              f"of 25 solves after a warm one; launches {counts}")
        out[label] = dict(records=recs, launches=counts)

    print(f"[14 checkpoint] phase 9's 100-iteration FusedSolveState through "
          f"save_pytree/restore_pytree ({disk['bytes'] / 1e6:.3f} MB .npz), resumed to 1000: "
          f"bit-equal to the straight run {disk['same']}")
    out["checkpoint"] = disk

    lib = runtime.ensure_built()
    require(runtime.native_available() and lib is not None,
            "the native host runtime did not build (g++)")
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)
    zero_counts(mods)
    loaded = []
    t1 = time.perf_counter()
    for A, b in runtime.ScenarioLoader(seed=0, batch=LOADER_BATCH, m=1000, n_batches=3):
        At, bt = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
        a1 = 0.1 * torch.einsum("bmi,bm->bi", At, bt).abs().amax(1)
        res = solve_lasso_batch(At, bt, a1, 0.0, cfg=cfg)
        loaded.append((int(res.converged.sum()), int(res.failed.sum())))
    torch.cuda.synchronize()
    loader_s = time.perf_counter() - t1
    counts = {k: mod.LAUNCHES for k, mod in mods.items()}
    require(counts == dict(counts, fused=3) and sum(counts.values()) == 3,
            f"loader: launches {counts} (want fused 3)")
    require(all(c == LOADER_BATCH and f == 0 for c, f in loaded),
            f"loader: certified/failed per batch {loaded}")
    print(f"[14 runtime] native library {runtime.host._lib_path().name} (version "
          f"{lib.fastopt_version()}); ScenarioLoader 3 batches of {LOADER_BATCH} x 1000 x 5 "
          f"(native generation, standardised) into solve_lasso_batch: certified/failed "
          f"{loaded}, launches {counts}, {loader_s:.3f} s")
    out["runtime"] = dict(native=True, batches=loaded, launches=counts, seconds=loader_s)

    A, b, alpha1 = headline.build_problems(torch.Generator(device=dev).manual_seed(0),
                                           ABLATE_BATCH, 1000)
    solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg, feature_major=True)  # warm
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        zero_counts(mods)
        with trace(tmp) as prof:
            res = solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg, feature_major=True)
            torch.cuda.synchronize()
        counts = {k: mod.LAUNCHES for k, mod in mods.items()}
        files = [(f, os.path.getsize(os.path.join(tmp, f))) for f in os.listdir(tmp)]
    require(counts == dict(counts, fused=1) and sum(counts.values()) == 1,
            f"trace: launches {counts} (want fused 1)")
    require(len(files) == 1 and files[0][1] > 0, f"trace wrote {files}")

    def device_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return float(getattr(e, attr))
        return 0.0

    events = sorted(prof.key_averages(), key=device_us, reverse=True)
    top = [(e.key, round(device_us(e), 3), e.count) for e in events[:5] if device_us(e) > 0]
    print(f"[14 profile] trace() around one routed solve (B = {ABLATE_BATCH}, certified "
          f"{int(res.converged.sum())}): {files[0][1] / 1e6:.3f} MB Chrome trace, launches "
          f"{counts}; top device ops (µs, calls): {top if top else 'no device time in the trace'}")
    out["profile"] = dict(top_device_ops=top, trace_bytes=files[0][1], launches=counts)
    out["seconds"] = time.perf_counter() - t0
    print(f"-- phase 14 {out['seconds']:.1f} s")
    del A, b, alpha1, res
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    import fastoptsolver_tpu_torch  # noqa: F401  (numerics contract)
    from fastoptsolver_tpu_torch.batch import BatchFISTAConfig, solve_lasso_batch
    from fastoptsolver_tpu_torch.batch.fista_gram import _rel_gap, make_gram_batch
    from fastoptsolver_tpu_torch.bench import headline, stream as stream_mod
    from fastoptsolver_tpu_torch.bench.stream import measure_stream_ceiling, stream_pass_reference
    from fastoptsolver_tpu_torch.bench.wide_n import build_problems
    from fastoptsolver_tpu_torch.kernels import (
        _build, fista_vmem, fused_solve, gram_build, qstream, resident)
    from fastoptsolver_tpu_torch.kernels._common import (
        augmented_gram, make_matvec, power_lambda_max)
    from fastoptsolver_tpu_torch.kernels.fused_solve import (
        fused_solve_reference, solve_lasso_fused)

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"[1 device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.library()
    regs, entry = [], "?"
    for ln in _build.build_log.splitlines():  # name each "Used N registers" line
        if "Compiling entry function" in ln:
            entry = kernel_name(ln.split("'")[1])
        elif "registers" in ln:
            regs.append(f"{entry}: {ln.split(':', 1)[1].strip()}")
        elif "bytes spill stores" in ln and not ln.split("bytes spill stores")[0].split(",")[
                -1].strip() == "0":
            regs.append(f"{entry}: SPILLS {ln.strip()}")
    pairs_smem = _build.library().gram_pairs_smem_bytes()
    require(pairs_smem == gram_build._pairs_smem_bytes(),
            f"gram_pairs' ring is {pairs_smem} bytes, its Python mirror "
            f"{gram_build._pairs_smem_bytes()}")
    print(f"[2 build] {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s); "
          f"{len(regs)} kernels; gram_pairs ring {pairs_smem} bytes")
    for ln in regs:
        print(f"-- ptxas {ln}")

    # ---- 3: each kernel against its twin, on the card ----
    errs = {"fused": 0.0, "stream": 0.0}
    stream_widths = set()
    for i, (n, m, B) in enumerate(SMALL_SHAPES):
        A, b, a1 = small_problem(n, m, B, seed=i, device=dev)
        for mode, a2 in (("nesterov", 0.0), ("delta", 0.3)):
            cfg = BatchFISTAConfig(max_iter=1000, check_every=25,
                                   rel_gap_tol=1e-6, momentum=mode)
            res_k = solve_lasso_fused(A, b, a1, a2, cfg=cfg)
            torch.cuda.synchronize()
            res_t = fused_solve_reference(A, b, a1, a2, cfg=cfg)
            errs["fused"] = max(errs["fused"], compare_fused(
                res_k, res_t, cfg.check_every, f"{(n, m, B)} {mode}"))
        width = _build.library().stream_copy_bytes(B, A.data_ptr(), b.data_ptr())
        stream_widths.add(width)
        errs["stream"] = max(errs["stream"],
                             compare_stream(A, b, f"{(n, m, B)} {width}-byte loads"))
    require(stream_widths == {4, 16},
            f"SMALL_SHAPES reach the stream kernel's load widths {stream_widths}, not both")
    errs["fused"] = max(errs["fused"], check_fused_modes(dev))
    errs["gram"], widths = 0.0, set()
    for i, (n, m, B) in enumerate(BUILD_SHAPES):
        Ag, bg = small_problem(n, m, B, seed=20 + i, device=dev)[:2]
        width = _build.library().gram_pairs_copy_bytes(B, Ag.data_ptr(), bg.data_ptr())
        widths.add(width)
        errs["gram"] = max(errs["gram"], compare_build(Ag, bg, f"{(n, m, B)} {width}-byte copies"))
    require(widths == {4, 16}, f"BUILD_SHAPES reach gram_pairs' copy widths {widths}, not both")
    errs["burst"] = max(check_bursts(dev), check_burst_groups(dev))
    power_rel = check_power(dev)
    errs["resident"], adaptive = check_resident(dev)
    errs["qstream"] = check_qstream(dev)
    torch.cuda.empty_cache()
    print("[3 kernel vs twin] small shapes ok")

    m = 1000
    A, b, alpha1 = headline.build_problems(torch.Generator(device=dev).manual_seed(0), BATCH, m)
    torch.cuda.synchronize()
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)
    res_k = solve_lasso_fused(A, b, alpha1, 0.0, cfg=cfg)
    plain_ms, res_t = cuda_ms(lambda: fused_solve_reference(A, b, alpha1, 0.0, cfg=cfg))
    bench_dx, bench_dobj = compare_fused_bench(A, b, alpha1, res_k, res_t,
                                               cfg.check_every)
    del res_t
    errs["stream"] = max(errs["stream"], compare_stream(A, b, f"bench (5, {m}, {BATCH})"))
    stream_plain_ms, _ = cuda_ms(lambda: stream_pass_reference(A, b), reps=3)
    kernel_ms = headline.kernel_ms(A, b, alpha1, cfg)  # the launch alone, no host set-up
    torch.cuda.empty_cache()
    print("[3 kernel vs twin] bench shape ok")

    # the wide-n shape: made once, reused by phase 6
    Aw, bw, a1w = build_problems(torch.Generator(device=dev).manual_seed(0), WIDE_B,
                                 2 * WIDE_N, WIDE_N)
    wide = f"({WIDE_N}, {2 * WIDE_N}, {WIDE_B})"
    # λ at 1e-3 here: among 54144 lanes a few have near-degenerate top
    # eigenvalues, where 96 power steps have not converged and the estimate
    # follows the Gram's last-bit rounding; 1e-3 is well inside L's 1.02 margin
    errs["gram"] = max(errs["gram"], compare_build(Aw, bw, f"wide-n {wide}", lam_tol=1e-3))
    torch.cuda.empty_cache()
    gbw = gram_build.make_gram_batch_fused(Aw, bw, a1w, 0.0)
    fixed = BatchFISTAConfig(max_iter=100, check_every=0)
    rk = fista_vmem.fista_gram_vmem(gbw, fixed)
    torch.cuda.synchronize()
    rt = fista_vmem.fista_gram_vmem_reference(gbw, fixed)
    dx = float((rk.x - rt.x).abs().max())
    print(f"-- burst wide-n {wide} nesterov check_every=0 max_iter=100: max|dx|={dx:.3e}")
    require(bool(torch.allclose(rk.x, rt.x, rtol=2e-4, atol=2e-5)),
            "burst kernel disagrees with its twin at the wide-n shape")
    errs["burst"] = max(errs["burst"], dx)
    del rk, rt
    print("[3 kernel vs twin] wide-n shape ok")

    # ---- 4: the main path, counted ----
    mods = {"fused": fused_solve, "stream": stream_mod, "gram": gram_build,
            "burst": fista_vmem, "resident": resident, "qstream": qstream}
    zero_counts(mods)
    res = solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg, feature_major=True)
    torch.cuda.synchronize()
    counts = {k: m.LAUNCHES for k, m in mods.items()}
    launches = {"fused": fused_solve.LAUNCHES}
    require(counts == dict(counts, fused=1) and sum(counts.values()) == 1,
            f"main path: launches {counts} (want fused 1, every other 0)")
    require(bool(torch.equal(res.x, res_k.x)), "main path result differs from the kernel's")
    n_conv = int(res.converged.sum())
    n_failed = int(res.failed.sum())
    max_gap = float(res.rel_gap.max())
    require(res.x.shape == (BATCH, 5) and bool(torch.isfinite(res.x).all()),
            "main path x is not finite of shape (B, 5)")
    require(n_conv == BATCH and n_failed == 0 and max_gap <= 1e-6,
            f"main path: {n_conv}/{BATCH} certified, {n_failed} failed, "
            f"max rel_gap {max_gap:.3e}")
    g = torch.Generator(device=dev).manual_seed(1)
    idx = torch.randperm(BATCH, generator=g, device=dev)[:4096]
    A64 = A[:, :, idx].double().permute(2, 1, 0)
    gb64 = make_gram_batch(A64, b[:, idx].double().T, alpha1[idx].double(), 0.0,
                           L=torch.ones(idx.numel(), dtype=torch.float64, device=dev))
    gap64 = float(_rel_gap(gb64, res.x[idx].double().T).max())
    del A64, gb64
    require(gap64 <= 1e-4, f"float64 recheck: max rel_gap {gap64:.3e} > 1e-4")
    stream_mod.LAUNCHES = 0
    ceil_first = measure_stream_ceiling(A, b, reps=3, trials=1)["stream_ceiling_gbps"]
    launches["stream"] = stream_mod.LAUNCHES
    require(launches["stream"] > 0, "the read-ceiling measurement launched no stream kernel")
    print(f"[4 main path] fused launches {launches['fused']}, certified "
          f"{n_conv}/{BATCH}, failed {n_failed}, max rel_gap {max_gap:.3e}, f64 "
          f"recheck max rel_gap {gap64:.3e} on 4096 lanes | read ceiling "
          f"{ceil_first:.1f} GB/s, stream launches {launches['stream']}")

    # ---- 5: times; these launches are not counted above ----
    # the ceiling, one torch call for its sums and the solve in turns, by the
    # headline's measurement (bench/headline.py)
    meas = headline.measure(A, b, alpha1, cfg, reps=1, trials=5, ceiling_reps=3,
                            beside=lambda: [A.sum(dim=(0, 1)) + b.sum(dim=0)
                                            for _ in range(3)])
    require(meas["converged"] == BATCH and meas["failed"] == 0,
            f"timed solve: {meas['converged']}/{BATCH} certified, {meas['failed']} failed")
    solve_ms = [ms for trial in meas["trial_ms"] for ms in trial]
    ceil_gbps = meas["ceilings_gbps"]
    lib_ms = [ms / 3 for ms in meas["beside_ms"]]
    res = meas["result"]
    t_solve = median(solve_ms) / 1e3
    ceil = median(ceil_gbps)
    bytes_in = (A.numel() + b.numel()) * A.element_size()
    stream_ms = bytes_in / (ceil * 1e9) * 1e3
    iters = res.iters.float()
    print(f"[5 times] solve {t_solve * 1e3:.3f} ms ({BATCH / t_solve:.4g} certified "
          f"instances/s) | stream ceiling {ceil:.1f} GB/s | pct_of_achievable "
          f"{100.0 * bytes_in / t_solve / 1e9 / ceil:.1f} | fused kernel alone "
          f"{kernel_ms:.3f} ms ({bytes_in / kernel_ms / 1e6:.1f} GB/s, "
          f"{100.0 * bytes_in / kernel_ms / 1e6 / ceil:.1f}% of the ceiling) | plain twin solve "
          f"{plain_ms:.1f} ms | plain read (torch sums) "
          f"{bytes_in / stream_plain_ms / 1e6:.1f} GB/s | iters median "
          f"{int(iters.median())} max {int(iters.max())} | solve ms trials "
          f"{[round(x, 3) for x in solve_ms]}")
    if plain_ms < t_solve * 1e3:
        print("-- the plain twin is faster than the kernel at this shape")
    bounds = {"fused": fused_bound(A, res, cfg),
              "stream": bound(bytes_in + 4 * BATCH, A.numel() + b.numel())}
    # one reduction over A's planes and rows and one over b's rows: the
    # library's way to the stream kernel's per-lane sums, timed in the loop above
    stream_lib_ms = median(lib_ms)
    print(f"-- bounds: fused {bounds['fused'][0]:.3f} ms by {bounds['fused'][1]}, stream "
          f"{bounds['stream'][0]:.3f} ms by {bounds['stream'][1]}; medians of 5 in turns: "
          f"torch sums of A and b {stream_lib_ms:.3f} ms vs the stream kernel "
          f"{stream_ms:.3f} ms | trials torch sums {[round(x, 3) for x in lib_ms]} stream "
          f"{[round(bytes_in / g / 1e6, 3) for g in ceil_gbps]}")

    # ---- 6: the wide-n path (two-kernel), counted, then timed ----
    from fastoptsolver_tpu_torch.batch import solve_gram_batch
    from fastoptsolver_tpu_torch.batch.fista_gram import fista_gram_batch

    del res
    torch.cuda.empty_cache()
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)
    zero_counts(mods)
    res = solve_lasso_batch(Aw, bw, a1w, 0.0, cfg=cfg, feature_major=True)
    torch.cuda.synchronize()
    bursts = int(res.n_iters_total) // cfg.check_every
    counts = {k: m.LAUNCHES for k, m in mods.items()}
    launches["gram"], launches["burst"] = gram_build.LAUNCHES, fista_vmem.LAUNCHES
    require(counts == dict(counts, gram=2, burst=bursts)
            and sum(counts.values()) == 2 + bursts,
            f"wide-n path: launches {counts} (want build 2, burst {bursts} = bursts, "
            "every other 0)")
    n_conv, n_failed = int(res.converged.sum()), int(res.failed.sum())
    max_gap = float(res.rel_gap.max())
    require(res.x.shape == (WIDE_B, WIDE_N) and bool(torch.isfinite(res.x).all()),
            "wide-n x is not finite of shape (B, n)")
    # In f32 this configuration certifies ~85% of its lanes at 1e-6 within
    # max_iter, in the reference too (its driver 222/256 and burst kernel
    # 221/256 on its own recipe): the other lanes stall at a gap of 1-3e-6,
    # the f32 floor, while a float64 solve certifies every lane within 125
    # iterations. So: no lane fails, every certified lane is at <= 1e-6,
    # every lane is within 1e-5, and at least 80% certify.
    gap_ok = float(res.rel_gap[res.converged].max()) if n_conv else float("inf")
    require(n_conv >= 0.8 * WIDE_B and n_failed == 0 and gap_ok <= 1e-6
            and max_gap <= 1e-5,
            f"wide-n path: {n_conv}/{WIDE_B} certified, {n_failed} failed, "
            f"max rel_gap {max_gap:.3e} ({gap_ok:.3e} on certified lanes)")
    idx = torch.randperm(WIDE_B, generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)[:4096]
    gb64 = make_gram_batch(Aw[:, :, idx].double().permute(2, 1, 0), bw[:, idx].double().T,
                           a1w[idx].double(), 0.0,
                           L=torch.ones(idx.numel(), dtype=torch.float64, device=dev))
    gap64w = float(_rel_gap(gb64, res.x[idx].double().T).max())
    del gb64
    require(gap64w <= 1e-4, f"wide-n float64 recheck: max rel_gap {gap64w:.3e} > 1e-4")
    res_g = solve_gram_batch(gbw, cfg)
    require(bool(torch.equal(res_g.x, res.x)),
            "solve_gram_batch on the built Gram gives another x than solve_lasso_batch")
    iters_w = res.iters.float()
    print(f"[6 wide-n path] n={WIDE_N} m={2 * WIDE_N} B={WIDE_B}: build launches "
          f"{launches['gram']}, burst launches {launches['burst']} = bursts {bursts}, "
          f"fused 0 | certified {n_conv}/{WIDE_B}, failed {n_failed}, max rel_gap "
          f"{max_gap:.3e} ({gap_ok:.3e} on certified lanes), f64 recheck max rel_gap {gap64w:.3e} on 4096 lanes | "
          f"solve_gram_batch x equal | iters median {int(iters_w.median())} max "
          f"{int(iters_w.max())}")
    del res_g

    build_ms, build_trials, _ = med_ms(lambda: gram_build._launch(Aw, bw, 96))
    pairs_ms, pairs_trials, (Qw, cw, _, _) = med_ms(lambda: gram_build._launch(Aw, bw, 0))
    power_ms, _, _ = med_ms(lambda: gram_build._launch_power(Qw, cw, 96))
    # the library's function for the same λ_max, exact where the kernel runs 96
    # power steps: batched eigvalsh, about 1.3 ms a lane (a minute on all of
    # them), so timed on the first POWER_LIB_LANES lanes in turns with the
    # kernel on the same lanes (kernel, library, kernel)
    Qs = Qw[:, :, :POWER_LIB_LANES].contiguous()
    cs = cw[:, :POWER_LIB_LANES].contiguous()
    Qb = Qs.permute(2, 0, 1).contiguous()
    power_turns = []
    for fn in (lambda: gram_build._launch_power(Qs, cs, 96),
               lambda: torch.linalg.eigvalsh(Qb)[..., -1],
               lambda: gram_build._launch_power(Qs, cs, 96)):
        power_turns.append(cuda_ms(fn))
    power_lib_ms, lam_exact = power_turns[1]
    lam_dev = float(((power_turns[0][1] - lam_exact).abs() / lam_exact).max())
    power_at_lib_lanes_ms = (power_turns[0][0] + power_turns[2][0]) / 2
    del Qs, cs, Qb, lam_exact
    power_turns = [round(t[0], 3) for t in power_turns]
    build_plain_ms, _, _ = med_ms(lambda: gram_build.gram_build_reference(Aw, bw, 96))
    pairs_plain_ms, _, _ = med_ms(lambda: augmented_gram(Aw, bw))
    power_plain_ms, _, _ = med_ms(lambda: power_lambda_max(make_matvec(Qw, WIDE_N), cw, 96))
    del Qw, cw
    torch.cuda.empty_cache()
    burst_ms, burst_trials, res_k = med_ms(lambda: fista_vmem.fista_gram_vmem(gbw, cfg), 5)
    burst_plain_ms, _, res_t = med_ms(lambda: fista_vmem.fista_gram_vmem_reference(gbw, cfg))
    # the same bursts launched back to back, no host loop between them: the
    # solve's excess over this is the per-burst sync and bookkeeping
    rows, Xb, Yb, tb, psb = burst_inputs(gbw, cfg)
    betas_w = fista_vmem._beta_table(bursts * cfg.check_every, cfg).to(dev)

    def bursts_only():
        X, Y = Xb, Yb
        for i in range(bursts):
            X, Y, *_ = fista_vmem._launch_burst(
                betas_w, i * cfg.check_every, gbw.Q, gbw.c, rows["tau"], rows["thr"],
                rows["a2"], rows["a1"], rows["btb"], X, Y, tb, psb, None, rows["tau"],
                n_steps=cfg.check_every, with_gap=True)
        return X
    launches_ms, launches_trials, _ = med_ms(bursts_only, 5)
    # a launch with no step and no gap: the Gram's copy-in, the rows and the stores
    copy_ms, _, _ = med_ms(lambda: fista_vmem._launch_burst(
        betas_w, 0, gbw.Q, gbw.c, rows["tau"], rows["thr"], rows["a2"], rows["a1"],
        rows["btb"], Xb, Yb, tb, psb, None, rows["tau"], n_steps=0), 5)
    del rows, Xb, Yb
    group = _build.library().fista_burst_group(WIDE_N)
    group_smem = _build.library().fista_burst_smem_bytes(WIDE_N)
    compare_full_width(res_k, res_t, "burst wide-n certified run")
    del res_k, res_t
    wide_ms, wide_trials, _ = med_ms(lambda: solve_lasso_batch(Aw, bw, a1w, 0.0, cfg=cfg,
                                                               feature_major=True), 5)
    driver_ms, _, res_d = med_ms(lambda: fista_gram_batch(gbw, cfg))
    print(f"-- torch driver on the wide-n Gram: certified {int(res_d.converged.sum())}"
          f"/{WIDE_B}")
    # each launch copies every lane's Q from device memory once; each matvec (one
    # per iteration, one per gap) reads it from shared memory
    q_gb = gbw.Q.numel() * 4 / 1e9
    q_reads = int(res.n_iters_total) + bursts
    print(f"[6 times] build kernels {build_ms:.3f} ms (gram_pairs alone "
          f"{pairs_ms:.3f} ms, trials {[round(x, 3) for x in pairs_trials]}; gram_power "
          f"alone {power_ms:.3f} ms) vs twin {build_plain_ms:.3f} ms (pairs "
          f"{pairs_plain_ms:.3f}, power {power_plain_ms:.3f}) | "
          f"burst solve {burst_ms:.3f} ms ({bursts} bursts; the {bursts} launches back to "
          f"back {launches_ms:.3f} ms, so the host loop costs "
          f"{burst_ms - launches_ms:.3f} ms) vs twin {burst_plain_ms:.3f} ms | "
          f"routed solve_lasso_batch {wide_ms:.3f} ms ({n_conv / wide_ms * 1e3:.4g} "
          f"certified instances/s) | torch driver on the same Gram {driver_ms:.3f} ms | "
          f"trials build {[round(x, 3) for x in build_trials]} burst "
          f"{[round(x, 3) for x in burst_trials]} launches "
          f"{[round(x, 3) for x in launches_trials]} routed "
          f"{[round(x, 3) for x in wide_trials]}")
    print(f"-- burst kernel at n={WIDE_N}: {group} lanes a CTA, {group_smem} bytes of shared "
          f"memory; Q read from device memory once a launch, {q_gb:.3f} GB ({bursts * q_gb:.1f} "
          f"GB in all); a launch with no step (the copy-in) {copy_ms:.3f} ms = "
          f"{q_gb / copy_ms * 1e3:.1f} GB/s, {100.0 * bursts * copy_ms / launches_ms:.1f}% of "
          f"the launches; {q_reads} matvecs read Q from shared memory, "
          f"{q_reads * q_gb / launches_ms * 1e3:.1f} GB/s over the launches")

    nw, mw = WIDE_N, 2 * WIDE_N
    bounds["gram"] = bound(4 * (nw * mw * WIDE_B + mw * WIDE_B + nw * nw * WIDE_B
                                + nw * WIDE_B + 2 * WIDE_B),
                           WIDE_B * (mw * (nw + 1) * (nw + 2) + 96 * 2 * nw * nw))
    # gram_pairs alone: A and b read once, Q, c and bᵀb written once, its pair
    # sums; and what its CTAs stage from L2. gram_power: Q and c read once, λ
    # written, 96 matvecs
    pairs_work = gram_build._pairs_work(nw, mw, WIDE_B)
    bounds["pairs"] = bound(pairs_work["bytes"], pairs_work["flops"])
    bounds["power"] = bound(4 * (nw * nw * WIDE_B + nw * WIDE_B + WIDE_B),
                            WIDE_B * 96 * 2 * nw * nw)
    pairs_l2_gbps = pairs_work["l2_bytes"] / pairs_ms / 1e6
    # gram_power's matvecs read each lane's n² words from shared memory 96 times
    power_group = _build.library().gram_power_group(nw)
    power_smem = _build.library().gram_power_smem_bytes(nw)
    power_smem_read = 96 * nw * nw * WIDE_B * 4
    power_smem_gbps = power_smem_read / power_ms / 1e6
    power_floor_ms = smem_floor_ms(power_smem_read)
    bounds["burst"] = bound(4 * (nw * nw * WIDE_B + nw * WIDE_B + 6 * WIDE_B + nw * WIDE_B),
                            solve_ops(nw, WIDE_B * int(res.n_iters_total), cfg.check_every))
    gbw_q_bytes = gbw.Q.numel() * 4
    del gbw, res, res_d
    torch.cuda.empty_cache()
    Ab = torch.cat([Aw, bw[None]])
    del Aw, bw
    gram_lib_ms, _, _ = med_ms(lambda: torch.einsum("imb,jmb->ijb", Ab, Ab))
    del Ab
    torch.cuda.empty_cache()
    print(f"-- bounds: build {bounds['gram'][0]:.3f} ms by {bounds['gram'][1]}; gram_pairs "
          f"{bounds['pairs'][0]:.3f} ms by {bounds['pairs'][1]} against its {pairs_ms:.3f} ms "
          f"and the pair sums as one torch.einsum {gram_lib_ms:.3f} ms, its L2 reads "
          f"{pairs_work['l2_bytes'] / 1e9:.1f} GB at {pairs_l2_gbps:.1f} GB/s; gram_power "
          f"{bounds['power'][0]:.3f} ms by {bounds['power'][1]} against its {power_ms:.3f} ms; "
          f"burst solve {bounds['burst'][0]:.3f} ms by {bounds['burst'][1]}")
    print(f"-- gram_power at n={nw}: {power_group} lanes a CTA, {power_smem} bytes of shared "
          f"memory; its matvecs read {power_smem_read / 1e9:.1f} GB of Q from shared memory "
          f"at {power_smem_gbps:.1f} GB/s (the shared-memory floor {power_floor_ms:.3f} ms) | "
          f"the library's exact λ_max, batched torch.linalg.eigvalsh, in turns with the "
          f"kernel on the first {POWER_LIB_LANES} lanes (kernel, library, kernel): "
          f"{power_turns} ms; the kernel's 96 power steps within {lam_dev:.3e} of it")

    # ---- 7 and 8: the resident and Q-streaming paths, counted, then timed ----
    w1 = resident_path(dev, cfg, mods)
    torch.cuda.empty_cache()
    w2 = qstream_path(dev, cfg, mods)
    torch.cuda.empty_cache()

    # ---- 9: the fused kernel's other modes and its checkpoint, at the bench shape ----
    modes, disk = fused_modes_path(A, b, alpha1, dev, mods)
    del A, b, alpha1
    torch.cuda.empty_cache()

    # ---- 10: cross-validation through the burst kernel, counted, held, timed ----
    cv_out = cv_path(dev, mods)
    torch.cuda.empty_cache()

    # ---- 11: the single-problem layer: solve, solve_batch, compat, large lasso ----
    solve_out = solve_path(dev, mods)
    print("-- solve record " + json.dumps(solve_out))
    torch.cuda.empty_cache()

    # ---- 12: the estimators (the CV ones through the burst kernel), families ----
    est_out = estimators_path(dev, mods, cv_out["e2e_ms"])
    print("-- estimators record " + json.dumps(est_out, default=str))
    launches["burst"] += est_out["cv"]["lassocv"]["launches"] + est_out["cv"]["enetcv"]["launches"]
    torch.cuda.empty_cache()

    # ---- 13: the streamed Gram and its dense solve (no hand-written kernel) ----
    stream_out = streaming_path(dev, mods)
    print("-- streaming record " + json.dumps(stream_out, default=str))

    # ---- 14: the A/B harness, the disk checkpoint, the host runtime, a trace ----
    ab_out = ablate_runtime_path(dev, mods, disk)
    for part in ("fixed", "restart"):
        for k, v in ab_out[part]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for part in ("runtime", "profile"):
        launches["fused"] += ab_out[part]["launches"]["fused"]
    print("-- ablate record " + json.dumps(ab_out, default=str))

    kernels = [
        {"name": "fused_lasso_solve", "route": "cuda", "source": FUSED_SRC,
         "replaces": "fastoptsolver_tpu/kernels/fused_solve.py:120",
         "launches": launches["fused"], "max_abs_err": errs["fused"],
         "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bounds["fused"][0],
         "bound_by": bounds["fused"][1], "library_ms": None, "e2e_ms": t_solve * 1e3,
         "bench_max_abs_dx": bench_dx, "bench_max_rel_dobj": bench_dobj, "modes": modes},
        {"name": "stream_ceiling", "route": "cuda", "source": STREAM_SRC,
         "replaces": "fastoptsolver_tpu/bench/stream.py:30",
         "launches": launches["stream"], "max_abs_err": errs["stream"],
         "ms": stream_ms, "plain_ms": stream_plain_ms, "bound_ms": bounds["stream"][0],
         "bound_by": bounds["stream"][1], "library_ms": stream_lib_ms},
        {"name": "gram_build", "route": "cuda", "source": GRAM_SRC,
         "replaces": "fastoptsolver_tpu/kernels/gram_build.py:120",
         "launches": launches["gram"], "max_abs_err": errs["gram"],
         "ms": build_ms, "plain_ms": build_plain_ms, "bound_ms": bounds["gram"][0],
         "bound_by": bounds["gram"][1], "library_ms": gram_lib_ms,
         "pairs_ms": pairs_ms, "pairs_plain_ms": pairs_plain_ms,
         "pairs_bound_ms": bounds["pairs"][0], "pairs_bound_by": bounds["pairs"][1],
         "pairs_l2_gbps": pairs_l2_gbps, "pairs_library_ms": gram_lib_ms,
         "power_ms": power_ms, "power_plain_ms": power_plain_ms,
         "power_bound_ms": bounds["power"][0], "power_bound_by": bounds["power"][1],
         "power_group_lanes": power_group, "power_smem_bytes": power_smem,
         "power_smem_read_gbps": power_smem_gbps, "power_smem_floor_ms": power_floor_ms,
         "power_max_rel_dlam": power_rel, "power_library_ms": power_lib_ms,
         "power_library": "torch.linalg.eigvalsh(Q)[..., -1] (exact λ_max)",
         "power_library_lanes": POWER_LIB_LANES,
         "power_ms_at_library_lanes": power_at_lib_lanes_ms,
         "power_turns_ms": power_turns, "power_rel_to_exact": lam_dev},
        {"name": "fista_burst", "route": "cuda", "source": BURST_SRC,
         "replaces": "fastoptsolver_tpu/kernels/fista_vmem.py:92",
         "launches": launches["burst"], "max_abs_err": errs["burst"],
         "ms": burst_ms, "plain_ms": burst_plain_ms, "bound_ms": bounds["burst"][0],
         "bound_by": bounds["burst"][1], "library_ms": None, "e2e_ms": wide_ms,
         "driver_ms": driver_ms, "launches_only_ms": launches_ms, "group_lanes": group,
         "smem_bytes": group_smem, "q_bytes_per_launch": gbw_q_bytes, "copy_in_ms": copy_ms,
         "cv": cv_out, "estimators": est_out["cv"]},
        {"name": "resident_solve", "route": "cuda", "source": RESIDENT_SRC,
         "replaces": "fastoptsolver_tpu/kernels/resident.py:103",
         "also_replaces": "fastoptsolver_tpu/kernels/fista_vmem.py:897 (the adaptive "
                          "kernel: fista_gram_vmem_adaptive launches this kernel)",
         "launches": w1["launches"] + launches.get("resident", 0),
         "max_abs_err": errs["resident"], "ms": w1["ms"],
         "plain_ms": w1["plain_ms"], "bound_ms": w1["bound_ms"], "bound_by": w1["bound_by"],
         "library_ms": None, "plain_lanes": w1["plain_lanes"],
         "ms_at_plain_lanes": w1["ms_at_plain_lanes"], "e2e_ms": w1["e2e_ms"],
         "driver_ms": w1["driver_ms"], "copy_in_ms": w1["copy_in_ms"],
         **{k: w1[k] for k in ("group_lanes", "smem_bytes", "smem_read_gbps",
                               "lane_matvecs", "smem_floor_ms", "power_launch_ms",
                               "all_steps_ms", "cta_step_us")},
         "adaptive_entry": adaptive},
        {"name": "qstream_burst", "route": "cuda", "source": QSTREAM_SRC,
         "replaces": "fastoptsolver_tpu/kernels/qstream.py:90",
         "launches": w2["launches"], "max_abs_err": errs["qstream"], "ms": w2["ms"],
         "plain_ms": w2["plain_ms"], "bound_ms": w2["bound_ms"], "bound_by": w2["bound_by"],
         "library_ms": None, "plain_lanes": w2["plain_lanes"],
         "ms_at_plain_lanes": w2["ms_at_plain_lanes"], "e2e_ms": w2["e2e_ms"],
         **{k: w2[k] for k in (
             "driver_ms", "cluster_size", "smem_bytes", "active_clusters",
             "q_bytes_per_launch", "copy_in_ms", "relayout_ms", "launches_only_ms",
             "smem_read_gbps", "q_sum_gbps", "bursts_ms_by_cluster_size", "streaming_ms",
             "cluster_ms")}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
