#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (qpalm_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases, each asserting, any failure exiting non-zero:
  1. environment: torch, CUDA, nvcc, the card's name and power limit, the
     host's LAPACK and BLAS (ldconfig);
  2. build: nvcc compiles the kernels under qpalm_tpu_torch/csrc/, g++ at
     the same time the native libraries of native/ (the C baselines,
     baseline_c.py; the sparse LDL', linalg/sparse_direct.py; the QPS
     reader, io/native.py);
  3. kernel K2 (batched Cholesky factor and solve) against its plain twin
     on a (512, 64, 64) SPD batch, the factor and the identity
     right-hand-side solve bit for bit;
  4. kernel K1 (the fused P-ALM loop) against its plain twin on one
     headline round (512 problems, n=64, m=96), the whole state bit for
     bit, plus a bit-identical rerun, and the split of the launch by the
     on-chip kernel's cycle counters with the cycles an iteration;
  5. the slice: 4 headline rounds, each stack -> scale -> K1 -> unscale ->
     device polish (K2 inside) at 1e-6 -> the host rescue of the lanes it
     rejects (bench.rescue_round: the C solve, the host polish check,
     finish_np), then the host f64 referee on every certified lane.  Every
     lane of the 2048 must be certified.  The launch counters are zeroed
     just before and read just after, so they show which kernels the main
     path ran;
  6. the nonconvex front end: batch.solve_batch on the BOXQP-d rows of
     scripts/bench_nonconvex.py (n=64, m=80, B=256 and n=16, m=20, B=512,
     its f32 settings): LOBPCG gamma pins held against the f64 spectrum of
     the scaled Q, K1's nonconvex tier against its twin, stationarity of
     every solved lane, and at n=64 the split by the cycle counters;
  7. dual-objective termination at the headline shape, the limit at the
     median of phase 4's objectives: K1 against its twin, some lanes
     dual-terminated and some solved;
  8. host chunking (chunk=16 bit-identical to one launch) and a warm start
     (q scaled by 1.01, from phase 4's x and y; fewer iterations than cold)
     at the headline shape, K1 against its twin.
  Phases 6-8 each zero the counters before their solve_batch calls and
  read them after;
  9. K1's streaming tier forced (qa_panel > 0) at the headline shape
     against the on-chip K1 of phase 4 (statuses and |dx| at
     kernel_vs_plain's bars, iteration counts at STREAM_COUNT_BAR), and
     against its streaming twin;
 10. the streaming kernel at full width (randomQP n=352, B=128, the sweep's
     settings) against its twin for 30 iterations from the same state, held
     bit for bit (every sc row of every problem, x, the whole state), three
     launches of 10 iterations bit-identical to one of 30, the split of a
     streaming iteration by the kernel's own cycle counters (assembly,
     Gershgorin + Q, Cholesky panels and trailing updates, solves, the
     rest), and one nonconvex
     (BOXQP-d n=16) and one dual-terminating (phase 7's limit) streaming
     launch against the twin;
 11. the workloads sweep, all 15 rows of scripts/bench_workloads.py through
     qpalm_tpu_torch/sweep.py (f32 pass through batch.solve_batch, f64
     host polish, finisher),
     K1's counters zeroed before and read after: each streaming row runs
     the streaming kernel, each row certifies >= 99% of its lanes at 1e-6
     and the f64 referee agrees on every certified lane;
 12. the memory-plan probes (qpalm_tpu_torch/probe.py) at n in 128, 224,
     256, 352 with m = 1.5 n, B = 128, timed with their counters zeroed,
     then against their plain versions (rel err < 1e-5 scratch, < 1e-3
     assembly), the assembly beside two library calls: the einsum of its
     row sums (row_sums_ms, which does less work) and the einsum that forms
     M (library_ms);
 13. the bench, python -m qpalm_tpu_torch.bench's protocol in full (8
     rounds of 512 a rep, 5 reps, the rescue in its thread, the referee on
     every rep, the C baseline), its JSON line printed: every rep certified
     on every lane, 0 referee disagreements, a baseline divisor, and K1, K2a
     and K2b launched (counters zeroed before and read after);
 14. the general loop (solver/core.py) on the card: K2's f64 instantiation
     at (512, 64, 64) (the one-vector solve a warp a matrix), its
     global-memory plan (the cluster factor; the plan it picks printed) at
     f64 (128, 224, 224), f64 and f32 (64, 480, 480), the ragged f64
     (64, 477, 477) and f32 (37, 483, 483), and the f32 one-vector panel
     solve at (512, 64), factor and one-vector solve, then the global
     solve's identity right-hand sides at f32 (64, 480, 480), bit for bit
     against the twins, timed beside torch.linalg.cholesky and
     torch.cholesky_solve (each kernels-line row at the shape of the run
     whose launches it counts);
     the headline through the general loop at bench.py's f32 settings
     (use_fused="never", statuses and counts against phase 4's K1), at the
     default Settings() (f64, max_refine=3, eps 1e-4: every lane solved, x
     within 1e-3 of phase 5's certified solutions, and its first 32 lanes
     equal in status and count to the port's general loop on the CPU,
     |dx| <= 1e-8 and |dy| <= 1e-7 scaled) and at eps 1e-6 (x within
     1e-4); randomQP n=480 (past K1, the global plan) at the sweep's f32
     settings and at the defaults, each polished and retried as a sweep
     row and refereed (>= 99% certified, 0 referee disagreements);
     solve_batch_escalate at the headline with max_iter 20 (every
     re-solved lane solved, the f64 pass on the card); a time limit that
     cuts the solve (TIME_LIMIT_REACHED on the unfinished lanes, the
     finished ones unchanged); and the sweep's randomQP n=320 and 352 rows
     (B=64) through the general loop and through streaming K1, timed.  The
     K2 counters are zeroed before each solve and read after;
 15. K2's wide plans, at sizes the other plans do not take: the grid
     factor (the card's CTAs shared out over the matrices, a grid barrier
     a step) at f64 (1, 3640, 3640), f64 (2, 3640, 3640) and f32 (1, 7272,
     7272), the stripe solve (a CTA a stripe of a column) at f64 n = 14536
     and f32 n = 16392 (k = 1 and 2, R a random upper triangle with a
     dominant diagonal), each bit for bit against its twin run on the
     card, timed beside torch.linalg.cholesky and torch.cholesky_solve and
     its bound, the factor split by its cycle counters; the one-vector
     solve at f64 (1, 3640), the shape of the solve_batch below, in the
     stripe solve that solve_plan picks there and in the global solve
     that took it before, both bit for bit against the twin; then
     solve_batch at the default Settings() (f64, no cap on
     max_iter) on one randomQP n=3640 problem (m = n): solved, the f64
     referee holding its KKT residuals within the settings' eps, both wide
     kernels launched (the counters zeroed before and read after), its
     wall and K2's share of it (launches by kernel times their time);
 16. the single-problem front end (api.QPALM and solve, the KKT method,
     the MPC chain, large.solve_large_dense, diff.solve_diff) on the card,
     K2 at each run's shapes held bit for bit to its twins and timed first:
     (a) README.md's Quick start (solve, then QPALM cold, warm start,
     update_bounds, re-solve: all solved); (b) randomQP n=1024 m=1536
     (density 0.15, seed 0) at f64 Settings() through QPALM with SCHUR
     and with KKT (solved, the referee within eps, the grid factor and
     the stripe solve launched), the SCHUR x bit-identical with equal
     iterations to solve_batch([p]), bounds x 1.1 with a warm start
     (solved in fewer iterations), and a time limit that cuts the solve
     (TIME_LIMIT_REACHED); (c) SequentialMPC(6, 20) (n=340, m=580), a cold
     step and 25 warm-started steps, each solved, refereed at 1e-6 with
     |x| < 4, solves/s and the iteration p50 and max printed, the cluster
     factor and the global solve launched; (d) solve_large_dense on 3
     randomQP n=2048 m=3072 (every lane ok and refereed, the f32 grid
     factor and stripe solve launched, t_device_s and t_polish_s printed)
     and with device_polish=True at n=512 m=768 (every lane ok, the
     identity solve chol_solve_global_cols launched); (e) solve_diff at
     n=256 m=384 f64: the card's gradients against the CPU's within 1e-6
     relative or 4 kappa(K) eps of the backward system, central differences
     of 5 q and 5 bmax coordinates within 1e-4, a batch of 4 against four
     single calls, K2 launched in the backward pass.  Each run's counters
     are zeroed just before it and read just after; the kernels line's
     rows for the MPC's and the randomQP's K2 kernels carry the suffixes
     _mpc and _qpalm;
 17. the large sparse path: (a) K2 at the block-Jacobi shapes, (79, 64,
     64) f64 and f32 (n = 5000 in blocks of 64), factor and one-vector
     solve bit for bit against the twins and timed; (b) QPALM(sparse=True)
     at f64, eps 1e-6, on scripts/bench_sparse.py's CG class (n=5000,
     m=7000, seed SP_SEED) with Jacobi and with block-Jacobi (twice): each
     solved, the host f64 referee's stationarity and primal violation
     within SP_TOL, the two x within 1e-4, the peak of device memory a run
     adds under SP_MEM_MB, the two block-Jacobi runs' x bit-identical, K2
     launched by the block-Jacobi run (counters zeroed just before, read
     just after: the kernels line's rows _bjacobi), the sparse matvec
     bit-stable and beside torch's CSR product; (c) solve() on the same
     problem: the route solve_sparse_auto takes, the same as on the CPU,
     and on the card if it is CG; (d) CVXQP1_M and CONT-100A
     (benchmarks/qps_mm) through both QPS parsers (equal) and
     solve_sparse_auto (CVXQP1_M's published objective within 1e-5
     relative, both refereed), both native libraries loaded; (e)
     SequentialMPC(6, 20, backend="sparse"), a cold step and 10 warm
     steps, solved and refereed; (f) solve_batch(FACTORIZE_CG) on phase
     14's randomQP n=480 problems at f64 Settings(): solved, x within
     DEFAULT_X_BAR of the SCHUR run;
 18. the stage-structured path (parallel/, FACTORIZE_STAGE) at f64, eps
     1e-6, scaling 2: (a) QPALM with FACTORIZE_STAGE (block Thomas, K2 a
     stage) on the stage-permuted mpc_chain(10, 128) (nb 29, S 128, n
     3712) against the same problem under SCHUR (the grid factor): both
     solved, equal iterations, x within 1e-8; (b) SequentialMPC(6, 20),
     25 steps, stage-structured against unstructured: equal iterations at
     every step, the plant's states within 1e-8; (c) solve_mpc_stage_
     sharded on mpc_chain_stage_data(40, 256) (nb 119, S 256, n 30464)
     over LocalMesh(8), LocalMesh(4) and LocalMesh(1) (block Thomas, no
     interface): each solved, the host f64 referee's stage KKT residuals
     on the unscaled data within eps, iterations within ST_ITER_SPREAD,
     walls, ms an iteration and peak device memory; spike_solve with 3
     shards (the gathered interface) against block Thomas; (d) DistMesh at
     world size 1 over NCCL: spike_solve and the loop at horizon 32
     bit-identical to LocalMesh(1), solve_batch_sharded on 64 randomQPs
     n=64 lane for lane equal to solve_batch(use_fused="never") with its
     aggregates; the dry run (parallel/dryrun.py: data-parallel batches,
     SPIKE, the stage loop) over 2 gloo processes on the host's CPU
     against LocalMesh(2) and on the card over NCCL against LocalMesh(1),
     bit for bit.  Every K2 shape the phase launched is then held bit for
     bit to its twin and timed beside the library (chol.KERNEL_SHAPES,
     zeroed before each run and read after), the f64 warp solve also
     beside PR 15's entry kernel (qp_chol_solve kind 0) and at its other
     warps a block, each held bit for bit too; each run's K2 share is
     printed; the kernels line's rows _stage_* are (a)'s STAGE shapes,
     _spike_* (c)'s LocalMesh(8) shapes, _mesh1_* (c)'s LocalMesh(1)
     shapes, the warp solve's under PR 15's names (chol_solve_f64_*).
     Before it, every f64 warp-solve shape phases 3-17 launched
     (chol.KERNEL_SHAPES since the start) is held bit for bit to the
     twin;
 19. constraint sharding (parallel/schur.py): solve_constraint_sharded on
     randomQP n=512 m=8192 (seed 0, f64, eps 1e-6, SCHUR) over
     LocalMesh(1), LocalMesh(4) and LocalMesh(8), against the unsharded
     api.solve of the same problem: every run solved, iteration counts
     within CS_ITER_SPREAD of the unsharded, x within CS_X_BAR, the host f64
     referee within eps; walls, ms an iteration, K2 launches by shape and
     K2's share; every K2 shape the phase launched held bit for bit to its
     twin and timed beside the library (the kernels line's rows _schur_*);
     then K2b's entry plan at f32 (chol_solve_kernel<float>, (512, 61), one
     vector), which no path reaches, bit for bit against its twin and timed
     beside torch.cholesky_solve and its bound, printed on a line of its own.
  The host polish's native Bunch-Kaufman library (libqpalm_ldl) is
  required before phases 11 and 16 (d), so that no measured polish falls
  back to LU; phase 16 (d) prints the polish's route and splits t_polish_s
  into the polish and the finisher; phase 11 prints each row's C baseline
  (sweep.baseline_column) on a line before its row.

It prints a JSON line of the kernels' numbers, the nvidia-smi line, and as
its last line {"ok": true, "device": {...}} only when every phase passed.
There is no CPU fallback: without a CUDA device it exits non-zero.

`bound_ms` in the kernels line is the least time the card could take for
the work of the measured call: the larger of its operations over the peak
rate of their type (67 TFLOP/s float32, 34 TFLOP/s float64, both outside
the tensor cores) and its bytes (each input read once, each output written
once) over 3.35 TB/s, the H100 SXM's published peaks.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROUNDS = 4
B, N, M = 512, 64, 96  # the headline configuration (bench.py:74-76)
EPS_TARGET = 1e-6
# BOXQP-d rows (n, m, B) of scripts/bench_nonconvex.py:118, m = n + n/4,
# and its f32 settings (:119-121)
NC_ROWS = ((64, 80, 256), (16, 20, 512))
S_NC = dict(dtype="float32", nonconvex=True, eps_abs=1e-4, eps_rel=1e-4,
            max_iter=400, scaling=2, max_refine=0, verbose=False)
STREAM_T = 30  # iterations of the full-width streaming comparison
# phase 9: iteration counts the two tiers must share at the headline shape
# (of B = 512), the fewest two right implementations share there
STREAM_COUNT_BAR = 474
F32_PEAK = 67e12  # FLOP/s, float32 outside the tensor cores
F64_PEAK = 34e12  # FLOP/s, float64 outside the tensor cores
HBM_RATE = 3.35e12  # bytes/s
# phase 14: iteration counts the general loop must share with K1 at the
# headline shape and settings (of B = 512).  On the CPU
# (tools/tier_drift.py 512) the reference's own general loop and fused
# kernel share 478/512, the port's general loop and K1's twin 478, and
# the fewest that two right implementations share there is 474 (the port's
# twin and the reference's kernel); the bar leaves 1% of the lanes (5) for
# the card's other summation orders (cuBLAS, CUDA reductions)
GENERAL_COUNT_BAR = 469
REF_GENERAL_COUNTS = 478
TL_EPS = 1e-5  # phase 14's time-limited solve: some lanes floor at f32
# phase 14: how far the general loop's f64 x may sit from phase 5's
# certified solutions.  The defaults stop at residuals of 1e-4 (eps_abs =
# eps_rel = 1e-4): on the CPU the reference's own default solve of the
# 512 headline problems sits 5.8e-4 from their 1e-10 solutions, and the
# port's as far (python tools/default_gap.py), so the defaults are held at
# 1e-3 and an eps 1e-6 solve at 1e-4
DEFAULT_X_BAR, TIGHT_X_BAR = 1e-3, 1e-4
# phase 14's K2 comparisons: (label, B, n, dtype, the plans of the factor
# and of the solve, the kernels-line names of the factor and of the solve
# at this shape, and whether the right-hand sides are the identity, else
# one vector a matrix).  Each kernels-line row is timed at the shape of the
# phase-14 run whose launches it counts: the headline (512, 64) at
# Settings() for f64 in shared memory and at f32 for the one-vector panel
# solve, randomQP n=480 (64 problems) at f32 and f64 for the global plan.
# The identity at f32 (64, 480, 480), the device polish's explicit inverse
# at that n, has no row here: phase 16's device polish launches it, and
# its row is timed there.  f64 (128, 224) and the ragged shapes (n not a multiple of the cluster factor's 8-row
# tiles, a ragged last panel, rows of R not 16-byte aligned) are held to
# the twins without a row of their own.  Every shape's matrices come from
# one stream, so a shape is appended, never inserted.
K2_SHAPES = (
    ("f64 (512, 64)", 512, 64, "float64", ("smem", "warp"),
     ("chol_f64", "chol_solve_f64"), False),
    ("f64 (128, 224)", 128, 224, "float64", ("global", "global"),
     (None, None), False),
    ("f64 (64, 480)", 64, 480, "float64", ("global", "global"),
     ("chol_global_f64", "chol_solve_global_f64"), False),
    ("f32 (64, 480)", 64, 480, "float32", ("global", "global"),
     ("chol_global", "chol_solve_global"), False),
    ("f32 (512, 64)", 512, 64, "float32", ("smem", "panel"),
     (None, "chol_solve_vec"), False),
    ("f64 (64, 477)", 64, 477, "float64", ("global", "global"),
     (None, None), False),
    ("f32 (37, 483)", 37, 483, "float32", ("global", "global"),
     (None, None), False),
    ("f32 (64, 480, 480) identity", 64, 480, "float32", ("global", "global"),
     (None, None), True))
# phase 14: lanes of the headline at Settings() held on the card to the
# port's own general loop on the CPU, at the CPU tests' f64 bar
CPU_LANES = 32
WIDE_N, WIDE_B = 480, 64  # phase 14's randomQP row past K1
STREAM_ROWS = (320, 352)  # phase 14's STREAM_N_MAX rows, at WIDE_B
# phase 15: the wide plans just past the others' last n (f64 3632 and f32
# 7264 for the factor, f64 14528 and f32 16384 for the solve), as (B, n,
# dtype), the first of each dtype the kernels line's row (the f64 solve's
# row at (1, WIDE_QP_N), the shape whose launches it counts); and the
# randomQP n of its solve_batch run
WIDE_FACTORS = ((1, 3640, "float64"), (2, 3640, "float64"),
                (1, 7272, "float32"))
WIDE_SOLVES = ((14536, "float64"), (16392, "float32"))
WIDE_QP_N = 3640
# phase 16: the front end.  randomQP (n, m) at density 0.15, seed 0
# (benchmarks/RESULTS_large_single.md's protocol, its middle row); the MPC
# chain's warm steps (scripts/bench_mpc.py's defaults: 6 masses, horizon
# 20, 25 steps); solve_large_dense on FE_LARGE_B problems at that file's
# largest row and, with the device polish, at its smallest; solve_diff at
# (n, m)
FE_QP = (1024, 1536)
# phase 17: the large sparse path.  scripts/bench_sparse.py:57-62's CG
# class at its (n, m): Q = tridiag(-0.5, 2, -0.5), A random of density
# 5e-4 (random_state=1), its values, q and the bounds 1 + U(0, 1) drawn from
# default_rng(SP_SEED); cg_block SP_BLOCK (the default), so the
# block-Jacobi preconditioner hands K2 (ceil(n / 64), 64, 64); the peak of
# device memory a sparse solve may add (one dense n x n f64 is 200 MB); the
# sparse MPC's chain and warm steps
SP_N, SP_M, SP_SEED, SP_BLOCK = 5000, 7000, 17, 64
SP_MEM_MB = 64
SP_TOL = 1e-5  # the host referee's bar on stationarity and primal violation
SP_MPC, SP_MPC_STEPS = (6, 20), 10
CVXQP1_M_OPT = 1.0875116e6  # tests/test_maros.py:100
FE_MPC, FE_MPC_STEPS = (6, 20), 25
FE_LARGE, FE_LARGE_POLISH, FE_LARGE_B = (2048, 3072), (512, 768), 3
FE_DIFF = (256, 384)
FE_MPC_NPAD = 344  # FE_MPC's n = 340, padded to a multiple of 8
# phase 18: the stage-structured path at benchmarks/RESULTS_scaling.md's
# sizes and the reference tests' settings (eps 1e-6, scaling 2).  (a)
# QPALM, FACTORIZE_STAGE against SCHUR, on mpc_chain(*ST_QP) (nb 29, S
# 128, n 3712); (b) the closed-loop MPC ST_SEQ, ST_SEQ_STEPS steps; (c) the
# stage-sharded loop on mpc_chain_stage_data(*ST_CHAIN) (nb 119, S 256, n
# 30464) over LocalMesh(ST_MESH), LocalMesh(4) and LocalMesh(1), whose
# iteration counts may part by ST_ITER_SPREAD (SPIKE and block Thomas add
# in different orders; on the CPU the three are equal), and spike_solve's
# QR fallback at (S, nb, nd) = ST_SPIKE; (d) DistMesh(1) over NCCL: the
# loop at horizon ST_DIST_HORIZON and solve_batch_sharded on ST_DP = (B,
# n) randomQPs
ST_QP = (10, 128)
ST_SEQ, ST_SEQ_STEPS = (6, 20), 25
ST_CHAIN, ST_MESH, ST_ITER_SPREAD = (40, 256), 8, 3
ST_SPIKE = (48, 29, 3)
ST_DIST_HORIZON = 32
ST_DP = (64, 64)
# phase 19: one randomQP (CS_QP = (n, m), seed 0, A 33.5 MB at f64) with its
# constraint rows split over LocalMesh(k) for k in CS_MESHES, against the
# unsharded api.solve (SCHUR) of the same problem, at eps 1e-6: iteration
# counts within CS_ITER_SPREAD (the shards' partial sums add in another
# order; on the CPU LocalMesh(1) is bit-identical to the unsharded solve
# and the counts are equal), x within CS_X_BAR of the unsharded x, relative
# to max(1, |x|)
CS_QP = (512, 8192)
CS_MESHES = (1, 4, 8)
CS_ITER_SPREAD = 2
CS_X_BAR = 1e-6
# K2b's entry plan at f32 (chol_solve_kernel<float>: n not a multiple of 8),
# which no path of phases 3-19 reaches (their n are padded to multiples of
# 8), timed at (B, n) one vector
ENTRY_F32 = (512, 61)


def bound(flops, nbytes, peak=F32_PEAK):
    """bound_ms and bound_by of work of `flops` operations at `peak`
    FLOP/s that must move `nbytes` bytes."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def k1_bound(nb, n, m, iterations):
    """K1's bound for `iterations` counted iterations summed over nb
    problems of shape (n, m).  Per iteration: the Schur matrix A'WA, which
    is symmetric, so one triangle (m n (n + 1)), plus Q and I/gamma (n^2);
    its Cholesky (n^3 / 3), the two triangular solves, Qd and the Q x
    update (4 n^2), A'y and Ad (4 m n), the linesearch's 28 hinge sums
    (about 6 m each: each proposal's sums serve the next step too) and
    about 40 (n + m) elementwise.  Bytes: Q, A, the vectors and the state
    read once, the state written once."""
    per_iter = (m * n * (n + 1) + n * n + n ** 3 / 3 + 4 * n * n + 4 * m * n
                + 168 * m + 40 * (n + m))
    nbytes = 4 * nb * (n * n + m * n + 2 * n + 3 * m + 1
                       + 2 * (8 * n + 7 * m + 18))
    return bound(per_iter * float(iterations), nbytes)


def ptxas_summary(log):
    """{kernel entry: (registers, spill store bytes, spill load bytes)} from
    nvcc -Xptxas -v output."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            out[entry] = [0, 0, 0]
            continue
        if entry is None:
            continue
        for k, pattern in enumerate((r"Used (\d+) registers",
                                     r"(\d+) bytes spill stores",
                                     r"(\d+) bytes spill loads")):
            hit = re.search(pattern, line)
            if hit:
                out[entry][k] = int(hit.group(1))
    return out


KERNEL_NAMES = (("fused_palm_kernelILb1E", "K1 streaming (fused_palm_kernel"
                 "<true>)"), ("fused_palm_kernelILb0ELb0E", "K1 on chip"),
                ("fused_palm_kernelILb0ELb1E", "K1 on chip, profiled"),
                ("11chol_kernel", "K2a"),
                ("19chol_cluster_kernelIfLb0E", "K2a cluster f32"),
                ("19chol_cluster_kernelIfLb1E", "K2a cluster f32, profiled"),
                ("19chol_cluster_kernelIdLb0E", "K2a cluster f64"),
                ("19chol_cluster_kernelIdLb1E", "K2a cluster f64, profiled"),
                *((f"16chol_grid_kernelI{t}Li{b}ELb{pr}E",
                   f"K2a grid f{32 if t == 'f' else 64}, panels of {b}"
                   + (", profiled" if pr else ""))
                  for t in "fd" for b in (32, 64) for pr in (0, 1)),
                *((f"24chol_solve_stripe_kernelI{t}Li{w}E",
                   f"K2b stripe f{32 if t == 'f' else 64}, stripes of {w}")
                  for t in "fd" for w in (32, 64, 128)),
                ("23chol_solve_panel_kernel", "K2b blocked"),
                ("17chol_solve_kernel", "K2b entry by entry"),
                *((f"22chol_solve_warp_kernelIdLi{e}E",
                   f"K2b f64 warp solve, E = {e}") for e in range(1, 7)),
                ("24chol_solve_global_kernel", "K2b global"),
                ("assembly_probe_kernel", "assembly probe"),
                ("scratch_probe_kernel", "scratch probe"))


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def require(cond, msg):
    if not cond:
        fail(msg)


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps calls.  A warm-up of at
    least 0.2 s comes first (an idle card runs at a low clock and raises it
    under load), and the host queues the timed calls behind a 20 ms device
    sleep, so that they run back to back and the host's own time per call
    (the wrapper's checks, the launch) is not counted."""
    import torch

    warm_until = time.perf_counter() + 0.2
    while True:
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() > warm_until:
            break
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)  # clock cycles, about 20 ms
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(fn(), device milliseconds of that one call)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def kernel_vs_plain(F, sd, scal, st, s, label, qa_panel=-2):
    """K1 and its plain twin from the same state, in the tier `qa_panel`
    selects, held at these bars: statuses on all but 1%, iteration
    counts on all but 5%, |dx| < 1e-3 where both agree.  Returns (kernel
    outputs, twin outputs) as numpy and the numbers of the kernels line."""
    import numpy as np

    T = s.max_iter
    nb, n, _ = sd.Q.shape
    m = sd.A.shape[1]
    stream = F._tier(qa_panel, n, m) == "stream"
    out_k = F._finish(sd, scal, F.fused_palm(sd, scal, st, T, s, qa_panel))
    out_p, plain_ms = timed(lambda: F._finish(
        sd, scal, F.fused_palm_plain(sd, scal, st, T, s, stream)))
    k_np = [a.cpu().numpy() for a in out_k]
    p_np = [a.cpu().numpy() for a in out_p]
    st_eq = k_np[2] == p_np[2]
    it_eq = k_np[3] == p_np[3]
    both = st_eq & it_eq
    dx = float(np.abs(k_np[0] - p_np[0])[both].max())
    require(st_eq.sum() >= nb - -(-5 * nb // 512),
            f"{label}: K1 status equal on {st_eq.sum()}/{nb}")
    require(it_eq.sum() >= nb - -(-26 * nb // 512),
            f"{label}: K1 iterations equal on {it_eq.sum()}/{nb}")
    require(dx < 1e-3, f"{label}: K1 max|dx| {dx:.3e} on agreeing lanes")
    ms = cuda_ms(lambda: F.fused_palm(sd, scal, st, T, s, qa_panel), 3)
    say(f"[{label}] K1 ({'streaming' if stream else 'on-chip'}) vs twin: "
        f"status equal {st_eq.sum()}/{nb}, iterations equal "
        f"{it_eq.sum()}/{nb}, max|dx| {dx:.2e}; K1 {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms ({T} iterations)")
    return k_np, p_np, dict(max_abs_err=dx, ms=ms, plain_ms=plain_ms,
                            library_ms=None,
                            **k1_bound(nb, n, m, k_np[3].sum()))


def onchip_split(F, sd, scal, st, s, ms, label):
    """One profiled launch of the on-chip K1, its state held bit for bit to
    an unprofiled launch's; prints the split of `ms` by the kernel's cycle
    counters and the cycles an iteration (the blocks' loop cycles over
    their counted iterations; the terminating trip is not counted).
    Returns (split, cycles an iteration)."""
    import numpy as np

    T = s.max_iter
    ref = F.fused_palm(sd, scal, st, T, s)
    F.fused_palm.profile = []
    try:
        out = F.fused_palm(sd, scal, st, T, s)
        prof = F.fused_palm.profile[0].double().cpu()
    finally:
        F.fused_palm.profile = None
    require(all(np.array_equal(a.cpu().numpy(), b.cpu().numpy(),
                               equal_nan=True) for a, b in zip(out, ref)),
            f"{label}: the profiled launch's state differs from the "
            "unprofiled one's")
    split = F.profile_split(prof, ms)
    per_it = (prof.sum(0) / float(out.sc[:, F._ITER].sum())).tolist()
    names = list(split)[:-1]
    say(f"[{label} split] of {ms:.3f} ms by cycle counters: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / ms:.1f}%)" for k, v in split.items()))
    say(f"[{label} split] cycles an iteration: {per_it[-1]:.0f} "
        f"({per_it[-1] / 1980:.1f} us at the 1980 MHz SM clock): " + ", ".join(
            f"{k} {per_it[i]:.0f}" for i, k in enumerate(names))
        + f", rest {per_it[-1] - sum(per_it[:-1]):.0f}")
    return split, per_it[-1]


def stationary(p, x, y, tol=5e-3):
    """tests/test_fused.py:225-239 on the unscaled problem in f64:
    Qx + q + A'y ~ 0, y_j > 0 only at the upper bound, < 0 only at the
    lower one."""
    import numpy as np

    Q, A, q, bl, bu = p
    x = x[:Q.shape[0]].astype(np.float64)
    y = y[:A.shape[0]].astype(np.float64)
    ax = A @ x
    return bool(np.max(np.abs(Q @ x + q + A.T @ y)) < tol
                and np.all((y <= 1e-3) | (ax > bu - 1e-3))
                and np.all((y >= -1e-3) | (ax < bl + 1e-3)))


def phase_nonconvex(dev):
    """Phase 6: the nonconvex front end on the BOXQP-d rows."""
    import numpy as np
    import torch

    from qpalm_tpu_torch import constants as C
    from qpalm_tpu_torch.batch import solve_batch, stack_problems
    from qpalm_tpu_torch.solver import fused as F
    from qpalm_tpu_torch.solver.nonconvex import batch_gamma_pins
    from qpalm_tpu_torch.types import Settings
    from qpalm_tpu_torch.workloads import boxqp

    s = Settings(**S_NC)
    launches, numbers = 0, None
    for n, m, nb in NC_ROWS:
        label = f"nonconvex n={n} m={m} B={nb}"
        probs = [boxqp(n, seed=1000 * n + i) for i in range(nb)]
        torch.cuda.synchronize()
        F.fused_palm.launches = 0
        t0 = time.perf_counter()
        res = solve_batch(probs, s, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches += F.fused_palm.launches
        require(F.fused_palm.launches > 0, f"{label}: K1 was not launched")

        d32 = stack_problems(probs, np.float32, device=dev)
        (gi, gm), lob_ms = timed(lambda: batch_gamma_pins(d32, s))
        sp = s.replace(proximal=True)
        sd, scal, st = F._prepare(d32, sp, gamma_init=gi, gamma_max=gm)
        k_np, _, num = kernel_vs_plain(F, sd, scal, st, sp, label)
        # times of the first (full-width) row, the largest error of both
        if numbers is None:
            numbers = num
            numbers["split_ms"], cyc = onchip_split(F, sd, scal, st, sp,
                                                    num["ms"], label)
            say(f"[{label}] {1e3 * num['ms'] / sp.max_iter:.1f} us an "
                f"iteration ({num['ms']:.3f} ms / {sp.max_iter}, "
                f"{k_np[3].min()}-{k_np[3].max()} counted)")
        numbers["max_abs_err"] = max(numbers["max_abs_err"],
                                     num["max_abs_err"])
        status = res.status.cpu().numpy()
        require(np.array_equal(status, k_np[2]),
                f"{label}: solve_batch and K1 statuses differ")

        # pins: every lane the f64 spectrum of the scaled Q finds indefinite
        # is pinned, and Q_s + I/gamma is PSD to 1e-4
        lam = np.linalg.eigvalsh(sd.Q.double().cpu().numpy())[:, 0]
        gmax = gm.double().cpu().numpy()
        indef = lam < 0
        margin = lam + 1.0 / gmax
        require(np.all(gmax[indef] < s.gamma_max),
                f"{label}: {int((gmax[indef] >= s.gamma_max).sum())} "
                "indefinite lanes unpinned")
        require(np.all(margin[indef]
                       >= -1e-4 * np.maximum(1.0, np.abs(lam[indef]))),
                f"{label}: pin margin {margin[indef].min():.3e}")

        x, y = res.x.cpu().numpy(), res.y.cpu().numpy()
        require(np.isfinite(x).all() and np.isfinite(y).all(),
                f"{label}: non-finite x or y")
        solved = np.where(status == C.QPALM_SOLVED)[0]
        bad = [i for i in solved if not stationary(probs[i], x[i], y[i])]
        require(not bad, f"{label}: solved lanes not stationary: {bad[:8]}")
        say(f"[{label}] solved {len(solved)}/{nb} (all stationary), "
            f"indefinite {int(indef.sum())}, pinned "
            f"{int((gmax < s.gamma_max).sum())}, min pin margin "
            f"{margin[indef].min() if indef.any() else 0.0:.2e}; LOBPCG "
            f"{lob_ms:.1f} ms, solve_batch {wall:.3f} s, "
            f"mean iterations {res.iterations.float().mean().item():.1f}")
    return numbers, launches


def phase_dual(dev, probs, s32, x_cold):
    """Phase 7: dual-objective termination, the limit at the median of the
    cold solve's unscaled objectives.  Returns the numbers of the kernels
    line, the launches and the settings."""
    import numpy as np
    import torch

    from qpalm_tpu_torch import constants as C
    from qpalm_tpu_torch.batch import solve_batch, stack_problems
    from qpalm_tpu_torch.solver import fused as F

    obj = np.array([0.5 * x @ Q @ x + q @ x for (Q, _, q, _, _), x in
                    zip(probs, x_cold[:, :probs[0][0].shape[0]]
                        .astype(np.float64))])
    limit = float(np.median(obj))
    s = s32.replace(enable_dual_termination=True, dual_objective_limit=limit)
    label = f"dual B={len(probs)}"
    torch.cuda.synchronize()
    F.fused_palm.launches = 0
    res = solve_batch(probs, s, device=dev)
    torch.cuda.synchronize()
    launches = F.fused_palm.launches
    require(launches > 0, f"{label}: K1 was not launched")
    sd, scal, st = F._prepare(stack_problems(probs, np.float32, device=dev), s)
    k_np, _, numbers = kernel_vs_plain(F, sd, scal, st, s, label)
    status = res.status.cpu().numpy()
    require(np.array_equal(status, k_np[2]),
            f"{label}: solve_batch and K1 statuses differ")
    n_dual = int((status == C.QPALM_DUAL_TERMINATED).sum())
    n_sol = int((status == C.QPALM_SOLVED).sum())
    require(n_dual > 0 and n_sol > 0,
            f"{label}: dual-terminated {n_dual}, solved {n_sol}")
    say(f"[{label}] limit {limit:.4f} (median objective): dual-terminated "
        f"{n_dual}, solved {n_sol}, other {len(status) - n_dual - n_sol}; "
        f"mean iterations {res.iterations.float().mean().item():.2f}")
    return numbers, launches, s


def phase_chunk_warm(dev, probs, s32, x_cold, y_cold):
    """Phase 8: host chunking against one launch, and a warm start."""
    import numpy as np
    import torch

    from qpalm_tpu_torch.batch import solve_batch, stack_problems
    from qpalm_tpu_torch.solver import fused as F

    torch.cuda.synchronize()
    F.fused_palm.launches = 0
    chunked = solve_batch(probs, s32, device=dev, chunk=16)
    torch.cuda.synchronize()
    n_chunk = F.fused_palm.launches
    single = solve_batch(probs, s32, device=dev)
    for name in ("x", "y", "status", "iterations"):
        require(torch.equal(getattr(chunked, name), getattr(single, name)),
                f"chunk=16: {name} differs from one launch")
    require(n_chunk > 1, f"chunk=16 made {n_chunk} launches")

    warm = [(Q, A, 1.01 * q, bl, bu) for Q, A, q, bl, bu in probs]
    cold = solve_batch(warm, s32, device=dev)
    # phase 4's solutions without their padding, and padded again with
    # zeros as solve_batch pads warm starts
    n, m = probs[0][0].shape[0], probs[0][1].shape[0]
    x_ws, y_ws = np.zeros_like(x_cold), np.zeros_like(y_cold)
    x_ws[:, :n], y_ws[:, :m] = x_cold[:, :n], y_cold[:, :m]
    torch.cuda.synchronize()
    F.fused_palm.launches = 0
    res = solve_batch(warm, s32, x0=list(x_ws[:, :n]), y0=list(y_ws[:, :m]),
                      device=dev)
    torch.cuda.synchronize()
    n_warm = F.fused_palm.launches
    require(n_warm > 0, "warm start: K1 was not launched")
    sd, scal, st = F._prepare(stack_problems(warm, np.float32, device=dev),
                              s32, x_ws=x_ws, y_ws=y_ws)
    k_np, _, kw = kernel_vs_plain(F, sd, scal, st, s32, "warm start")
    require(np.array_equal(res.status.cpu().numpy(), k_np[2]),
            "warm start: solve_batch and K1 statuses differ")
    it_w = res.iterations.float().mean().item()
    it_c = cold.iterations.float().mean().item()
    require(it_w < it_c, f"warm start: mean iterations {it_w:.2f} not below "
            f"cold {it_c:.2f}")
    say(f"[chunk] chunk=16: {n_chunk} launches, statuses, iterations, x and "
        f"y bit-identical to one launch; [warm] q*1.01 warm-started: mean "
        f"iterations {it_w:.2f} vs cold {it_c:.2f}, solved "
        f"{int((res.status == 1).sum())}/{len(warm)}, launches {n_warm}; "
        f"K1 {kw['ms']:.3f} ms, bound {kw['bound_ms']:.4f} ms "
        f"({kw['bound_by']}, the warm start's {int(k_np[3].sum())} "
        "iterations)")


def phase_stream_headline(sd, scal, st, s32, k_np):
    """Phase 9: K1 forced to stream at the headline shape against the
    on-chip K1 (phase 4's outputs k_np), then against its streaming twin.
    The two tiers sum the Schur matrix in different orders (as the
    reference's two tiers do) and round apart.  At this shape and eps the
    iteration counts are that sensitive to rounding: on the CPU
    (tools/tier_drift.py 512) the reference's two tiers share 488/512
    counts, and the least that two right implementations share there (the
    port's on-chip twin and the reference's on-chip kernel) is
    STREAM_COUNT_BAR = 474.  The counts are held at that bar, which is
    under the 486 that a 5% bar would give; the statuses and |dx| at
    kernel_vs_plain's bars."""
    import numpy as np

    from qpalm_tpu_torch.solver import fused as F

    T = s32.max_iter
    s_np = [a.cpu().numpy() for a in F._finish(
        sd, scal, F.fused_palm(sd, scal, st, T, s32, qa_panel=8))]
    st_eq = s_np[2] == k_np[2]
    it_eq = s_np[3] == k_np[3]
    dx = float(np.abs(s_np[0] - k_np[0])[st_eq & it_eq].max())
    require(st_eq.sum() >= B - 5,
            f"streaming vs on-chip K1: status equal on {st_eq.sum()}/{B}")
    require(it_eq.sum() >= STREAM_COUNT_BAR,
            f"streaming vs on-chip K1: iterations equal on {it_eq.sum()}/{B}")
    require(dx < 1e-3, f"streaming vs on-chip K1: max|dx| {dx:.3e}")
    say(f"[stream headline] streaming vs on-chip K1: status equal "
        f"{st_eq.sum()}/{B}, iterations equal {it_eq.sum()}/{B}, max|dx| "
        f"{dx:.2e}")
    kernel_vs_plain(F, sd, scal, st, s32, "stream headline", qa_panel=8)


def phase_stream_full(dev, probs_dual, s_dual):
    """Phase 10: the streaming kernel at full width against its twin for
    STREAM_T iterations from the same state; then one nonconvex and one
    dual-terminating streaming launch against the twin.  Returns the
    numbers of the full-width comparison."""
    import numpy as np
    import torch

    from qpalm_tpu_torch import sweep
    from qpalm_tpu_torch.batch import stack_problems
    from qpalm_tpu_torch.solver import fused as F
    from qpalm_tpu_torch.solver.nonconvex import batch_gamma_pins
    from qpalm_tpu_torch.types import Settings
    from qpalm_tpu_torch.workloads import boxqp

    probs = sweep.row_problems("randomQP", 352)
    d32 = stack_problems(probs, np.float32, device=dev)
    nb, n, _ = d32.Q.shape
    m = d32.A.shape[1]
    s = sweep.S32
    sd, scal, st = F._prepare(d32, s)
    require(F.pick_tier(n, m) == "stream", f"n={n}: not the streaming tier")
    before = F.fused_palm.stream_launches
    out_k = F.fused_palm(sd, scal, st, STREAM_T, s)
    torch.cuda.synchronize()
    require(F.fused_palm.stream_launches == before + 1,
            "full width: the streaming kernel was not launched")
    out_p, plain_ms = timed(lambda: F.fused_palm_plain(
        sd, scal, st, STREAM_T, s, stream=True))
    sc_k, sc_p = out_k.sc.cpu().numpy(), out_p.sc.cpu().numpy()
    status_eq = int((sc_k[:, F._STATUS] == sc_p[:, F._STATUS]).sum())
    iter_eq = int((sc_k[:, F._ITER] == sc_p[:, F._ITER]).sum())
    rows_eq = int((sc_k == sc_p).all(1).sum())
    sc_rel = float(np.max(np.abs(sc_k - sc_p)
                          / np.maximum(1.0, np.abs(sc_p))))
    dx = (out_k.nst[:, F._X] - out_p.nst[:, F._X]).abs().max().item()
    # the streaming kernel keeps every entry's arithmetic of its twin
    # (stream.cuh): bit for bit, not to a tolerance
    require(rows_eq == nb, f"full width: all 18 sc rows bit-equal on "
            f"{rows_eq}/{nb} (statuses {status_eq}, iteration counts "
            f"{iter_eq}, max rel {sc_rel:.3e})")
    require(dx == 0.0, f"full width: max|dx| {dx:.3e}, not 0")
    require(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
            "full width: the state differs from the twin's")
    # T-iteration launches resume exactly: three launches of STREAM_T / 3
    st3 = st
    for _ in range(3):
        st3 = F.fused_palm(sd, scal, st3, STREAM_T // 3, s)
    require(all(torch.equal(a, b) for a, b in zip(st3, out_k)),
            f"full width: 3 launches of {STREAM_T // 3} iterations differ "
            f"from one of {STREAM_T}")
    ms = cuda_ms(lambda: F.fused_palm(sd, scal, st, STREAM_T, s), 3)
    iters = sc_k[:, F._ITER].sum()
    kb = k1_bound(nb, n, m, iters)
    # the split of the launch by each block's clock64() counters
    F.fused_palm.profile = []
    try:
        F.fused_palm(sd, scal, st, STREAM_T, s)
        split = F.profile_split(F.fused_palm.profile[0], ms)
    finally:
        F.fused_palm.profile = None
    say(f"[stream n={n} m={m} B={nb}] {STREAM_T} iterations from the same "
        f"state: statuses {status_eq}/{nb}, iteration counts {iter_eq}/{nb}, "
        f"all 18 sc rows bit-equal on {rows_eq}/{nb}, max|dx| {dx:.1e}, the "
        f"whole state bit-identical to the twin; 3 launches of "
        f"{STREAM_T // 3} bit-identical to one; kernel {ms:.3f} ms, bound "
        f"{kb['bound_ms']:.3f} ms ({kb['bound_by']}), plain {plain_ms:.1f} "
        f"ms, library none")
    say(f"[stream n={n} split] of {ms:.3f} ms by cycle counters: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / ms:.1f}%)" for k, v in split.items()))
    numbers = dict(max_abs_err=dx, ms=ms, plain_ms=plain_ms, library_ms=None,
                   split_ms=split, **kb)

    # nonconvex: BOXQP-d n=16 under its pins, 100 iterations
    s_nc = Settings(**{**S_NC, "max_iter": 100})
    d32 = stack_problems([boxqp(16, seed=16000 + i) for i in range(128)],
                         np.float32, device=dev)
    gi, gm = batch_gamma_pins(d32, s_nc)
    s_nc = s_nc.replace(proximal=True)
    sd, scal, st = F._prepare(d32, s_nc, gamma_init=gi, gamma_max=gm)
    kernel_vs_plain(F, sd, scal, st, s_nc, "stream nonconvex n=16",
                    qa_panel=8)
    # dual-objective termination at phase 7's limit, forced to stream
    sd, scal, st = F._prepare(stack_problems(probs_dual, np.float32,
                                             device=dev), s_dual)
    k_np, _, _ = kernel_vs_plain(F, sd, scal, st, s_dual,
                                 "stream dual-termination", qa_panel=8)
    require((k_np[2] == 2).any(), "stream dual: no lane dual-terminated")
    return numbers


def phase_sweep(dev):
    """Phase 11: the 15 rows of the workloads sweep.  Returns the
    streaming launches of the whole sweep."""
    import torch

    from qpalm_tpu_torch import polish, sweep
    from qpalm_tpu_torch.solver import fused as F

    require(polish._bkkt_lib() is not None, "the host polish's native "
            "Bunch-Kaufman library (libqpalm_ldl) does not load")
    rows = []
    torch.cuda.synchronize()
    F.fused_palm.launches = F.fused_palm.stream_launches = 0
    for family, size in sweep.ROWS:
        before = (F.fused_palm.launches, F.fused_palm.stream_launches)
        row = sweep.run_row(family, size, device=dev)
        torch.cuda.synchronize()
        row["launches"] = F.fused_palm.launches - before[0]
        row["stream_launches"] = F.fused_palm.stream_launches - before[1]
        rows.append(row)
        label = f"{family} {row['size']} B={row['batch']}"
        say(f"[sweep C baseline] {label}: {row['baseline_solves_per_s']:.1f} "
            f"solves/s on {row['baseline_sample']} problems (solved "
            f"{row['baseline_solved']}), the row {row['solves_per_s']:.1f} "
            f"solves/s: {row['speedup']:.2f}x")
        kb = k1_bound(row["batch"], row["n_pad"], row["m_pad"],
                      row["mean_iterations"] * row["batch"])
        say(f"[sweep] {label} ({row['n_pad']}x{row['m_pad']}, {row['tier']}): "
            f"certified {row['certified']}/{row['batch']} (polish "
            f"{row['polish1_ok']}, retried {row['retried']}, finisher "
            f"{row['finished']}), referee disagreements "
            f"{row['referee_disagreements']}, f32 solved {row['solved_f32']}, "
            f"mean iterations {row['mean_iterations']:.1f}; wall "
            f"{row['wall_s']:.3f} s = solve_batch {row['solve_s']:.3f} (K1 "
            f"{row['k1_ms']:.1f} ms, bound {kb['bound_ms']:.3f} ms) + copy "
            f"{row['copy_s']:.3f} + polish {row['polish_s']:.3f} + retry/"
            f"finisher {row['retry_finish_s']:.3f}; launches "
            f"{row['launches']} (streaming {row['stream_launches']})")
        require(row["launches"] >= 1, f"{label}: K1 was not launched")
        require((row["stream_launches"] > 0) == (row["tier"] == "stream"),
                f"{label}: tier {row['tier']} but {row['stream_launches']} "
                "streaming launches")
        require(row["certified"] >= 0.99 * row["batch"],
                f"{label}: certified {row['certified']}/{row['batch']}")
        require(row["referee_disagreements"] == 0,
                f"{label}: {row['referee_disagreements']} referee "
                "disagreements")
    n_stream = sum(r["tier"] == "stream" for r in rows)
    require(n_stream == 7, f"{n_stream} streaming rows, not 7")
    return F.fused_palm.stream_launches


def phase_probes():
    """Phase 12: the memory-plan probes, timed with their counters zeroed
    (the probes' own path), then against their plain versions.  Returns
    the launches and the numbers of the kernels line (at the largest n)."""
    import torch

    from qpalm_tpu_torch import probe

    torch.cuda.synchronize()
    probe.scratch_probe.launches = probe.assembly_probe.launches = 0
    rows = [probe.measure(n, n * 3 // 2) for n in probe.SIZES]
    torch.cuda.synchronize()
    launches = dict(probe_scratch=probe.scratch_probe.launches,
                    probe_assembly=probe.assembly_probe.launches)
    for name, count in launches.items():
        require(count > 0, f"{name} was not launched")
    for row in rows:
        n, m, nb = row["n"], row["m"], row["B"]
        for name, part in probe.against_plain(n, m).items():
            row[name].update(part)
        sc, asm = row["scratch"], row["assembly"]
        require(sc["rel_err"] < 1e-5, f"scratch probe n={n}: rel err "
                f"{sc['rel_err']:.3e}")
        require(asm["rel_err"] < 1e-3, f"assembly probe n={n}: rel err "
                f"{asm['rel_err']:.3e}")
        # scratch: the fill, 8 rank-1 updates and the row sums, seed in and
        # row sums out.  assembly: M = A'WA, symmetric, so one triangle
        # (m n (n + 1)) plus w A (m n) and the row sums (n^2); A and w in, M
        # out (the plan under test keeps it in global memory) and the sums.
        sc.update(bound(18 * nb * n * n, 4 * nb * (1 + n)))
        asm.update(bound(nb * (m * n * (n + 1) + m * n + n * n),
                         4 * nb * (m * n + m + n * n + n)))
        say(f"[probe n={n} m={m} B={nb}] scratch {sc['ms']:.3f} ms "
            f"({sc['GBps']:.0f} GB/s of plan traffic, rel err "
            f"{sc['rel_err']:.1e}, plain {sc['plain_ms']:.3f} ms); assembly "
            f"{asm['ms']:.3f} ms ({asm['GBps']:.0f} GB/s, rel err "
            f"{asm['rel_err']:.1e}, plain {asm['plain_ms']:.3f} ms, einsum "
            f"forming M {asm['library_ms']:.3f} ms, einsum of the row sums "
            f"{asm['row_sums_ms']:.3f} ms, bound {asm['bound_ms']:.3f} ms)")
    last = rows[-1]
    numbers = {
        f"probe_{name}": dict(
            max_abs_err=last[name]["max_abs_err"], ms=last[name]["ms"],
            plain_ms=last[name]["plain_ms"],
            library_ms=last[name].get("library_ms"),
            bound_ms=last[name]["bound_ms"], bound_by=last[name]["bound_by"])
        for name in ("scratch", "assembly")}
    numbers["probe_assembly"]["row_sums_ms"] = \
        last["assembly"]["row_sums_ms"]
    return launches, numbers


def phase_bench(counters):
    """Phase 13: the bench's protocol in full, its JSON line printed."""
    import torch

    from qpalm_tpu_torch import bench

    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    out = bench.run("cuda")
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    say(json.dumps(out))
    d = out["detail"]
    say(f"[bench] {out['value']:.1f} solves/s, {out['vs_baseline']:.2f}x the "
        f"C baseline ({d['baseline_solves_per_s']:.1f} solves/s, "
        f"{d['baseline_blas']}); reps {d['pipeline_s_reps']} s, solved "
        f"{d['solved_reps']} of {d['total']}; rescued {d['rescue_reps']}; "
        f"launches {launches}")
    require(all(s == d["total"] for s in d["solved_reps"]),
            f"bench: solved {d['solved_reps']} of {d['total']} a rep")
    require(all(r["checked"] == r["agree"] for r in d["referee_reps"]),
            f"bench: referee {d['referee_reps']}")
    require(out["vs_baseline"] is not None, "bench: no baseline divisor")
    for name, count in launches.items():
        require(count > 0, f"bench: kernel {name} was not launched")


def k2_against_twins(chol, M, b, label):
    """K2a on M (B, n, n) and K2b on b, one vector a matrix (B, n) or k
    columns (B, n, k), held bit for bit against the twins and timed beside
    the library calls that compute the same functions.  Returns the
    numbers of the factor and of the solve for the kernels line."""
    import torch

    nb, n, _ = M.shape
    b3 = b[..., None] if b.dim() == 2 else b
    k = b3.shape[2]
    R = chol.cholesky_upper(M)
    x = chol.cholesky_solve(R, b)
    Rp = chol.cholesky_upper_plain(M)
    xp = chol.cholesky_solve_plain(R, b)
    torch.cuda.synchronize()
    require(torch.equal(R, Rp), f"{label}: factor vs plain, "
            f"{int((R != Rp).sum())} entries differ")
    require(torch.equal(x, xp), f"{label}: solve vs plain, "
            f"{int((x != xp).sum())} entries differ")
    res = (M.double() @ x.double().reshape(b3.shape)
           - b3.double()).abs().max().item() / M.double().abs().max().item()
    require(res < (1e-12 if M.dtype == torch.float64 else 1e-3),
            f"{label}: solve residual {res:.3e}")
    es = M.element_size()
    peak = F64_PEAK if M.dtype == torch.float64 else F32_PEAK
    fac = dict(max_abs_err=0.0, ms=cuda_ms(lambda: chol.cholesky_upper(M), 5),
               plain_ms=cuda_ms(lambda: chol.cholesky_upper_plain(M), 1),
               library_ms=cuda_ms(lambda: torch.linalg.cholesky(
                   M, upper=True), 5),
               **bound(nb * n ** 3 / 3, 2 * es * nb * n * n, peak))
    sol = dict(max_abs_err=0.0,
               ms=cuda_ms(lambda: chol.cholesky_solve(R, b), 5),
               plain_ms=cuda_ms(lambda: chol.cholesky_solve_plain(R, b), 1),
               library_ms=cuda_ms(lambda: torch.cholesky_solve(
                   b3, R, upper=True), 5),
               **bound(2 * nb * n * n * k, es * nb * (n * n + 2 * n * k),
                       peak))
    say(f"[general K2 {label}] factor and solve bit-identical to the twins, "
        f"solve residual {res:.1e}; factor {fac['ms']:.4f} ms (bound "
        f"{fac['bound_ms']:.4f}, plain {fac['plain_ms']:.2f}, "
        f"torch.linalg.cholesky {fac['library_ms']:.4f}); solve "
        f"{sol['ms']:.4f} ms (bound {sol['bound_ms']:.4f}, plain "
        f"{sol['plain_ms']:.2f}, torch.cholesky_solve "
        f"{sol['library_ms']:.4f})")
    return fac, sol


def general_solve(dev, probs, s, label, **kw):
    """solve_batch on the card with the K2 counters zeroed before and read
    after; returns (result, wall seconds, launches by kernel)."""
    from qpalm_tpu_torch.batch import solve_batch

    res, wall, launches = counted(lambda: solve_batch(probs, s, device=dev,
                                                      **kw))
    say(f"[general {label}] wall {wall:.3f} s, mean iterations "
        f"{res.iterations.float().mean().item():.1f}, solved "
        f"{int((res.status == 1).sum())}/{len(probs)}; K2 launches "
        f"{launches}")
    return res, wall, launches


def general_vs_cpu(probs, res, s):
    """The card's general-loop result `res` on its first len(probs) lanes,
    held to the port's general loop on the CPU at settings `s` (f64): equal
    statuses and iteration counts, |dx| <= 1e-8 and |dy| <= 1e-7 scaled by
    max(1, max|x|) a lane, the bar of tests/test_torch_core.py."""
    import numpy as np

    from qpalm_tpu_torch.batch import solve_batch

    t0 = time.perf_counter()
    cpu = solve_batch(probs, s, device="cpu")
    nl = len(probs)
    got = [a.cpu().numpy()[:nl] for a in (res.x, res.y, res.status,
                                          res.iterations)]
    want = [a.numpy() for a in (cpu.x, cpu.y, cpu.status, cpu.iterations)]
    scale = np.maximum(1.0, np.abs(want[0]).max(1))
    dx = float((np.abs(got[0] - want[0]).max(1) / scale).max())
    dy = float((np.abs(got[1] - want[1]).max(1) / scale).max())
    st_eq = int((got[2] == want[2]).sum())
    it_eq = int((got[3] == want[3]).sum())
    say(f"[general vs CPU] {nl} lanes: statuses equal {st_eq}, iteration "
        f"counts equal {it_eq}, scaled max|dx| {dx:.2e}, max|dy| {dy:.2e} "
        f"(CPU {time.perf_counter() - t0:.1f} s)")
    require(st_eq == nl and it_eq == nl and dx <= 1e-8 and dy <= 1e-7,
            f"general loop on the card vs the CPU: statuses {st_eq}, counts "
            f"{it_eq} of {nl}, dx {dx:.3e}, dy {dy:.3e}")


def polish_and_referee(probs, res):
    """A solve_batch result polished at EPS_TARGET as a sweep row is (one
    polish, then sweep.retry_rejected), and rechecked by the f64 referee;
    returns (certified, certified lanes the referee agrees on)."""
    import numpy as np

    from qpalm_tpu_torch import referee, sweep
    from qpalm_tpu_torch.batch import stack_problems
    from qpalm_tpu_torch.polish import polish_batch_np
    from qpalm_tpu_torch.types import QPData

    d64 = QPData(*(a.numpy() for a in stack_problems(probs, np.float64)))
    x0, y0 = res.x.cpu().numpy(), res.y.cpu().numpy()
    pol = polish_batch_np(d64, x0, y0, eps_abs=EPS_TARGET, eps_rel=EPS_TARGET,
                          rounds=1, refine_steps=0)
    ok, x, y = pol.ok.copy(), pol.x.copy(), pol.y.copy()
    sweep.retry_rejected(d64, x0, y0, ok, x, y)
    viol = referee.check(*d64, x, y, EPS_TARGET, EPS_TARGET)[0]
    return int(ok.sum()), int((ok & (viol <= 1.0)).sum())


def phase_general(dev, probs, s32, k_np, x_cert, ok_cert):
    """Phase 14: the general loop on the card.  Returns (numbers, launches)
    of the kernels line's K2 plans."""
    import numpy as np
    import torch

    from qpalm_tpu_torch import constants as C
    from qpalm_tpu_torch import sweep
    from qpalm_tpu_torch.batch import solve_batch_escalate
    from qpalm_tpu_torch.linalg import chol
    from qpalm_tpu_torch.types import Settings

    numbers, launches = {}, {}
    rng = np.random.default_rng(14)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, nb, n, dt, want, rows, identity in K2_SHAPES:
        G = rng.standard_normal((nb, n, n)).astype(dt)
        M = torch.from_numpy(G @ np.transpose(G, (0, 2, 1))
                             + n * np.eye(n, dtype=G.dtype)).to(dev)
        b = torch.from_numpy(rng.standard_normal((nb, n)).astype(dt)).to(dev)
        if identity:
            b = torch.eye(n, dtype=M.dtype, device=dev).expand(
                nb, n, n).contiguous()
        plans = (chol.factor_plan(n, M.dtype),
                 chol.solve_plan(nb, n, n if identity else 1, M.dtype,
                                 sms)[0])
        require(plans == want, f"K2 {label}: plans {plans}, not {want}")
        if plans[0] == "global":
            gp = chol.global_plan(nb, n, M.dtype, sms)
            say(f"[general K2 {label}] cluster factor: {gp.cluster} CTAs a "
                f"matrix, panels of {gp.b} rows, "
                f"{chol.global_smem_bytes(n, M.dtype, gp.b)} bytes of shared "
                "memory a CTA")
        for row, num in zip(rows, k2_against_twins(chol, M, b, label)):
            if row is not None:
                numbers[row] = num

    # (a) the headline at bench.py's f32 settings, general loop vs K1
    res, _, la = general_solve(dev, probs, s32.replace(use_fused="never"),
                               "headline f32, use_fused='never'")
    st_eq = int((res.status.cpu().numpy() == k_np[2]).sum())
    it_eq = int((res.iterations.cpu().numpy() == k_np[3]).sum())
    say(f"[general headline f32] vs K1 (phase 4): statuses equal "
        f"{st_eq}/{B}, iteration counts equal {it_eq}/{B} (the reference's "
        f"own general loop and fused kernel share {REF_GENERAL_COUNTS}/512 "
        "counts here on the CPU, tools/tier_drift.py; its v5e smoke found "
        "them iteration-identical at n=16, benchmarks/SMOKE_TPU_r03.txt)")
    require(st_eq >= B - 5, f"general f32: statuses equal {st_eq}/{B}")
    require(it_eq >= GENERAL_COUNT_BAR,
            f"general f32: iteration counts equal {it_eq}/{B}")
    require(la.get("chol", 0) > 0 and la.get("chol_solve", 0) > 0,
            f"general f32: K2 launches {la}")
    launches["chol_solve_vec"] = la["chol_solve"]
    # (b) the defaults: f64, max_refine 3, eps 1e-4; then eps 1e-6.  x is
    # held to phase 5's certified (1e-6) solutions at DEFAULT_X_BAR and
    # TIGHT_X_BAR
    for label, s, bar in (("Settings()", Settings(), DEFAULT_X_BAR),
                          ("Settings(eps 1e-6)",
                           Settings(eps_abs=1e-6, eps_rel=1e-6),
                           TIGHT_X_BAR)):
        res, _, lb = general_solve(dev, probs, s, f"headline {label}")
        require(bool((res.status == C.QPALM_SOLVED).all()),
                f"{label}: solved {int((res.status == 1).sum())}/{B}")
        dx = float(np.abs(res.x.cpu().numpy() - x_cert)[ok_cert].max())
        say(f"[general headline {label}] max|x - certified x| {dx:.2e} on "
            f"{int(ok_cert.sum())} certified lanes (bar {bar:.0e})")
        require(dx <= bar, f"{label}: max|x - certified| {dx:.3e}")
        if label == "Settings()":
            launches["chol_f64"] = lb.get("chol_f64", 0)
            # the kernels line's f64 one-vector row: the warp kernel
            launches["chol_solve_f64"] = lb.get("chol_solve_warp_f64", 0)
            general_vs_cpu(probs[:CPU_LANES], res, Settings())

    # (c) randomQP n=480, past K1: the global plan, polished and refereed,
    # at the sweep's f32 settings (through its row) and at Settings()
    torch.cuda.synchronize()
    chol.KERNEL_LAUNCHES.clear()
    row = sweep.run_row("randomQP", WIDE_N, device=dev, batch=WIDE_B)
    torch.cuda.synchronize()
    lc = dict(chol.KERNEL_LAUNCHES)
    label = f"randomQP n={WIDE_N} B={WIDE_B} float32"
    say(f"[general {label}] certified {row['certified']}/{WIDE_B} (polish "
        f"{row['polish1_ok']}, retried {row['retried']}, finisher "
        f"{row['finished']}), referee disagreements "
        f"{row['referee_disagreements']}, solved {row['solved_f32']}, "
        f"mean iterations {row['mean_iterations']:.1f}; wall "
        f"{row['wall_s']:.3f} s = solve {row['solve_s']:.3f} + polish "
        f"{row['polish_s']:.3f} + retry/finisher {row['retry_finish_s']:.3f}"
        f"; K2 launches {lc}")
    require(row["certified"] >= 0.99 * WIDE_B,
            f"{label}: certified {row['certified']}/{WIDE_B}")
    require(row["referee_disagreements"] == 0,
            f"{label}: {row['referee_disagreements']} referee disagreements")
    launches["chol_global"] = lc.get("chol_global", 0)
    launches["chol_solve_global"] = lc.get("chol_solve_global", 0)
    wide = sweep.row_problems("randomQP", WIDE_N, batch=WIDE_B)
    res, _, lc = general_solve(dev, wide, Settings(),
                               f"randomQP n={WIDE_N} Settings()")
    cert, agree = polish_and_referee(wide, res)
    say(f"[general randomQP n={WIDE_N} Settings()] polished and retried as a "
        f"sweep row at {EPS_TARGET:.0e}: certified {cert}/{WIDE_B}, the "
        f"referee agrees on {agree}")
    require(bool((res.status == C.QPALM_SOLVED).all()),
            f"randomQP n={WIDE_N} Settings(): solved "
            f"{int((res.status == 1).sum())}/{WIDE_B}")
    require(cert >= 0.99 * WIDE_B and agree == cert,
            f"randomQP n={WIDE_N} Settings(): certified {cert}, referee "
            f"agrees on {agree}")
    launches["chol_global_f64"] = lc.get("chol_global_f64", 0)
    launches["chol_solve_global_f64"] = lc.get("chol_solve_global_f64", 0)

    # (d) escalation: an f32 pass of 20 iterations, f64 on the card
    s20 = s32.replace(max_iter=20)
    first, _, _ = general_solve(dev, probs, s20, "escalate, first pass")
    bad = (first.status != C.QPALM_SOLVED).cpu().numpy()
    torch.cuda.synchronize()
    chol.KERNEL_LAUNCHES.clear()
    t0 = time.perf_counter()
    res = solve_batch_escalate(probs, s20, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ld = dict(chol.KERNEL_LAUNCHES)
    re_ok = int((res.status.cpu().numpy()[bad] == C.QPALM_SOLVED).sum())
    say(f"[general escalate] {int(bad.sum())} lanes re-solved in f64 on "
        f"{res.x.device}, solved {re_ok}; wall {wall:.3f} s; K2 launches "
        f"{ld}")
    require(bad.any(), "escalate: the f32 pass left no lane to re-solve")
    require(re_ok == int(bad.sum()), f"escalate: {re_ok}/{int(bad.sum())} "
            "re-solved lanes solved")
    require(ld.get("chol_f64", 0) > 0, f"escalate: K2 launches {ld}")

    # (e) a time limit that cuts the solve after its first 200 iterations
    s_t = s32.replace(eps_abs=TL_EPS, eps_rel=TL_EPS, max_iter=1000,
                      time_limit=1e-9)
    cut, _, _ = general_solve(dev, probs, s_t, "time limit")
    whole, _, _ = general_solve(
        dev, probs, s_t.replace(time_limit=C.QPALM_INFTY, max_iter=200,
                                use_fused="never"), "200 iterations")
    ws, cs = whole.status.cpu().numpy(), cut.status.cpu().numpy()
    fin = ws != C.QPALM_MAX_ITER_REACHED
    require(fin.any() and (~fin).any(),
            f"time limit: {int(fin.sum())} lanes finished within 200")
    require(np.all(cs[~fin] == C.QPALM_TIME_LIMIT_REACHED),
            "time limit: unfinished lanes not TIME_LIMIT_REACHED")
    require(np.array_equal(cs[fin], ws[fin]), "time limit: statuses differ")
    for name in ("x", "y", "iterations"):
        require(torch.equal(getattr(cut, name), getattr(whole, name)),
                f"time limit: {name} differs from 200 iterations")
    say(f"[general time limit] {int((~fin).sum())} lanes cut at 200 "
        f"iterations (TIME_LIMIT_REACHED), {int(fin.sum())} finished "
        "before, x, y and counts identical to a 200-iteration solve")

    # (f) STREAM_N_MAX: the general loop against streaming K1
    for n in STREAM_ROWS:
        rows = sweep.row_problems("randomQP", n, batch=WIDE_B)
        k1, t_k1, _ = general_solve(dev, rows, sweep.S32, f"K1 n={n}")
        gl, t_gl, _ = general_solve(dev, rows,
                                    sweep.S32.replace(use_fused="never"),
                                    f"general n={n}")
        st_eq = int((k1.status == gl.status).sum())
        say(f"[general STREAM_N_MAX n={n} B={WIDE_B}] streaming K1 "
            f"{t_k1:.3f} s, general loop {t_gl:.3f} s ({t_gl / t_k1:.2f}x); "
            f"statuses equal {st_eq}/{WIDE_B}, solved "
            f"{int((k1.status == 1).sum())} and "
            f"{int((gl.status == 1).sum())}")
    return numbers, launches


def phase_wide(dev):
    """Phase 15: K2's wide plans at the sizes no other plan takes, against
    their twins on the card, then solve_batch through the wide factor.
    Returns (numbers, launches) of the kernels line's wide rows."""
    import numpy as np
    import torch

    from qpalm_tpu_torch import constants as C
    from qpalm_tpu_torch import referee
    from qpalm_tpu_torch.batch import stack_problems
    from qpalm_tpu_torch.linalg import chol
    from qpalm_tpu_torch.types import QPData, Settings
    from qpalm_tpu_torch.workloads import random_qp

    from qpalm_tpu_torch._build import check_launch, kernels

    numbers, per_launch = {}, {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for nb, n, dt in WIDE_FACTORS:
        dtype = getattr(torch, dt)
        label = f"{dt} ({nb}, {n}, {n})"
        g = torch.Generator(device=dev).manual_seed(15 + nb)
        G = torch.randn((nb, n, n), generator=g, device=dev, dtype=dtype)
        M = G @ G.transpose(1, 2) + n * torch.eye(n, device=dev, dtype=dtype)
        del G
        gp = chol.global_plan(nb, n, dtype, sms)
        require(chol.factor_plan(n, dtype) == "wide"
                and isinstance(gp, chol.GridPlan),
                f"K2 wide factor {label}: plan {gp}")
        R = chol.cholesky_upper(M)
        Rp, plain_ms = timed(lambda: chol.cholesky_upper_plain(M))
        require(torch.equal(R, Rp), f"K2 wide factor {label} vs plain: "
                f"{int((R != Rp).sum())} entries differ")
        del Rp
        prof = torch.zeros((chol.prof_ctas(nb, gp), 8), dtype=torch.int64,
                           device=dev)
        R2 = torch.empty_like(M)
        require(chol._launch_global(M, R2, gp, prof) == 0,
                f"K2 wide factor {label}: profiled launch refused")
        torch.cuda.synchronize()
        require(torch.equal(R2, R), f"K2 wide factor {label}: the profiled "
                "instantiation differs")
        del R2
        es = M.element_size()
        peak = F64_PEAK if dtype == torch.float64 else F32_PEAK
        row = dict(max_abs_err=0.0,
                   ms=cuda_ms(lambda: chol.cholesky_upper(M), 3),
                   plain_ms=plain_ms,
                   library_ms=cuda_ms(lambda: torch.linalg.cholesky(
                       M, upper=True), 3),
                   **bound(nb * n ** 3 / 3, 2 * es * nb * n * n, peak))
        cyc = prof.double().mean(0).tolist()[:len(chol.GRID_SECTIONS)]
        split = {sec: round(row["ms"] * c / sum(cyc), 3)
                 for sec, c in zip(chol.GRID_SECTIONS, cyc)}
        say(f"[wide K2 factor {label}] bit-identical to the twin; the grid "
            f"factor, {chol.prof_ctas(nb, gp)} CTAs "
            f"({chol.prof_ctas(nb, gp) // min(nb, gp.ctas)} a matrix), "
            f"panels of {gp.b} rows; {row['ms']:.3f} ms (bound "
            f"{row['bound_ms']:.3f} {row['bound_by']}, plain {plain_ms:.1f}, "
            f"torch.linalg.cholesky {row['library_ms']:.3f}); by its "
            f"counters {split} ms")
        name = chol.KERNELS["factor", "wide", dtype]
        numbers.setdefault(name, row)
        if (nb, n) == (1, WIDE_QP_N):
            per_launch[name] = row["ms"]
        del M, R

    def solve_row(R, b, b3, fn, label):
        """fn(R, b) held bit for bit to the twin run on the card, and timed
        beside torch.cholesky_solve and the bound."""
        n, k = R.shape[-1], b3.shape[2]
        x = fn(R, b)
        xp, plain_ms = timed(lambda: chol.cholesky_solve_plain(R, b))
        require(torch.equal(x, xp), f"K2 {label} vs plain: "
                f"{int((x != xp).sum())} entries differ")
        x3 = x.reshape(b3.shape).double()
        Rd = R.double()
        res = ((Rd.transpose(1, 2) @ (Rd @ x3) - b3.double()).abs().max()
               / b3.double().abs().max()).item()
        del Rd
        require(res < (1e-12 if R.dtype == torch.float64 else 1e-3),
                f"K2 {label}: residual {res:.3e}")
        es = R.element_size()
        peak = F64_PEAK if R.dtype == torch.float64 else F32_PEAK
        row = dict(max_abs_err=0.0, ms=cuda_ms(lambda: fn(R, b), 3),
                   plain_ms=plain_ms,
                   library_ms=cuda_ms(lambda: torch.cholesky_solve(
                       b3, R, upper=True), 3),
                   **bound(2 * n * n * k, es * (n * n + 2 * n * k), peak))
        say(f"[wide K2 {label}] bit-identical to the twin, residual "
            f"{res:.1e}; {row['ms']:.3f} ms (bound {row['bound_ms']:.3f} "
            f"{row['bound_by']}, plain {plain_ms:.1f}, torch.cholesky_solve "
            f"{row['library_ms']:.3f})")
        return row

    def global_solve(R, b):
        """The global solve (chol_solve_global_kernel), the plan that took
        the one-vector solves of this size before the stripe solve."""
        B, n, _ = R.shape
        x = torch.empty_like(b)
        check_launch("qp_chol_solve_global", kernels().qp_chol_solve_global(
            R.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, 1,
            *chol.global_solve_shape(n, R.dtype),
            int(R.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream))
        return x

    for n, dt in WIDE_SOLVES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(150)
        R = torch.triu(torch.rand((1, n, n), generator=g, device=dev,
                                  dtype=dtype) - 0.5)
        R.diagonal(dim1=1, dim2=2).fill_(n)
        for k in (1, 2):
            b = torch.randn((1, n) if k == 1 else (1, n, k), generator=g,
                            device=dev, dtype=dtype)
            b3 = b[..., None] if k == 1 else b
            require(chol.solve_plan(1, n, k, dtype) == ("wide", 1),
                    f"K2 wide solve {dt} n={n} k={k}: plan "
                    f"{chol.solve_plan(1, n, k, dtype)}")
            row = solve_row(R, b, b3, chol.cholesky_solve,
                            f"solve {dt} n={n} k={k}, stripes of "
                            f"{chol.STRIPE_W[dtype]}")
            if k == 1:
                numbers[chol.solve_kernel("wide", k, dtype)] = row
        del R

    # the solve_batch's one-vector solve: the stripe solve, and the global
    # solve that took it before (its row in the kernels line: the stripe
    # solve's at this shape, whose launches that run counts)
    n = WIDE_QP_N
    g = torch.Generator(device=dev).manual_seed(151)
    G = torch.randn((1, n, n), generator=g, device=dev, dtype=torch.float64)
    M = G @ G.transpose(1, 2) + n * torch.eye(n, device=dev,
                                              dtype=torch.float64)
    del G
    R = chol.cholesky_upper(M)
    b = torch.randn((1, n), generator=g, device=dev, dtype=torch.float64)
    require(chol.solve_plan(1, n, 1, torch.float64) == ("wide", 1),
            f"K2 solve float64 (1, {n}): plan "
            f"{chol.solve_plan(1, n, 1, torch.float64)}")
    name = chol.solve_kernel("wide", 1, torch.float64)
    row = solve_row(R, b, b[..., None], chol.cholesky_solve,
                    f"solve float64 (1, {n}), the stripe solve")
    old = solve_row(R, b, b[..., None], global_solve,
                    f"solve float64 (1, {n}), the global solve")
    numbers[name] = row
    per_launch[name] = row["ms"]
    say(f"[wide K2 solve float64 (1, {n})] the stripe solve "
        f"{row['ms']:.4f} ms against the global solve's {old['ms']:.4f} "
        f"(bound {row['bound_ms']:.4f}, torch.cholesky_solve "
        f"{row['library_ms']:.4f})")
    del M, R

    s = Settings()
    probs = [random_qp(WIDE_QP_N)]
    res, wall, lw = general_solve(dev, probs, s,
                                  f"randomQP n={WIDE_QP_N} Settings()")
    d64 = QPData(*(a.numpy() for a in stack_problems(probs, np.float64)))
    viol = referee.check(*d64, res.x.cpu().numpy(), res.y.cpu().numpy(),
                         s.eps_abs, s.eps_rel)[0]
    say(f"[wide general randomQP n={WIDE_QP_N} Settings()] status "
        f"{int(res.status[0])}, {int(res.iterations[0])} iterations, "
        f"referee violation {viol[0]:.3e} at eps {s.eps_abs:.0e} (<= 1 "
        f"holds), wall {wall:.2f} s")
    require(int(res.status[0]) == C.QPALM_SOLVED,
            f"randomQP n={WIDE_QP_N}: status {int(res.status[0])}")
    require(viol[0] <= 1.0, f"randomQP n={WIDE_QP_N}: referee violation "
            f"{viol[0]:.3e}")
    for name in per_launch:
        require(lw.get(name, 0) > 0, f"randomQP n={WIDE_QP_N}: K2 launches "
                f"{lw}")
    k2_s = sum(lw[name] * ms for name, ms in per_launch.items()) / 1e3
    say(f"[wide general randomQP n={WIDE_QP_N} Settings()] K2's share of "
        f"the {wall:.2f} s wall: "
        + " + ".join(f"{lw[name]} x {ms:.4f} ms ({name})"
                     for name, ms in per_launch.items())
        + f" = {k2_s:.2f} s")
    launches = {name: lw.get(name, 0) for name in numbers}
    return numbers, launches


def counted(fn):
    """(fn(), wall seconds, K2 launches by kernel) with the K2 counters
    zeroed just before and read just after."""
    import torch

    from qpalm_tpu_torch.linalg import chol

    torch.cuda.synchronize()
    chol.KERNEL_LAUNCHES.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(chol.KERNEL_LAUNCHES)


def spd(rng, nb, n, dtype, dev):
    """A batch of random SPD matrices G G' + n I on the card."""
    import numpy as np
    import torch

    G = rng.standard_normal((nb, n, n)).astype(dtype)
    return torch.from_numpy(G @ np.transpose(G, (0, 2, 1))
                            + n * np.eye(n, dtype=G.dtype)).to(dev)


def k2_rows(dev, rng, nb, n, dt, names, identity=False):
    """K2 at the shape (nb, n) a phase-16 run gives it: the factor and the
    one-vector solve (or the identity's n columns) held bit for bit to the
    twins and timed (k2_against_twins); returns {kernels-line name: row}
    for the names that are not None, and checks that the plans are the
    kernels those names count."""
    import numpy as np
    import torch

    from qpalm_tpu_torch.linalg import chol

    dtype = getattr(torch, dt)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    M = spd(rng, nb, n, dt, dev)
    k = n if identity else 1
    b = torch.eye(n, dtype=dtype, device=dev).expand(nb, n, n).contiguous() \
        if identity else torch.from_numpy(
            rng.standard_normal((nb, n)).astype(dt)).to(dev)
    gp = chol.global_plan(nb, n, dtype, sms) \
        if chol.factor_plan(n, dtype) != "smem" else None
    fplan = "wide" if isinstance(gp, chol.GridPlan) else \
        chol.factor_plan(n, dtype)
    splan = chol.solve_plan(nb, n, k, dtype, sms)[0]
    want = (chol.KERNELS["factor", fplan, dtype], chol.solve_kernel(splan, k,
                                                                    dtype))
    label = f"{dt} ({nb}, {n}){' identity' if identity else ''}"
    for name, have in zip(names, want):
        require(name is None or name == have,
                f"K2 {label}: plan {have}, not {name}")
    return {name: row for name, row in zip(
        names, k2_against_twins(chol, M, b, f"front end {label}"))
        if name is not None}


def k2_share(launches, rows):
    """Seconds of K2 in a run: its launches by kernel times each kernel's
    time at the run's shape."""
    return sum(launches.get(name, 0) * row["ms"]
               for name, row in rows.items()) / 1e3


def fe_quick_start(dev):
    """Phase 16 (a): README.md's Quick start through the port."""
    import numpy as np

    from qpalm_tpu_torch import QPALM, Settings, solve

    Q = np.array([[2.0, 0.5], [0.5, 2.0]])
    A = np.array([[1.0, 1.0]])

    def run():
        res = solve(Q, A, q=[1.0, 1.0], bmin=[-1.0], bmax=[1.0],
                    settings=Settings(eps_abs=1e-6, eps_rel=1e-6,
                                      verbose=False), device=dev)
        solver = QPALM(Q, A, [1.0, 1.0], [-1.0], [1.0],
                       settings=Settings(verbose=False), device=dev)
        r1 = solver.solve()
        solver.warm_start(r1.solution.x, r1.solution.y)
        solver.update_bounds([-2.0], [2.0])
        return res, r1, solver.solve()

    (res, r1, r2), wall, la = counted(run)
    for r in (res, r1, r2):
        require(r.info.status == "solved", f"quick start: {r.info.status}")
    # the box is inactive: x = -Q^-1 q
    require(np.abs(res.solution.x + 0.4).max() < 1e-5,
            f"quick start: x {res.solution.x}")
    say(f"[front end (a) quick start] solve: {res.info.status} x "
        f"{res.solution.x}, {res.info.iter} iterations; QPALM "
        f"{r1.info.iter} iterations cold, {r2.info.iter} warm after "
        f"update_bounds; wall {wall:.3f} s; K2 launches {la}")


def fe_random_qp(dev, rows):
    """Phase 16 (b): one randomQP at f64 Settings() through QPALM, SCHUR
    and KKT, bit-identical to solve_batch at B = 1, a warm-started
    re-solve after update_bounds, and a time limit that cuts."""
    import numpy as np

    from qpalm_tpu_torch import QPALM, Settings
    from qpalm_tpu_torch import constants as C
    from qpalm_tpu_torch import referee
    from qpalm_tpu_torch.batch import solve_batch
    from qpalm_tpu_torch.workloads import random_qp

    n, m = FE_QP
    p = random_qp(n, m, density=0.15, seed=0)
    s = Settings(verbose=False)

    def viol(res, bl, bu):
        return referee.check(p[0][None], p[1][None], p[2][None], bl[None],
                             bu[None], np.zeros(1), res.solution.x[None],
                             res.solution.y[None], s.eps_abs,
                             s.eps_rel)[0][0]

    out = {}
    for label, method in (("SCHUR", C.FACTORIZE_SCHUR),
                          ("KKT", C.FACTORIZE_KKT)):
        sm = s.replace(factorization_method=method)
        solver, setup_s, _ = counted(lambda: QPALM(*p, settings=sm,
                                                   device=dev))
        res, wall, la = counted(solver.solve)
        v = viol(res, p[3], p[4])
        say(f"[front end (b) randomQP n={n} m={m} {label}] "
            f"{res.info.status}, {res.info.iter} iterations, referee "
            f"violation {v:.3e} at eps {s.eps_abs:.0e}; setup {setup_s:.3f} "
            f"s, solve {wall:.3f} s, K2 {k2_share(la, rows):.3f} s of it; "
            f"K2 launches {la}")
        require(res.info.status == "solved", f"randomQP {label}: "
                f"{res.info.status}")
        require(v <= 1.0, f"randomQP {label}: referee violation {v:.3e}")
        for name in rows:
            require(la.get(name, 0) > 0, f"randomQP {label}: {name} not "
                    f"launched: {la}")
        out[label] = (solver, res, wall, la)

    solver, cold, wall, la = out["SCHUR"]
    bres, bwall, _ = counted(lambda: solve_batch([p], s, device=dev))
    xb = bres.x[0, :n].cpu().numpy()
    differ = int((xb != cold.solution.x).sum())
    require(differ == 0 and int(bres.iterations[0]) == cold.info.iter,
            f"randomQP: QPALM vs solve_batch: {differ} entries of x "
            f"differ, iterations {cold.info.iter} and "
            f"{int(bres.iterations[0])}")
    say(f"[front end (b)] QPALM SCHUR bit-identical to solve_batch([p]) "
        f"(x, {cold.info.iter} iterations; solve_batch {bwall:.3f} s)")

    bl, bu = 1.1 * p[3], 1.1 * p[4]
    solver.update_bounds(bl, bu)
    solver.warm_start(cold.solution.x, cold.solution.y)
    warm, wwall, _ = counted(solver.solve)
    v = viol(warm, bl, bu)
    say(f"[front end (b)] bounds x 1.1, warm start: {warm.info.status}, "
        f"{warm.info.iter} iterations (cold {cold.info.iter}), referee "
        f"violation {v:.3e}, {wwall:.3f} s")
    require(warm.info.status == "solved" and v <= 1.0
            and warm.info.iter < cold.info.iter,
            f"randomQP warm re-solve: {warm.info.status}, {warm.info.iter} "
            f"iterations, violation {v:.3e}")

    st = s.replace(eps_abs=1e-14, eps_rel=0.0, time_limit=1e-3)
    cut, cwall, _ = counted(lambda: QPALM(*p, settings=st,
                                          device=dev).solve())
    say(f"[front end (b)] time_limit 1e-3 s at eps 1e-14: "
        f"{cut.info.status} after {cut.info.iter} iterations, {cwall:.3f} s")
    require(cut.info.status_val == C.QPALM_TIME_LIMIT_REACHED,
            f"randomQP time limit: {cut.info.status}")
    return out["SCHUR"][3]


def fe_mpc(dev, rows):
    """Phase 16 (c): SequentialMPC(6, 20), one cold step then FE_MPC_STEPS
    warm-started steps, every step refereed at its own bounds."""
    import numpy as np

    from qpalm_tpu_torch import referee
    from qpalm_tpu_torch.workloads import SequentialMPC, mpc_chain

    mpc = SequentialMPC(*FE_MPC, seed=0, device=dev)
    Hn, An, qn = mpc_chain(*FE_MPC, seed=0)[:3]
    steps = []

    def step():
        bl, bu = mpc.bmin.copy(), mpc.bmax.copy()
        status, it, _ = mpc.step()
        sol = mpc.solver.solution
        steps.append((status, it, bl, bu, sol.x, sol.y,
                      float(np.abs(mpc.x).max())))

    _, cold_s, la_cold = counted(step)
    _, wall, la = counted(lambda: [step() for _ in range(FE_MPC_STEPS)])
    iters = np.array([st[1] for st in steps[1:]])
    viols = np.array([referee.check(
        Hn[None], An[None], qn[None], bl[None], bu[None], np.zeros(1),
        x[None], y[None], 1e-6, 1e-6)[0][0]
        for _, _, bl, bu, x, y, _ in steps])
    xmax = max(st[6] for st in steps)
    rate = FE_MPC_STEPS / wall
    say(f"[front end (c) SequentialMPC{FE_MPC}] n={Hn.shape[0]} "
        f"m={An.shape[0]}: cold step {cold_s:.3f} s ({steps[0][1]} "
        f"iterations), {FE_MPC_STEPS} warm steps {wall:.3f} s = {rate:.1f} "
        f"solves/s, iterations p50 {np.median(iters):.0f} max "
        f"{iters.max()}, K2 {k2_share(la, rows):.3f} s of the warm steps; "
        f"referee worst violation {viols.max():.3e} at 1e-6; max |x| "
        f"{xmax:.3f}; K2 launches (warm) {la}")
    require(all(st[0] == "solved" for st in steps),
            f"MPC statuses {[st[0] for st in steps]}")
    require(bool((viols <= 1.0).all()), f"MPC referee violations {viols}")
    require(xmax < 4.0, f"MPC max |x| {xmax}")
    for name in rows:
        require(la.get(name, 0) > 0, f"MPC: {name} not launched: {la}")
    return la


def fe_large(dev, rows, rows_cols):
    """Phase 16 (d): large.solve_large_dense at randomQP n=2048 (host
    polish) and n=512 (device polish), every lane certified and refereed."""
    import numpy as np

    from qpalm_tpu_torch import polish, referee
    from qpalm_tpu_torch.batch import stack_problems
    from qpalm_tpu_torch.large import solve_large_dense
    from qpalm_tpu_torch.types import QPData
    from qpalm_tpu_torch.workloads import random_qp

    require(polish._bkkt_lib() is not None, "the host polish's native "
            "Bunch-Kaufman library (libqpalm_ldl) does not load")
    out = {}
    for (n, m), polish_on_card, want in ((FE_LARGE, False, rows),
                                         (FE_LARGE_POLISH, True, rows_cols)):
        probs = [random_qp(n, m, density=0.15, seed=s)
                 for s in range(FE_LARGE_B)]
        with host_split() as split:
            r, wall, la = counted(lambda: solve_large_dense(
                probs, eps=EPS_TARGET, device_polish=polish_on_card,
                device=dev))
        say(f"[front end (d) n={n}] t_polish_s {r.t_polish_s:.3f} = the "
            f"host polish {split['polish_batch_np']:.3f} s "
            f"({split['calls_polish_batch_np']} calls, route "
            f"{split['route']}) + the finisher "
            f"{split['palm_finish_np']:.3f} s "
            f"({split['calls_palm_finish_np']} calls) + the rest "
            f"{r.t_polish_s - split['polish_batch_np'] - split['palm_finish_np']:.3f} s")
        d64 = QPData(*(a.numpy() for a in stack_problems(probs,
                                                         np.float64)))
        v = referee.check(*d64, r.x, r.y, EPS_TARGET, EPS_TARGET)[0]
        label = (f"n={n} m={m} x{FE_LARGE_B}, "
                 f"{'device' if polish_on_card else 'host'} polish")
        say(f"[front end (d) solve_large_dense {label}] ok {r.ok.tolist()}, "
            f"f32 statuses {r.status.tolist()} iterations "
            f"{r.iterations.tolist()}, referee worst violation "
            f"{v.max():.3e}; t_device_s {r.t_device_s:.3f}, t_polish_s "
            f"{r.t_polish_s:.3f}, wall {wall:.3f} s; "
            f"{' + '.join(want)} {k2_share(la, want):.3f} s of it; K2 "
            f"launches {la}")
        require(bool(r.ok.all()), f"large {label}: ok {r.ok}")
        require(bool((v <= 1.0).all()), f"large {label}: referee {v}")
        for name in want:
            require(la.get(name, 0) > 0, f"large {label}: {name} not "
                    f"launched: {la}")
        out[polish_on_card] = la
    return out[False], out[True]


class host_split:
    """Times the host polish (polish.polish_batch_np) and the finisher
    (finish_np.palm_finish_np) inside a `with` block: seconds and calls of
    each under their names, and the polish's route ("native BK" or "LU",
    polish._bkkt_lib).  large.py imports both at each call, so the wrappers
    stand in for them only inside the block."""

    def __enter__(self):
        from qpalm_tpu_torch import finish_np, polish

        self.split = {"route": "native BK" if polish._bkkt_lib() is not None
                      else "LU"}
        self.saved = []
        for mod, name in ((polish, "polish_batch_np"),
                          (finish_np, "palm_finish_np")):
            fn = getattr(mod, name)
            self.split[name] = 0.0
            self.split["calls_" + name] = 0

            def timed_fn(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.split[_name] += time.perf_counter() - t0
                    self.split["calls_" + _name] += 1

            self.saved.append((mod, name, fn))
            setattr(mod, name, timed_fn)
        return self.split

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def fe_diff(dev):
    """Phase 16 (e): solve_diff on the card against the CPU, central
    differences, and a batch of 4 against single calls."""
    import numpy as np
    import torch

    from qpalm_tpu_torch import Settings
    from qpalm_tpu_torch.diff import _solve_primal, active_rows, solve_diff

    n, m = FE_DIFF
    s = Settings(eps_abs=1e-10, eps_rel=1e-10, scaling=0, verbose=False)

    def problem(seed):
        rng = np.random.default_rng(seed)
        M = rng.standard_normal((n, n))
        A = rng.standard_normal((m, n)) / np.sqrt(n)
        u = 1.0 + rng.random(m)
        return (M @ M.T / n + np.eye(n), A, rng.standard_normal(n), -u, u)

    probs = [problem(160 + i) for i in range(4)]
    w = np.random.default_rng(161).standard_normal(n)

    def grads(p, device):
        t = [torch.tensor(a, device=device, requires_grad=True) for a in p]
        x = solve_diff(*t, s)
        wt = torch.as_tensor(w, device=device)
        loss = (wt * x).sum() + 0.5 * (x * x).sum()
        if device == "cpu":
            loss.backward()
            la = {}
        else:
            _, _, la = counted(loss.backward)
        return [a.grad.cpu().numpy() for a in t], x.detach(), la

    def loss_at(p):
        t = [torch.tensor(a, device=dev) for a in p]
        x = solve_diff(*t, s)
        return float((torch.as_tensor(w, device=dev) * x).sum()
                     + 0.5 * (x * x).sum())

    p = probs[0]
    (g, x, la), wall, _ = counted(lambda: grads(p, dev))
    g_cpu, _, _ = grads(p, "cpu")
    xb, yb = _solve_primal(*(torch.tensor(a)[None] for a in p), s)
    act, up = active_rows(torch.tensor(p[1])[None], torch.tensor(p[3])[None],
                          torch.tensor(p[4])[None], xb, yb, s.eps_abs)
    act = act[0].numpy()
    Bm = p[1] * np.sqrt(np.where(act, 1e10, 0.0))[:, None]
    kappa = np.linalg.cond(p[0] + Bm.T @ Bm + 1e-12 * np.eye(n))
    # the backward system's conditioning bounds how closely two summation
    # orders can agree: on the CPU the port's and the JAX package's
    # gradients, whose K and solves differ in order only, lie 0.45 kappa
    # eps apart at tests/test_torch_diff.py's seed 0; the card sums the
    # forward and the backward passes in other orders (cuBLAS) than the CPU
    bar = max(1e-6, 4 * kappa * np.finfo(np.float64).eps)
    rel = [float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
           for a, b in zip(g, g_cpu)]
    say(f"[front end (e) solve_diff n={n} m={m} f64] {int(act.sum())} active "
        f"rows, kappa(K) {kappa:.3e}; card vs CPU gradients of (Q, A, q, "
        f"bmin, bmax) relative {['%.2e' % r for r in rel]} (bar "
        f"{bar:.2e}); forward + backward {wall:.3f} s; K2 launches in the "
        f"backward pass {la}")
    require(all(r <= bar for r in rel), f"solve_diff card vs CPU: {rel}")
    require(sum(la.values()) > 0 and all(v > 0 for v in la.values()),
            f"solve_diff backward: K2 launches {la}")

    # central differences of 5 coordinates of q and of bmax (the upper
    # rows active at the solution first, where the gradient is not zero)
    h = 1e-5
    upper = act & up[0].numpy()
    rows = np.concatenate([np.flatnonzero(upper), np.flatnonzero(~upper)])
    worst = 0.0
    for arg, idx in ((2, np.arange(5)), (4, rows[:5])):
        for i in idx:
            pp, pm = [list(p), list(p)]
            pp[arg], pm[arg] = p[arg].copy(), p[arg].copy()
            pp[arg][i] += h
            pm[arg][i] -= h
            num = (loss_at(pp) - loss_at(pm)) / (2 * h)
            err = abs(num - g[arg][i]) / max(1.0, abs(g[arg][i]))
            worst = max(worst, err)
    say(f"[front end (e)] central differences (h {h:.0e}) of 5 q and 5 "
        f"bmax coordinates ({min(5, int(upper.sum()))} of them active "
        f"upper rows): worst relative error {worst:.2e}")
    require(upper.any(), "solve_diff: no active upper rows")
    require(worst <= 1e-4, f"solve_diff FD: {worst:.3e}")

    stk = [torch.tensor(np.stack([pr[k] for pr in probs]), device=dev)
           for k in range(5)]
    stk[2].requires_grad_(True)
    xs = solve_diff(*stk, s)
    (torch.as_tensor(w, device=dev) * xs).sum().backward()
    gb = stk[2].grad.cpu().numpy()
    worst = 0.0
    for i, pr in enumerate(probs):
        t = [torch.tensor(a, device=dev) for a in pr]
        t[2].requires_grad_(True)
        (torch.as_tensor(w, device=dev) * solve_diff(*t, s)).sum().backward()
        gi = t[2].grad.cpu().numpy()
        worst = max(worst, float(np.abs(gb[i] - gi).max()
                                 / np.abs(gi).max()))
    say(f"[front end (e)] a batch of 4 against four single calls: dq "
        f"relative {worst:.2e}")
    require(worst <= bar, f"solve_diff batch vs single: {worst:.3e}")


def phase_front_end(dev):
    """Phase 16: the single-problem front end on the card.  Returns
    (numbers, launches) of the kernels line's phase-16 rows: the MPC's and
    the randomQP's K2 kernels under names of their own (their counters'
    rows hold phases 14-15's shapes), the large pipeline's f32 wide
    kernels and the device polish's identity solve under their counters'
    names."""
    import numpy as np

    rng = np.random.default_rng(16)
    numbers, launches = {}, {}
    t = [time.perf_counter()]
    fe_quick_start(dev)
    t.append(time.perf_counter())

    for part, run, nb, n, names in (
            ("qpalm", fe_random_qp, 1, FE_QP[0],
             ("chol_global_wide_f64", "chol_solve_global_wide_f64")),
            ("mpc", fe_mpc, 1, FE_MPC_NPAD,
             ("chol_global_f64", "chol_solve_global_f64"))):
        rows = k2_rows(dev, rng, nb, n, "float64", names)
        la = run(dev, rows)
        for name, row in rows.items():
            numbers[f"{name}_{part}"] = row
            launches[f"{name}_{part}"] = la.get(name, 0)
        t.append(time.perf_counter())

    large_rows = k2_rows(dev, rng, FE_LARGE_B, FE_LARGE[0], "float32",
                         ("chol_global_wide", "chol_solve_global_wide"))
    cols_rows = k2_rows(dev, rng, FE_LARGE_B, FE_LARGE_POLISH[0], "float32",
                        (None, "chol_solve_global_cols"), identity=True)
    la_large, la_polish = fe_large(dev, large_rows, cols_rows)
    numbers.update(large_rows)
    numbers.update(cols_rows)
    for name in large_rows:
        launches[name] = la_large.get(name, 0)
    launches["chol_solve_global_cols"] = la_polish.get(
        "chol_solve_global_cols", 0)
    t.append(time.perf_counter())

    fe_diff(dev)
    t.append(time.perf_counter())
    say("[time] phase 16 " + ", ".join(
        f"({part}) {b - a:.1f} s" for part, a, b in zip("abcde", t, t[1:]))
        + f", in all {t[-1] - t[0]:.1f} s")
    return numbers, launches


def sparse_problem():
    """Phase 17's problem: scripts/bench_sparse.py:57-62's cg_class(SP_N,
    SP_M) with q and the bounds of its loop (:69-70), from SP_SEED."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(SP_SEED)
    n, m = SP_N, SP_M
    Q = sp.diags([2.0 * np.ones(n), -0.5 * np.ones(n - 1),
                  -0.5 * np.ones(n - 1)], [0, 1, -1]).tocsc()
    A = sp.random(m, n, density=5e-4, random_state=1,
                  data_rvs=rng.standard_normal).tocsc()
    q = rng.standard_normal(n)
    u = 1 + rng.random(m)
    return Q, A, q, -u, u


def sparse_referee(prob, x, y, c=0.0):
    """The host's f64 check of a sparse solution: (stationarity
    ||Qx + q + A'y||_inf, primal violation ||Ax - clip(Ax)||_inf, the
    objective)."""
    import numpy as np

    Q, A, q, bl, bu = prob
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    Ax = A @ x
    stat = float(np.abs(Q @ x + q + A.T @ y).max())
    prim = float(np.abs(Ax - np.clip(Ax, bl, bu)).max()) if Ax.size else 0.0
    return stat, prim, float(0.5 * x @ (Q @ x) + q @ x + c)


def sp_qpalm(dev, prob, precond):
    """QPALM(sparse=True) at f64, eps 1e-6, on the card with `precond`:
    (result, wall s, K2 launches, CG counts, device bytes the run added at
    its peak)."""
    import gc

    import torch

    from qpalm_tpu_torch import QPALM, Settings
    from qpalm_tpu_torch.linalg.cg import pcg

    s = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False,
                 cg_precond=precond, cg_block=SP_BLOCK)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pcg.calls = pcg.steps = pcg.iterations = 0
    res, wall, la = counted(lambda: QPALM(*prob, settings=s, sparse=True,
                                          device=dev).solve())
    peak = torch.cuda.max_memory_allocated() - base
    cg = dict(calls=pcg.calls, steps=pcg.steps,
              iterations=int(pcg.iterations))
    return res, wall, la, cg, peak


def sp_matvec(dev, prob):
    """The sparse matvec on the card: the port's row reduction twice (bit
    for bit) beside torch's CSR product (cuSPARSE), its stability between
    two calls printed, each timed."""
    import numpy as np
    import torch

    from qpalm_tpu_torch.linalg.sparse import from_scipy

    A = from_scipy(prob[1], np.float64, dev)
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(
        SP_N)).to(dev)
    y1, y2 = A.mv(v), A.mv(v)
    csr = A.csr()
    c1, c2 = csr @ v, csr @ v
    torch.cuda.synchronize()
    require(torch.equal(y1, y2), "sparse mv: two calls differ")
    dmax = (y1 - c1).abs().max().item()
    require(dmax <= 1e-12 * max(1.0, y1.abs().max().item()),
            f"sparse mv against torch's CSR product: {dmax:.3e}")
    say(f"[sparse (b) matvec] A ({SP_M}, {SP_N}), nnz {A.nnz}: the port's "
        f"row reduction {cuda_ms(lambda: A.mv(v), 50):.4f} ms, bit-stable "
        f"over two calls; torch's CSR mv {cuda_ms(lambda: csr @ v, 50):.4f}"
        f" ms, bit-stable over two calls: {torch.equal(c1, c2)}, max "
        f"|diff| to the port's {dmax:.2e}")


def phase_sparse(dev):
    """Phase 17: the large sparse path on the card.  Returns (numbers,
    launches) of the kernels line's block-Jacobi rows."""
    import numpy as np
    import torch

    from qpalm_tpu_torch import Settings, referee, solve, \
        solve_sparse_auto, sweep
    from qpalm_tpu_torch import constants as C
    from qpalm_tpu_torch.io import native as io_native
    from qpalm_tpu_torch.io.qps import load_qps_python
    from qpalm_tpu_torch.linalg import chol, sparse_direct
    from qpalm_tpu_torch.linalg.cg import pcg
    from qpalm_tpu_torch.workloads import SequentialMPC, mpc_chain

    t = [time.perf_counter()]
    rng = np.random.default_rng(17)
    nb = -(-SP_N // SP_BLOCK)
    names = ("chol_f64", "chol_solve_warp_f64")
    # (a) K2 at the block-Jacobi shapes
    rows = k2_rows(dev, rng, nb, SP_BLOCK, "float64", names)
    M32 = spd(rng, nb, SP_BLOCK, "float32", dev)
    b32 = torch.from_numpy(rng.standard_normal((nb, SP_BLOCK)).astype(
        np.float32)).to(dev)
    k2_against_twins(chol, M32, b32, f"block-Jacobi float32 ({nb}, "
                     f"{SP_BLOCK})")
    t.append(time.perf_counter())

    # (b) QPALM(sparse=True), Jacobi and block-Jacobi (twice)
    prob = sparse_problem()
    sp_matvec(dev, prob)
    runs = {}
    for label, precond in (("jacobi", "jacobi"),
                           ("block_jacobi", "block_jacobi"),
                           ("block_jacobi again", "block_jacobi")):
        res, wall, la, cg, peak = sp_qpalm(dev, prob, precond)
        stat, prim, _ = sparse_referee(prob, res.solution.x, res.solution.y)
        share = k2_share(la, rows)
        say(f"[sparse (b) QPALM {label}] n={SP_N} m={SP_M}: "
            f"{res.info.status}, {res.info.iter} iterations ({res.info.iter_out}"
            f" outer), CG {cg['iterations']} iterations in {cg['calls']} "
            f"solves ({cg['steps']} steps); wall {wall:.3f} s, K2 "
            f"{share:.3f} s of it ({100 * share / wall:.1f}%), launches "
            f"{la}; referee stationarity {stat:.2e}, primal {prim:.2e}; "
            f"peak device memory +{peak / 2 ** 20:.1f} MB")
        require(res.info.status == "solved", f"sparse {label}: "
                f"{res.info.status}")
        require(stat <= SP_TOL and prim <= SP_TOL,
                f"sparse {label}: stationarity {stat:.3e}, primal "
                f"{prim:.3e}")
        require(peak < SP_MEM_MB * 2 ** 20,
                f"sparse {label}: {peak / 2 ** 20:.1f} MB of device memory")
        runs[label] = (res, la)
    xj = runs["jacobi"][0].solution.x
    xb = runs["block_jacobi"][0].solution.x
    dx = float(np.abs(xj - xb).max())
    say(f"[sparse (b)] |x_jacobi - x_block_jacobi| {dx:.2e}; block-Jacobi "
        f"reruns bit-identical: "
        f"{np.array_equal(xb, runs['block_jacobi again'][0].solution.x)}")
    require(dx <= 1e-4, f"sparse: Jacobi and block-Jacobi x {dx:.3e} apart")
    require(np.array_equal(xb, runs["block_jacobi again"][0].solution.x),
            "sparse: two identical block-Jacobi runs differ")
    la = runs["block_jacobi"][1]
    for name in names:
        require(la.get(name, 0) > 0, f"block-Jacobi: {name} not launched: "
                f"{la}")
    numbers = {"chol_f64_bjacobi": rows["chol_f64"],
               "chol_solve_f64_bjacobi": rows["chol_solve_warp_f64"]}
    launches = {"chol_f64_bjacobi": la.get("chol_f64", 0),
                "chol_solve_f64_bjacobi": la.get("chol_solve_warp_f64", 0)}
    t.append(time.perf_counter())

    # (c) solve's route to solve_sparse_auto
    s6 = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)
    pcg.calls = 0
    solve_sparse_auto.route = None
    r, wall, la = counted(lambda: solve(*prob, settings=s6, device=dev))
    route, calls = solve_sparse_auto.route, pcg.calls
    # the route on the CPU: chosen before the solve, so one iteration shows
    solve_sparse_auto.route = None
    solve(*prob, settings=s6.replace(max_iter=1), device="cpu")
    cpu_route = solve_sparse_auto.route
    stat, prim, _ = sparse_referee(prob, r.solution.x, r.solution.y)
    say(f"[sparse (c) solve] route {route} (on the CPU {cpu_route}): "
        f"{r.info.status}, {r.info.iter} iterations, wall {wall:.3f} s, "
        f"CG solves on the card {calls}; referee stationarity {stat:.2e}, "
        f"primal {prim:.2e}; |x - x_block_jacobi| "
        f"{np.abs(r.solution.x - xb).max():.2e}")
    require(route is not None and route == cpu_route, f"solve: route "
            f"{route} on the card, {cpu_route} on the CPU")
    require(r.info.status == "solved" and stat <= SP_TOL and prim <= SP_TOL,
            f"solve: {r.info.status}, stationarity {stat:.3e}, primal "
            f"{prim:.3e}")
    if route == "cg":
        require(calls > 0 and pcg.iterations.device.type == "cuda",
                "solve: the CG route did not run on the card")
    t.append(time.perf_counter())

    # (d) the QPS files through both parsers, then solve_sparse_auto
    require(sparse_direct.load_library() is not None,
            "libqpalm_ldl: " + sparse_direct.unavailable_reason())
    require(io_native.load_library() is not None,
            "libqpalm_io: " + io_native.unavailable_reason())
    s7 = Settings(eps_abs=1e-7, eps_rel=1e-7, verbose=False, max_iter=5000)
    for name in ("CVXQP1_M", "CONT-100A"):
        path = str(Path(__file__).resolve().parent / "benchmarks" / "qps_mm"
                   / f"{name}.qps")
        p = load_qps_python(path)
        pn = io_native.load_qps_native(path)
        same = p.name == pn.name and p.c == pn.c and all(
            np.array_equal(getattr(p, f), getattr(pn, f))
            for f in ("q", "bmin", "bmax")) and all(
            (getattr(p, f) != getattr(pn, f)).nnz == 0 for f in ("Q", "A"))
        require(same, f"{name}: the two parsers differ")
        (rr, wall, la) = counted(lambda: solve_sparse_auto(
            p.Q, p.A, p.q, p.bmin, p.bmax, settings=s7, c=p.c, device=dev))
        pr = (p.Q, p.A, p.q, p.bmin, p.bmax)
        stat, prim, obj = sparse_referee(pr, rr.x, rr.y, p.c)
        say(f"[sparse (d) {name}] n={p.n} m={p.m}, parsers equal; route "
            f"{solve_sparse_auto.route}: {rr.status_str}, {rr.iterations} "
            f"iterations, objective {rr.objective:.8e} (host {obj:.8e}), "
            f"wall {wall:.3f} s; referee stationarity {stat:.2e}, primal "
            f"{prim:.2e}")
        require(rr.status_str == "solved" and stat <= SP_TOL
                and prim <= SP_TOL, f"{name}: {rr.status_str}, stationarity "
                f"{stat:.3e}, primal {prim:.3e}")
        if name == "CVXQP1_M":
            require(abs(rr.objective - CVXQP1_M_OPT) <= 1e-5 * CVXQP1_M_OPT,
                    f"CVXQP1_M objective {rr.objective} against "
                    f"{CVXQP1_M_OPT}")
    t.append(time.perf_counter())

    # (e) SequentialMPC through the host sparse lifecycle
    mpc = SequentialMPC(*SP_MPC, seed=0, backend="sparse", device=dev)
    Hn, An, qn = mpc_chain(*SP_MPC, seed=0)[:3]
    steps = []
    t0 = time.perf_counter()
    for _ in range(1 + SP_MPC_STEPS):
        bl, bu = mpc.bmin.copy(), mpc.bmax.copy()
        status, it, _ = mpc.step()
        x, y = mpc._prev
        viol = referee.check(Hn[None], An[None], qn[None], bl[None],
                             bu[None], np.zeros(1), x[None], y[None], 1e-6,
                             1e-6)[0][0]
        steps.append((status, it, viol))
    wall = time.perf_counter() - t0
    say(f"[sparse (e) SequentialMPC{SP_MPC} sparse] a cold step "
        f"({steps[0][1]} iterations) and {SP_MPC_STEPS} warm steps "
        f"(iterations {[st[1] for st in steps[1:]]}) in {wall:.3f} s; "
        f"referee worst violation {max(st[2] for st in steps):.3e} at 1e-6")
    require(all(st[0] == "solved" for st in steps),
            f"sparse MPC statuses {[st[0] for st in steps]}")
    require(all(st[2] <= 1.0 for st in steps), "sparse MPC referee")
    t.append(time.perf_counter())

    # (f) dense batches through CG, against the SCHUR run of phase 14
    wide = sweep.row_problems("randomQP", WIDE_N, batch=WIDE_B)
    schur, _, _ = general_solve(dev, wide, Settings(),
                                f"randomQP n={WIDE_N} Settings() SCHUR")
    pcg.calls = pcg.steps = pcg.iterations = 0
    cgr, wall, la = general_solve(
        dev, wide, Settings(factorization_method=C.FACTORIZE_CG),
        f"randomQP n={WIDE_N} Settings() CG")
    dx = (cgr.x - schur.x).abs().max().item()
    say(f"[sparse (f) solve_batch CG] randomQP n={WIDE_N} B={WIDE_B} f64: "
        f"solved {int((cgr.status == C.QPALM_SOLVED).sum())}, CG "
        f"{int(pcg.iterations)} iterations in {pcg.calls} solves "
        f"({pcg.steps} steps), |x_cg - x_schur| {dx:.2e} (bar "
        f"{DEFAULT_X_BAR:.0e})")
    require(bool((cgr.status == C.QPALM_SOLVED).all()),
            f"solve_batch CG: statuses {cgr.status.tolist()}")
    require(dx <= DEFAULT_X_BAR, f"solve_batch CG: x {dx:.3e} from SCHUR")
    t.append(time.perf_counter())
    say("[time] phase 17 " + ", ".join(
        f"({part}) {b - a:.1f} s" for part, a, b in zip("abcdef", t, t[1:]))
        + f", in all {t[-1] - t[0]:.1f} s")
    return numbers, launches


def stage_counted(fn):
    """counted(fn) with the K2 launches by shape too: (fn(), wall seconds,
    launches by kernel, launches by (kernel, B, n, k))."""
    from qpalm_tpu_torch.linalg import chol

    chol.KERNEL_SHAPES.clear()
    out, wall, la = counted(fn)
    return out, wall, la, dict(chol.KERNEL_SHAPES)


def solve_direct(R, b, cols, kind):
    """x of one launch of qp_chol_solve in `kind` with `cols` (columns a
    block, or the warp solve's warps a block) on contiguous f64 R and b,
    outside the wrapper and its counters: PR 15's entry kernel (kind 0)
    and the warp solve at another W, timed beside the plan's kernel."""
    import torch

    from qpalm_tpu_torch import _build
    from qpalm_tpu_torch.linalg import chol

    B, n = R.shape[:2]
    k = 1 if b.dim() == 2 else b.shape[2]
    x = torch.empty_like(b)
    rc = _build.kernels().qp_chol_solve(R.data_ptr(), b.data_ptr(),
                                        x.data_ptr(), B, n, k, cols, kind, 1,
                                        chol._stream())
    _build.check_launch("qp_chol_solve", rc)
    return x


def warp_alternatives(R, b, xp, key):
    """The f64 warp solve's alternatives at one shape, each held bit for
    bit to the twin's xp and timed: PR 15's entry kernel (qp_chol_solve
    kind 0, 64 columns a block) and the warp solve (kind 2) at every W of
    chol.WARP_W up to k.  Returns (entry ms, {W: ms})."""
    from qpalm_tpu_torch.linalg import chol

    k = 1 if b.dim() == 2 else b.shape[2]
    runs = {"entry": (min(k, 64), 0)}
    runs.update({w: (w, 2) for w in chol.WARP_W if w <= k})
    out = {}
    for tag, (cols, knd) in runs.items():
        x = solve_direct(R, b, cols, knd)
        require(bool((x == xp).all()), f"stage K2 {key}: qp_chol_solve "
                f"kind {knd} cols {cols} vs plain, "
                f"{int((x != xp).sum())} entries differ")
        out[tag] = cuda_ms(lambda: solve_direct(R, b, cols, knd), 5)
    return out.pop("entry"), out


def k2_shape_rows(dev, rng, shapes):
    """K2 at every (kernel, B, n, k) of `shapes` (k None: the factor), as
    a phase-18 run launched it: random SPD matrices and right-hand sides
    of that shape, the factor and each solve held bit for bit to the twins
    (the solve's residual too), the launch checked to count under that
    kernel, and each timed beside its twin, the library call and its
    bound; the f64 warp solve also beside PR 15's entry kernel and at its
    other W (warp_alternatives).  Returns {shape: row}."""
    import torch

    from qpalm_tpu_torch.linalg import chol

    rows = {}
    for B, n in sorted({(s[1], s[2]) for s in shapes}):
        keys = sorted((s for s in shapes if s[1:3] == (B, n)),
                      key=lambda s: -1 if s[3] is None else s[3])
        dtype = torch.float64 if keys[0][0].endswith("_f64") \
            else torch.float32
        es = 8 if dtype == torch.float64 else 4
        peak = F64_PEAK if dtype == torch.float64 else F32_PEAK
        M = spd(rng, B, n, "float64" if es == 8 else "float32", dev)
        chol.KERNEL_SHAPES.clear()
        R = chol.cholesky_upper(M)
        Rp = chol.cholesky_upper_plain(M)
        torch.cuda.synchronize()
        require(torch.equal(R, Rp), f"stage K2 ({B}, {n}): factor vs plain, "
                f"{int((R != Rp).sum())} entries differ")
        for key in keys:
            name, _, _, k = key
            if k is None:
                launched = chol.KERNEL_SHAPES.get(key, 0)
                fn = lambda: chol.cholesky_upper(M)  # noqa: E731
                plain = lambda: chol.cholesky_upper_plain(M)  # noqa: E731
                lib = lambda: torch.linalg.cholesky(M,  # noqa: E731
                                                    upper=True)
                work = bound(B * n ** 3 / 3, 2 * es * B * n * n, peak)
            else:
                shape = (B, n) if k == 1 else (B, n, k)
                b = torch.from_numpy(rng.standard_normal(shape)).to(
                    device=dev, dtype=dtype)
                chol.KERNEL_SHAPES.clear()
                x = chol.cholesky_solve(R, b)
                xp = chol.cholesky_solve_plain(R, b)
                torch.cuda.synchronize()
                launched = chol.KERNEL_SHAPES.get(key, 0)
                require(torch.equal(x, xp), f"stage K2 {key}: solve vs "
                        f"plain, {int((x != xp).sum())} entries differ")
                b3 = b if k > 1 else b[..., None]
                res = (M.double() @ x.double().reshape(b3.shape)
                       - b3.double()).abs().max().item() \
                    / M.double().abs().max().item()
                require(res < (1e-12 if es == 8 else 1e-3),
                        f"stage K2 {key}: solve residual {res:.3e}")
                fn = lambda: chol.cholesky_solve(R, b)  # noqa: E731
                plain = lambda: chol.cholesky_solve_plain(R, b)  # noqa: E731
                lib = lambda: torch.cholesky_solve(b3, R,  # noqa: E731
                                                   upper=True)
                work = bound(2 * B * n * n * k, es * B * (n * n + 2 * n * k),
                             peak)
            require(launched == 1, f"stage K2 {key}: the wrapper counted "
                    f"{dict(chol.KERNEL_SHAPES)}, not this kernel")
            rows[key] = dict(max_abs_err=0.0, ms=cuda_ms(fn, 5),
                             plain_ms=cuda_ms(plain, 1),
                             library_ms=cuda_ms(lib, 5), **work)
            r = rows[key]
            extra = ""
            if name.startswith("chol_solve_warp"):
                W = chol.solve_plan(B, n, k, dtype)[1]
                r["entry_ms"], r["w_ms"] = warp_alternatives(R, b, xp, key)
                extra = (f"; W = {W}; PR 15's entry kernel "
                         f"{r['entry_ms']:.4f} ms "
                         f"({r['entry_ms'] / r['ms']:.1f}x); by W "
                         + ", ".join(
                             f"{w}: {t:.4f}" for w, t in r["w_ms"].items()))
            say(f"[stage K2 {name} ({B}, {n}{'' if k is None else f', k={k}'}"
                f")] bit-identical to the twin; {r['ms']:.4f} ms (bound "
                f"{r['bound_ms']:.4f}, {r['bound_by']}; plain "
                f"{r['plain_ms']:.2f}; library {r['library_ms']:.4f}{extra})")
    return rows


def stage_share(shapes, rows):
    """Seconds of K2 in a run: its launches by shape times each shape's
    time."""
    return sum(c * rows[s]["ms"] for s, c in shapes.items()) / 1e3


def stage_referee(data, z, y_eq, y_box, eps):
    """The host f64 KKT check of referee.check on the unscaled stage data
    (the dynamics rows G z_k - Ap z_{k-1} = beq_k, G = [I -Bd], Ap = [Ad
    0], then the box rows): (violation, <= 1 passes; primal residual; dual
    residual)."""
    import numpy as np

    from qpalm_tpu_torch import constants as C

    H, q, beq, lo, hi, Ad, Bd = (np.asarray(a, float) for a in data)
    S, nb = q.shape
    nx = beq.shape[1]
    G = np.concatenate([np.eye(nx), -Bd], 1)
    Ap = np.concatenate([Ad, np.zeros((nx, nb - nx))], 1)
    z_prev = np.concatenate([np.zeros((1, nb)), z[:-1]])
    Aeq = z @ G.T - z_prev @ Ap.T
    zc = np.clip(z, np.maximum(lo, -C.QPALM_INFTY),
                 np.minimum(hi, C.QPALM_INFTY))
    pri = max(np.abs(Aeq - beq).max(), np.abs(z - zc).max())
    Hz = np.einsum("sij,sj->si", H, z)
    Aty = y_eq @ G + y_box
    Aty[:-1] -= y_eq[1:] @ Ap
    dua = np.abs(Hz + q + Aty).max()
    eps_pri = eps + eps * max(np.abs(Aeq).max(), np.abs(z).max(),
                              np.abs(beq).max(), np.abs(zc).max())
    eps_dua = eps + eps * max(np.abs(Hz).max(), np.abs(q).max(),
                              np.abs(Aty).max())
    comp = (np.where(y_box > eps, np.abs(z - hi), 0.0)
            + np.where(y_box < -eps, np.abs(z - lo), 0.0)).max()
    return max(pri / eps_pri, dua / eps_dua, comp / (eps_pri + eps)), pri, \
        dua


def st_stage_qp(dev):
    """Phase 18 (a): QPALM with FACTORIZE_STAGE on the stage-permuted
    mpc_chain(*ST_QP) against the same problem under SCHUR.  Returns the
    STAGE run's (wall, launches by kernel, by shape)."""
    import numpy as np

    from qpalm_tpu_torch import QPALM, Settings
    from qpalm_tpu_torch import constants as C
    from qpalm_tpu_torch.workloads import mpc_chain, mpc_stage_permutation

    H, A, q, bmin, bmax, meta = mpc_chain(*ST_QP, seed=0)
    nx, nu, N = meta["nx"], meta["nu"], meta["N"]
    perm = mpc_stage_permutation(nx, nu, N)
    p = (H[np.ix_(perm, perm)], A[:, perm], q[perm], bmin, bmax)
    base = dict(eps_abs=1e-6, eps_rel=1e-6, proximal=False, scaling=2,
                verbose=False)
    out = {}
    for label, s in (("STAGE", Settings(
            factorization_method=C.FACTORIZE_STAGE, stage_block=nx + nu,
            **base)), ("SCHUR", Settings(**base))):
        solver = QPALM(*p, settings=s, device=dev)
        out[label] = stage_counted(solver.solve)
    (rs, ws, las, shs), (rd, wd, lad, shd) = out["STAGE"], out["SCHUR"]
    dx = float(np.abs(rs.solution.x - rd.solution.x).max())
    say(f"[stage (a) QPALM mpc_chain{ST_QP}] n={H.shape[0]} m={A.shape[0]} "
        f"nb={nx + nu}: STAGE {rs.info.status}, {rs.info.iter} iterations, "
        f"{ws:.3f} s, K2 launches {las}; SCHUR {rd.info.status}, "
        f"{rd.info.iter} iterations, {wd:.3f} s, K2 launches {lad}; |x_stage "
        f"- x_schur| {dx:.2e}")
    require(rs.info.status == rd.info.status == "solved",
            f"stage (a): {rs.info.status}, {rd.info.status}")
    require(rs.info.iter == rd.info.iter, f"stage (a): iterations "
            f"{rs.info.iter} and {rd.info.iter}")
    require(dx <= 1e-8, f"stage (a): x {dx:.3e} apart")
    require(all(k[0] in ("chol_f64", "chol_solve_warp_f64",
                         "chol_solve_warp_cols_f64") for k in shs),
            f"stage (a): STAGE launched {shs}")
    return ws, las, shs, wd, shd


def st_sequential(dev):
    """Phase 18 (b): SequentialMPC(*ST_SEQ) stage-structured against the
    unstructured one, ST_SEQ_STEPS steps: the iterations equal at every
    step, the plant's states within 1e-8.  Returns the structured run's
    (wall, shapes) and the unstructured run's shapes."""
    import numpy as np

    from qpalm_tpu_torch.workloads import SequentialMPC

    runs = {}
    for label, st in (("structured", True), ("unstructured", False)):
        mpc = SequentialMPC(*ST_SEQ, seed=0, stage_structured=st,
                            device=dev)
        its, wall, la, sh = stage_counted(lambda: mpc.run(ST_SEQ_STEPS))
        runs[label] = (mpc, its, wall, la, sh)
    (m1, i1, w1, l1, s1), (m2, i2, w2, l2, s2) = runs["structured"], \
        runs["unstructured"]
    dx = float(np.abs(m1.x - m2.x).max())
    say(f"[stage (b) SequentialMPC{ST_SEQ}] {ST_SEQ_STEPS} steps: structured "
        f"{w1:.3f} s ({ST_SEQ_STEPS / w1:.1f} solves/s), unstructured "
        f"{w2:.3f} s ({ST_SEQ_STEPS / w2:.1f}); iterations {i1}; plant "
        f"states {dx:.2e} apart; K2 launches structured {l1}, unstructured "
        f"{l2}")
    require(i1 == i2, f"stage (b): iterations {i1} and {i2}")
    require(dx <= 1e-8, f"stage (b): plant states {dx:.3e} apart")
    return w1, s1, s2


def st_sharded(dev):
    """Phase 18 (c): solve_mpc_stage_sharded on mpc_chain_stage_data(
    *ST_CHAIN) over LocalMesh(ST_MESH), LocalMesh(4) and LocalMesh(1),
    each refereed; spike_solve's gathered interface at ST_SPIKE.  Returns
    {nd: (wall, shapes)}, LocalMesh(ST_MESH)'s iterations and every run's
    shapes."""
    import numpy as np
    import torch

    from qpalm_tpu_torch import Settings
    from qpalm_tpu_torch.parallel import LocalMesh
    from qpalm_tpu_torch.parallel.block_tridiag import spike_solve, \
        thomas_solve
    from qpalm_tpu_torch.parallel.mpc_loop import mpc_chain_stage_data, \
        solve_mpc_stage_sharded

    data = mpc_chain_stage_data(*ST_CHAIN, seed=0)
    S, nb = data.q.shape
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, scaling=2)
    runs, all_shapes = {}, {}
    for nd in (ST_MESH, 4, 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        r, wall, la, sh = stage_counted(lambda: solve_mpc_stage_sharded(
            data, s, LocalMesh(nd, device=dev)))
        peak = torch.cuda.max_memory_allocated() - mem0
        viol, pri, dua = stage_referee(data, r.z.cpu().numpy(),
                                       r.y_eq.cpu().numpy(),
                                       r.y_box.cpu().numpy(), 1e-6)
        it = int(r.iterations)
        say(f"[stage (c) LocalMesh({nd}) mpc_chain_stage_data{ST_CHAIN}] "
            f"nb={nb} S={S} n={S * nb}: status {int(r.status)}, {it} "
            f"iterations, {wall:.3f} s = {1e3 * wall / max(it, 1):.2f} ms an "
            f"iteration; referee violation {viol:.3f} (primal {pri:.2e}, "
            f"dual {dua:.2e}); peak device memory +{peak / 2 ** 20:.1f} MB; "
            f"K2 launches {la}")
        require(int(r.status) == 1, f"stage (c) LocalMesh({nd}): status "
                f"{int(r.status)}")
        require(viol <= 1.0, f"stage (c) LocalMesh({nd}): referee "
                f"violation {viol:.3f}")
        runs[nd] = (r, wall, it, sh)
        for k, c in sh.items():
            all_shapes[k] = all_shapes.get(k, 0) + c
    it8 = runs[ST_MESH][2]
    for nd in (4, 1):
        require(abs(runs[nd][2] - it8) <= ST_ITER_SPREAD,
                f"stage (c): LocalMesh({nd}) {runs[nd][2]} iterations, "
                f"LocalMesh({ST_MESH}) {it8} (spread {ST_ITER_SPREAD})")
    dz = float((runs[1][0].z - runs[ST_MESH][0].z).abs().max())
    say(f"[stage (c)] |z_mesh{ST_MESH} - z_mesh1| {dz:.2e}; iterations "
        f"{[runs[nd][2] for nd in (ST_MESH, 4, 1)]} (spread "
        f"{ST_ITER_SPREAD} allowed)")

    Ssp, nbsp, ndsp = ST_SPIKE
    rng = np.random.default_rng(18)
    D = rng.standard_normal((Ssp, nbsp, nbsp))
    D = D @ D.transpose(0, 2, 1) + 5 * np.eye(nbsp)
    E = 0.3 * rng.standard_normal((Ssp, nbsp, nbsp))
    E[-1] = 0
    D, E, b = (torch.from_numpy(a).to(dev) for a in (
        D, E, rng.standard_normal((Ssp, nbsp))))
    (x_sp, x_th), _, _, sh = stage_counted(lambda: (
        spike_solve(D, E, b, LocalMesh(ndsp, device=dev)),
        thomas_solve(D, E[:-1], b)))
    err = float((x_sp - x_th).abs().max() / x_th.abs().max())
    say(f"[stage (c) spike_solve nd={ndsp} (the gathered interface)] "
        f"S={Ssp} "
        f"nb={nbsp}: against block Thomas {err:.2e} relative")
    require(err <= 1e-10, f"stage (c) spike nd={ndsp}: {err:.3e}")
    for k, c in sh.items():
        all_shapes[k] = all_shapes.get(k, 0) + c
    return {nd: (w, sh) for nd, (_, w, _, sh) in runs.items()}, it8, \
        all_shapes


def st_dist(dev):
    """Phase 18 (d): DistMesh at world size 1 over NCCL on the card:
    spike_solve and the stage loop at horizon ST_DIST_HORIZON bit for bit
    against LocalMesh(1), solve_batch_sharded on ST_DP randomQPs lane for
    lane against solve_batch(use_fused="never").  Returns the shapes."""
    import tempfile
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    from qpalm_tpu_torch import Settings
    from qpalm_tpu_torch import constants as C
    from qpalm_tpu_torch.batch import solve_batch, stack_problems
    from qpalm_tpu_torch.parallel import DistMesh, LocalMesh, \
        solve_batch_sharded
    from qpalm_tpu_torch.parallel import dryrun as dr
    from qpalm_tpu_torch.parallel.block_tridiag import spike_solve
    from qpalm_tpu_torch.parallel.mpc_loop import mpc_chain_stage_data, \
        solve_mpc_stage_sharded
    from qpalm_tpu_torch.workloads import random_qp

    shapes = {}
    # the dry run over 2 gloo processes on the host's CPU, bit for bit
    # against LocalMesh(2)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        checked = dr.dryrun_processes(2, tmp, timeout=120.0)
        say(f"[stage (d) dry run] 2 gloo processes bit-identical to "
            f"LocalMesh(2) on {len(checked)} results in "
            f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1,
                                timeout=timedelta(seconds=60))
        try:
            mesh = DistMesh()
            require(mesh.device.type == "cuda", f"DistMesh on {mesh.device}")
            Ssp, nbsp, _ = ST_SPIKE
            rng = np.random.default_rng(19)
            D = rng.standard_normal((Ssp, nbsp, nbsp))
            D = D @ D.transpose(0, 2, 1) + 5 * np.eye(nbsp)
            D, E, b = (torch.from_numpy(a).to(dev) for a in (
                D, 0.3 * rng.standard_normal((Ssp, nbsp, nbsp)),
                rng.standard_normal((Ssp, nbsp))))
            x1 = spike_solve(D, E, b, LocalMesh(1, device=dev))
            x2 = spike_solve(D, E, b, mesh)
            require(torch.equal(x1, x2), "stage (d): spike_solve on "
                    "DistMesh(1) differs from LocalMesh(1)")
            data = mpc_chain_stage_data(ST_CHAIN[0], ST_DIST_HORIZON, seed=0)
            s = Settings(eps_abs=1e-6, eps_rel=1e-6, scaling=2)
            r1, w1, _, sh1 = stage_counted(lambda: solve_mpc_stage_sharded(
                data, s, LocalMesh(1, device=dev)))
            r2, w2, _, _ = stage_counted(lambda: solve_mpc_stage_sharded(
                data, s, mesh))
            same = all(torch.equal(a, b_) for a, b_ in zip(r1, r2))
            say(f"[stage (d) DistMesh(1) over NCCL] spike_solve bit-identical"
                f"; the loop at horizon {ST_DIST_HORIZON}: status "
                f"{int(r2.status)}, {int(r2.iterations)} iterations, "
                f"{w2:.3f} s (LocalMesh(1) {w1:.3f} s), every field "
                f"bit-identical: {same}")
            require(same and int(r2.status) == 1, "stage (d): the loop on "
                    "DistMesh(1) differs from LocalMesh(1)")
            B, n = ST_DP
            probs = [random_qp(n, seed=i) for i in range(B)]
            data = stack_problems(probs, np.float64, device=dev)
            sd = Settings()
            gamma = torch.full((B,), sd.gamma_init, dtype=torch.float64,
                               device=dev)
            (res, agg), w3, _, sh3 = stage_counted(lambda: solve_batch_sharded(
                data, torch.zeros_like(data.q), torch.zeros_like(data.bmin),
                gamma, sd, False, False, mesh))
            ref, w4, _, _ = stage_counted(lambda: solve_batch(
                probs, sd.replace(use_fused="never"), device=dev))
            n_ok = int((ref.status == C.QPALM_SOLVED).sum())
            say(f"[stage (d) solve_batch_sharded] {B} randomQPs n={n} f64 "
                f"Settings(): {w3:.3f} s (solve_batch {w4:.3f} s); aggregates "
                f"n_solved {int(agg['n_solved'])}, total_iters "
                f"{int(agg['total_iters'])}, max_iters "
                f"{int(agg['max_iters'])}")
            require(torch.equal(res.x, ref.x) and torch.equal(
                res.iterations, ref.iterations) and torch.equal(
                res.status, ref.status), "stage (d): solve_batch_sharded "
                "differs from solve_batch lane for lane")
            require(int(agg["n_solved"]) == n_ok and int(agg["total_iters"])
                    == int(ref.iterations.sum()) and int(agg["max_iters"])
                    == int(ref.iterations.max()),
                    f"stage (d): aggregates {agg}")
            # the dry run's three paths on the card, NCCL against LocalMesh
            want = dr.dryrun(LocalMesh(1, device=dev))
            try:
                dr.compare(want, dr.dryrun(mesh), 0, 1)
                same = True
            except AssertionError as err:
                same = str(err)
            say(f"[stage (d) dry run on the card] DistMesh(1) over NCCL "
                f"bit-identical to LocalMesh(1): {same}")
            require(same is True, f"stage (d) dry run: {same}")
        finally:
            dist.destroy_process_group()
    for sh in (sh1, sh3):
        for k, c in sh.items():
            shapes[k] = shapes.get(k, 0) + c
    return shapes


def hold_warp_shapes(dev, rng, shapes):
    """Every f64 warp-solve shape of `shapes` (kernel, B, n, k), on random
    SPD matrices and right-hand sides, held bit for bit to the twin.
    Returns the shapes held."""
    import torch

    from qpalm_tpu_torch.linalg import chol

    held = sorted(s for s in shapes if s[0].startswith("chol_solve_warp"))
    for name, B, n, k in held:
        R = chol.cholesky_upper(spd(rng, B, n, "float64", dev))
        b = torch.from_numpy(rng.standard_normal(
            (B, n) if k == 1 else (B, n, k))).to(dev)
        x, xp = chol.cholesky_solve(R, b), chol.cholesky_solve_plain(R, b)
        torch.cuda.synchronize()
        require(torch.equal(x, xp), f"{name} ({B}, {n}, k={k}): solve vs "
                f"plain, {int((x != xp).sum())} entries differ")
    return held


def phase_constraint_sharded(dev):
    """Phase 19: constraint sharding on the card.  Returns (numbers,
    launches) of the kernels line's rows _schur_*: K2 at every shape the
    phase's sharded runs launched, with their launches."""
    import numpy as np

    from qpalm_tpu_torch import api, referee
    from qpalm_tpu_torch import constants as C
    from qpalm_tpu_torch.parallel import LocalMesh, solve_constraint_sharded
    from qpalm_tpu_torch.types import Settings
    from qpalm_tpu_torch.workloads import random_qp

    t = [time.perf_counter()]
    n, m = CS_QP
    p = tuple(np.asarray(a, np.float64) for a in random_qp(n, m, seed=0))
    s = Settings(eps_abs=EPS_TARGET, eps_rel=EPS_TARGET,
                 factorization_method=C.FACTORIZE_SCHUR, verbose=False)
    r, wall, _, sh = stage_counted(lambda: api.solve(*p, settings=s,
                                                     device=dev))
    require(r.info.status == "solved", f"constraint sharding: the unsharded "
            f"solve {r.info.status}")
    x0, it0 = np.asarray(r.solution.x), int(r.info.iter)
    runs = {"unsharded": (wall, it0, sh)}
    every = dict(sh)
    for k in CS_MESHES:
        mesh = LocalMesh(k, device=dev)
        (x, y, st, it, obj), wall, _, sh = stage_counted(
            lambda: solve_constraint_sharded(p + (np.zeros(()),), s, mesh))
        x, y, it = x.cpu().numpy(), y.cpu().numpy(), int(it)
        v = referee.check(*(a[None] for a in p), np.zeros(1), x[None],
                          y[None], EPS_TARGET, EPS_TARGET)[0][0]
        dx = np.abs(x - x0).max() / max(1.0, np.abs(x0).max())
        say(f"[constraint sharding] LocalMesh({k}): status {int(st)}, "
            f"{it} iterations (unsharded {it0}), |dx| {dx:.3e} of the "
            f"unsharded x, referee violation {v:.3e}, objective "
            f"{float(obj):.10e}")
        require(int(st) == C.QPALM_SOLVED, f"LocalMesh({k}): status "
                f"{int(st)}")
        require(abs(it - it0) <= CS_ITER_SPREAD, f"LocalMesh({k}): {it} "
                f"iterations against {it0} unsharded")
        require(dx <= CS_X_BAR, f"LocalMesh({k}): |dx| {dx:.3e}")
        require(v <= 1.0, f"LocalMesh({k}): referee violation {v:.3e}")
        runs[f"LocalMesh({k})"] = (wall, it, sh)
        for key, c in sh.items():
            every[key] = every.get(key, 0) + c
    t.append(time.perf_counter())
    rows = k2_shape_rows(dev, np.random.default_rng(190), every)
    t.append(time.perf_counter())
    for label, (wall, it, sh) in runs.items():
        share = stage_share(sh, rows)
        say(f"[constraint sharding] {label}: {wall:.3f} s, {it} iterations, "
            f"{1e3 * wall / max(it, 1):.2f} ms an iteration; K2 "
            f"{share:.3f} s ({100 * share / wall:.1f}%), launches by shape "
            + ", ".join(f"{k[0]} ({k[1]}, {k[2]}"
                        + ("" if k[3] is None else f", k={k[3]}") + f") {c}"
                        for k, c in sorted(sh.items(), key=str)))
    numbers, launches = {}, {}
    sharded = {}
    for label, (_, _, sh) in runs.items():
        if label != "unsharded":
            for key, c in sh.items():
                sharded[key] = sharded.get(key, 0) + c
    for key, count in sharded.items():
        name, B, nn, k = key
        row = f"{name}_schur_{B}x{nn}" + ("" if k is None else f"x{k}")
        numbers[row] = rows[key]
        launches[row] = count
    require(numbers, "constraint sharding launched no K2 kernel")
    say("[time] phase 19 " + ", ".join(
        f"({part}) {b - a:.1f} s" for part, a, b in zip(
            ("solves", "K2 rows"), t, t[1:]))
        + f", in all {t[-1] - t[0]:.1f} s")
    return numbers, launches


def entry_f32_row(dev):
    """K2b's entry plan at f32 (chol_solve_kernel<float>) at ENTRY_F32, one
    vector: through chol.cholesky_solve (qp_chol_solve, kind 0), bit for
    bit against its twin, timed beside the twin, torch.cholesky_solve and
    its bound.  Returns its row."""
    import numpy as np
    import torch

    from qpalm_tpu_torch.linalg import chol

    B, n = ENTRY_F32
    require(chol.solve_plan(B, n, 1, torch.float32)[0] == "entry",
            f"f32 ({B}, {n}) is not the entry plan")
    rng = np.random.default_rng(61)
    R = chol.cholesky_upper(spd(rng, B, n, "float32", dev))
    b = torch.from_numpy(rng.standard_normal((B, n)).astype(np.float32)) \
        .to(dev)
    chol.KERNEL_SHAPES.clear()
    x = chol.cholesky_solve(R, b)
    xp = chol.cholesky_solve_plain(R, b)
    torch.cuda.synchronize()
    require(dict(chol.KERNEL_SHAPES) == {("chol_solve", B, n, 1): 1},
            f"entry f32: counted {dict(chol.KERNEL_SHAPES)}")
    require(torch.equal(x, xp), f"entry f32 ({B}, {n}): solve vs plain, "
            f"{int((x != xp).sum())} entries differ")
    row = dict(max_abs_err=0.0, ms=cuda_ms(lambda: chol.cholesky_solve(R, b),
                                           20),
               plain_ms=cuda_ms(lambda: chol.cholesky_solve_plain(R, b), 1),
               library_ms=cuda_ms(lambda: torch.cholesky_solve(
                   b[..., None], R, upper=True), 20),
               **bound(2 * B * n * n, 4 * B * (n * n + 2 * n), F32_PEAK))
    say(f"[K2b entry f32 ({B}, {n}), one vector] chol_solve_kernel<float> "
        f"bit-identical to the twin; {row['ms']:.4f} ms (bound "
        f"{row['bound_ms']:.4f}, {row['bound_by']}; plain "
        f"{row['plain_ms']:.2f}; torch.cholesky_solve "
        f"{row['library_ms']:.4f}); launches on phases 3-19's paths: none "
        f"(their n are multiples of 8)")
    return row


def phase_stage(dev):
    """Phase 18: the stage-structured path on the card.  Returns (numbers,
    launches) of the kernels line's rows: K2 at (a)'s STAGE shapes and at
    (c)'s LocalMesh(ST_MESH) and LocalMesh(1) shapes."""
    import numpy as np

    t = [time.perf_counter()]
    wa, la_a, sh_a, wd_a, sh_schur = st_stage_qp(dev)
    t.append(time.perf_counter())
    wb, sh_b, sh_b2 = st_sequential(dev)
    t.append(time.perf_counter())
    runs_c, itc, sh_call = st_sharded(dev)
    wc, sh_c = runs_c[ST_MESH]
    t.append(time.perf_counter())
    sh_d = st_dist(dev)
    t.append(time.perf_counter())

    every = {}
    for sh in (sh_a, sh_schur, sh_b, sh_b2, sh_call, sh_d):
        for k, c in sh.items():
            every[k] = every.get(k, 0) + c
    rows = k2_shape_rows(dev, np.random.default_rng(180), every)
    t.append(time.perf_counter())
    for label, wall, sh in (("(a) STAGE", wa, sh_a),
                            ("(a) SCHUR", wd_a, sh_schur),
                            ("(b) structured", wb, sh_b),
                            *((f"(c) LocalMesh({nd})", *runs_c[nd])
                              for nd in runs_c)):
        share = stage_share(sh, rows)
        say(f"[stage] {label}: K2 {share:.3f} s of {wall:.3f} s "
            f"({100 * share / wall:.1f}%), launches by shape "
            + ", ".join(f"{k[0]} ({k[1]}, {k[2]}"
                        + ("" if k[3] is None else f", k={k[3]}") + f") {c}"
                        for k, c in sorted(sh.items(), key=str)))
    say(f"[stage (c)] LocalMesh({ST_MESH}): {itc} iterations, "
        f"{1e3 * wc / max(itc, 1):.2f} ms an iteration")
    numbers, launches = {}, {}
    # rows keep PR 15's names (the warp solve took over the entry plan's
    # shapes): _stage_ (a)'s STAGE, _spike_ (c)'s LocalMesh(ST_MESH),
    # _mesh1_ (c)'s LocalMesh(1)
    for tag, sh in (("stage", sh_a), ("spike", sh_c),
                    ("mesh1", runs_c[1][1])):
        for key, count in sh.items():
            name, B, n, k = key
            if name.startswith("chol_solve_warp"):
                name = "chol_solve_f64"
            row = f"{name}_{tag}_{B}x{n}" + ("" if k is None else f"x{k}")
            numbers[row] = rows[key]
            launches[row] = count
    say("[time] phase 18 " + ", ".join(
        f"({part}) {b - a:.1f} s" for part, a, b in zip(
            ("a", "b", "c", "d", "K2 rows"), t, t[1:]))
        + f", in all {t[-1] - t[0]:.1f} s")
    return numbers, launches


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA card")
    root = Path(__file__).resolve().parent
    if not (root / "qpalm_tpu_torch" / "__init__.py").exists():
        fail(f"qpalm_tpu_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(root))

    import numpy as np

    from qpalm_tpu_torch import _build, baseline_c, bench, referee
    from qpalm_tpu_torch.batch import stack_problems
    from qpalm_tpu_torch.linalg import chol
    from qpalm_tpu_torch.polish_device import polish_batch
    from qpalm_tpu_torch.precision import full_f32_matmul
    from qpalm_tpu_torch.solver import fused as F
    from qpalm_tpu_torch.types import QPData, Settings
    from qpalm_tpu_torch.workloads import make_problems

    dev = torch.device("cuda")
    full_f32_matmul()

    # ---- 1. environment ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    require(smi, "nvidia-smi printed nothing")
    smi_line = smi[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    say(f"[env] nvcc: {nvcc[-1] if nvcc else 'unknown'}")
    say(f"[env] nvidia-smi: {smi_line}")
    ldc = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    libs = [ln.strip() for ln in ldc if re.search(r"liblapack|libblas", ln)]
    say(f"[env] ldconfig LAPACK/BLAS: {'; '.join(libs) or 'none'}")

    # ---- 2. build ----
    # g++ builds the three native libraries while nvcc builds the kernels
    from concurrent.futures import ThreadPoolExecutor

    from qpalm_tpu_torch.io import native as io_native
    from qpalm_tpu_torch.linalg import sparse_direct

    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(3)
    native = {name: pool.submit(lambda f=f: (f(), time.perf_counter() - t0))
              for name, f in (("C baseline", baseline_c.load_library),
                              ("libqpalm_ldl", sparse_direct.load_library),
                              ("libqpalm_io", io_native.load_library))}
    lib_path, log = _build.build(verbose=True)
    _build.kernels()
    say(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            say(f"[build] {line.strip()}")
    for entry, (regs, st, ld) in ptxas_summary(log).items():
        for key, label in KERNEL_NAMES:
            if key in entry:
                hit = re.search(r"global_kernelI([fd])Li(\d+)E", entry)
                if hit:  # the global solve, an instantiation an E
                    label += (f" {'f32' if hit[1] == 'f' else 'f64'}, E = "
                              f"{hit[2]}")
                    require(st == 0 and ld == 0, f"{label} spills")
                # the grid factor, the stripe solve and the warp solve in
                # the shapes the plans launch
                if label.startswith("K2b f64 warp solve") or label in (
                        f"K2a grid f{d}, panels of {b}" for d in (32, 64)
                        for b in (chol.GRID_B, chol.GRID_B_WIDE)) \
                        or label in (
                        f"K2b stripe f{32 if dt == torch.float32 else 64}, "
                        f"stripes of {w}" for dt, w in chol.STRIPE_W.items()):
                    require(st == 0 and ld == 0, f"{label} spills")
                say(f"[build] {label}: {regs} registers, {st} bytes spill "
                    f"stores, {ld} bytes spill loads")

    why = {"C baseline": baseline_c.unavailable_reason,
           "libqpalm_ldl": sparse_direct.unavailable_reason,
           "libqpalm_io": io_native.unavailable_reason}
    for name, fut in native.items():
        lib, secs = fut.result()
        require(lib is not None, f"{name} does not build: {why[name]()}")
        say(f"[build] {name} ({Path(lib._name).name}) built and loaded "
            f"{secs:.1f} s after the start")
    pool.shutdown()
    say(f"[build] the C baseline links {baseline_c.linked_blas()}")

    numbers = {}

    # ---- 3. K2 against its plain twin ----
    rng = np.random.default_rng(0)
    G = rng.standard_normal((B, N, N)).astype(np.float32)
    M_spd = torch.from_numpy(
        G @ np.transpose(G, (0, 2, 1)) + N * np.eye(N, dtype=np.float32)
    ).to(dev)
    R = chol.cholesky_upper(M_spd)
    Rp = chol.cholesky_upper_plain(M_spd)
    torch.cuda.synchronize()
    R64 = R.double()
    rel = ((R64.transpose(1, 2) @ R64 - M_spd.double()).abs().max()
           / M_spd.double().abs().max()).item()
    diff = ((R - Rp).abs().max() / Rp.abs().max()).item()
    require(torch.equal(R, torch.triu(R)), "K2 factor is not upper")
    require(rel < 1e-5, f"K2 max|R'R-M|/max|M| = {rel:.3e}")
    # the factor keeps every entry's arithmetic of its twin: bit for bit
    require(torch.equal(R, Rp), f"K2 factor vs plain: rel diff {diff:.3e}, "
            f"{int((R != Rp).sum())} entries differ")
    eye = torch.eye(N, device=dev).expand(B, N, N).contiguous()
    X = chol.cholesky_solve(R, eye)
    Xp = chol.cholesky_solve_plain(R, eye)
    torch.cuda.synchronize()
    res = (M_spd.double() @ X.double() - eye.double()).abs().max().item()
    sdiff = ((X - Xp).abs().max() / Xp.abs().max()).item()
    require(res < 1e-4, f"K2 solve residual {res:.3e}")
    # the solve sums in its twin's order: bit for bit
    require(torch.equal(X, Xp), f"K2 solve vs plain: rel diff {sdiff:.3e}, "
            f"{int((X != Xp).sum())} entries differ")
    # the polish's second round solves 64 matrices at a time
    R64, eye64 = R[:64].contiguous(), eye[:64].contiguous()
    require(torch.equal(chol.cholesky_solve(R64, eye64),
                        chol.cholesky_solve_plain(R64, eye64)),
            "K2 solve vs plain at B=64 differs")
    ms64 = cuda_ms(lambda: chol.cholesky_solve(R64, eye64), 20)
    # bounds: the factor n^3/3 operations and M in, R out; the solve with n
    # right-hand sides 2 n^3 and R, b in, x out.  The library calls that
    # compute the same functions are timed as yardsticks only.
    numbers["chol"] = dict(
        max_abs_err=(R - Rp).abs().max().item(),
        ms=cuda_ms(lambda: chol.cholesky_upper(M_spd), 20),
        plain_ms=cuda_ms(lambda: chol.cholesky_upper_plain(M_spd), 3),
        library_ms=cuda_ms(lambda: torch.linalg.cholesky(M_spd, upper=True),
                           20),
        **bound(B * N ** 3 / 3, 8 * B * N * N))
    numbers["chol_solve"] = dict(
        max_abs_err=(X - Xp).abs().max().item(),
        ms=cuda_ms(lambda: chol.cholesky_solve(R, eye), 20),
        plain_ms=cuda_ms(lambda: chol.cholesky_solve_plain(R, eye), 3),
        library_ms=cuda_ms(lambda: torch.cholesky_solve(eye, R, upper=True),
                           20),
        **bound(2 * B * N ** 3, 12 * B * N * N))
    say(f"[K2] factor rel {rel:.2e}, vs plain {diff:.2e}; identity solve "
        f"residual {res:.2e}, vs plain {sdiff:.2e}; factor "
        f"{numbers['chol']['ms']:.4f} ms (plain "
        f"{numbers['chol']['plain_ms']:.3f}, torch.linalg.cholesky "
        f"{numbers['chol']['library_ms']:.4f}), solve "
        f"{numbers['chol_solve']['ms']:.4f} ms (plain "
        f"{numbers['chol_solve']['plain_ms']:.3f}, torch.cholesky_solve "
        f"{numbers['chol_solve']['library_ms']:.4f}) at ({B}, {N}, {N}); "
        f"solve at (64, {N}, {N}) {ms64:.4f} ms, bit-identical")

    # ---- 4. K1 against its plain twin ----
    s32 = Settings(dtype="float32", eps_abs=5e-5, eps_rel=5e-5, max_iter=96,
                   scaling=2, max_refine=0, delta=10.0)  # bench.py:194-197
    probs = make_problems(B, N, M, seed=7)
    d32 = stack_problems(probs, np.float32, device=dev)
    sd, scal, st = F._prepare(d32, s32)
    T = s32.max_iter
    st_k = F.fused_palm(sd, scal, st, T, s32)
    st_k2 = F.fused_palm(sd, scal, st, T, s32)
    st_p = F.fused_palm_plain(sd, scal, st, T, s32)
    torch.cuda.synchronize()
    k_np = [a.cpu().numpy() for a in F._finish(sd, scal, st_k)]
    p_np = [a.cpu().numpy() for a in F._finish(sd, scal, st_p)]
    require(all(torch.equal(a, b) for a, b in zip(st_k2, st_k)),
            "K1 rerun not bit-identical")
    # the on-chip kernel keeps every entry's arithmetic of its twin: every
    # sc row, x, y and the rest of the state bit for bit on every lane
    sc_k, sc_p = st_k.sc.cpu().numpy(), st_p.sc.cpu().numpy()
    rows_eq = int((sc_k == sc_p).all(1).sum())
    lanes_eq = int(np.logical_and.reduce(
        [(a.cpu().numpy() == b.cpu().numpy()).reshape(B, -1).all(1)
         for a, b in zip(st_k, st_p)]).sum())
    dx = float(np.abs(k_np[0] - p_np[0]).max())
    require(rows_eq == B, f"K1: all 18 sc rows bit-equal on {rows_eq}/{B} "
            f"(statuses {int((k_np[2] == p_np[2]).sum())}, iteration counts "
            f"{int((k_np[3] == p_np[3]).sum())})")
    require(lanes_eq == B and all(torch.equal(a, b)
                                  for a, b in zip(st_k, st_p)),
            f"K1: the whole state bit-equal on {lanes_eq}/{B} lanes, max|dx| "
            f"{dx:.3e}")
    numbers["fused_palm"] = dict(
        max_abs_err=dx,
        ms=cuda_ms(lambda: F.fused_palm(sd, scal, st, T, s32), 5),
        plain_ms=cuda_ms(lambda: F.fused_palm_plain(sd, scal, st, T, s32),
                         1),
        library_ms=None, **k1_bound(B, N, M, k_np[3].sum()))
    solved = int((k_np[2] == 1).sum())
    say(f"[K1] the whole state bit-equal to the twin on {lanes_eq}/{B} lanes "
        f"(all 18 sc rows, x, y), rerun bit-identical; kernel solved "
        f"{solved}/{B}, mean iterations {k_np[3].mean():.2f}, max "
        f"{k_np[3].max()}; kernel {numbers['fused_palm']['ms']:.3f} ms, plain "
        f"{numbers['fused_palm']['plain_ms']:.1f} ms")
    numbers["fused_palm"]["split_ms"], _ = onchip_split(
        F, sd, scal, st, s32, numbers["fused_palm"]["ms"], "K1")

    # ---- 5. the slice ----
    rounds = [make_problems(B, N, M, seed=7 + 1000 * k) for k in range(ROUNDS)]
    counters = (F.fused_palm, chol.cholesky_upper, chol.cholesky_solve)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    n_cert = n_disagree = 0
    uncertified = []
    for k, probs in enumerate(rounds):
        t0 = time.perf_counter()
        d32 = stack_problems(probs, np.float32, device=dev)
        d64 = stack_problems(probs, np.float64, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x, y, status, iters = F.solve_batch_fused(d32, s32)[:4]
        pol = polish_batch(d64, x, y, eps_abs=EPS_TARGET, eps_rel=EPS_TARGET,
                           refine_iters=2, second_round_k=64,
                           seed_guard="norm", residual32=False,
                           accept_viol=1.0)
        ok = pol.ok.cpu().numpy()
        t2 = time.perf_counter()
        require(tuple(pol.x.shape) == (B, N) and tuple(pol.y.shape) == (B, M),
                f"round {k}: polished shapes {tuple(pol.x.shape)}, "
                f"{tuple(pol.y.shape)}")
        require(bool(torch.isfinite(pol.x[pol.ok]).all())
                and bool(torch.isfinite(pol.y[pol.ok]).all()),
                f"round {k}: non-finite certified solutions")
        # the host rescue of the rejected lanes (bench.py:289-347)
        h64 = QPData(*(a.cpu().numpy() for a in d64))
        x_h, y_h = pol.x.cpu().numpy(), pol.y.cpu().numpy()
        n_dev = int(ok.sum())
        bad = np.flatnonzero(~ok)
        res = bench.rescue_round(QPData(*(a[bad] for a in h64)))
        ok[bad], x_h[bad], y_h[bad] = res.ok, res.x, res.y
        t3 = time.perf_counter()
        if k == 0:  # phase 14 holds the general loop's x to these
            x_cert, ok_cert = x_h.copy(), ok.copy()
        uncertified += [(k, int(i)) for i in bad[~res.ok]]
        ref_ok = referee.check(*h64, x_h, y_h, EPS_TARGET, EPS_TARGET)[0] \
            <= 1.0
        n_cert += int(ok.sum())
        n_disagree += int((ok & ~ref_ok).sum())
        say(f"[slice] round {k}: certified {int(ok.sum())}/{B} (device "
            f"polish {n_dev}, rescued by C {res.by_c} and by finish_np "
            f"{res.by_finish} of {bad.size}), referee agrees on "
            f"{int((ok & ref_ok).sum())}, kernel solved "
            f"{int((status == 1).sum())}, stack+copy {t1 - t0:.3f} s, "
            f"solve+polish {t2 - t1:.3f} s, rescue {t3 - t2:.3f} s")
    launches = {c.__name__: c.launches for c in counters}
    say(f"[slice] certified {n_cert}/{ROUNDS * B}, all re-checked by the "
        f"referee: disagreements {n_disagree}; launches {launches}")
    require(n_cert == ROUNDS * B, f"certified {n_cert}/{ROUNDS * B}; "
            f"uncertified (round, lane): {uncertified}")
    require(n_disagree == 0, f"{n_disagree} referee disagreements")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")

    # ---- 6-8. the front end on K1's other tiers ----
    t0 = time.perf_counter()
    numbers["fused_palm_nonconvex"], launches["fused_palm_nonconvex"] = \
        phase_nonconvex(dev)
    t1 = time.perf_counter()
    probs = make_problems(B, N, M, seed=7)
    numbers["fused_palm_dual"], launches["fused_palm_dual"], s_dual = \
        phase_dual(dev, probs, s32, k_np[0])
    t2 = time.perf_counter()
    phase_chunk_warm(dev, probs, s32, k_np[0], k_np[1])
    t3 = time.perf_counter()
    say(f"[time] phase 6 {t1 - t0:.1f} s, phase 7 {t2 - t1:.1f} s, phase 8 "
        f"{t3 - t2:.1f} s")

    # ---- 9-12. the streaming tier, the workloads sweep, the probes ----
    sd, scal, st = F._prepare(stack_problems(probs, np.float32, device=dev),
                              s32)
    phase_stream_headline(sd, scal, st, s32, k_np)
    t4 = time.perf_counter()
    numbers["fused_palm_stream"] = phase_stream_full(dev, probs, s_dual)
    t5 = time.perf_counter()
    launches["fused_palm_stream"] = phase_sweep(dev)
    t6 = time.perf_counter()
    probe_launches, probe_numbers = phase_probes()
    launches.update(probe_launches)
    numbers.update(probe_numbers)
    t7 = time.perf_counter()
    phase_bench(counters)
    t8 = time.perf_counter()
    say(f"[time] phase 9 {t4 - t3:.1f} s, phase 10 {t5 - t4:.1f} s, phase "
        f"11 {t6 - t5:.1f} s, phase 12 {t7 - t6:.1f} s, phase 13 "
        f"{t8 - t7:.1f} s")

    # ---- 14. the general loop ----
    general_numbers, general_launches = phase_general(
        dev, probs, s32, k_np, x_cert, ok_cert)
    numbers.update(general_numbers)
    launches.update(general_launches)
    t9 = time.perf_counter()
    say(f"[time] phase 14 {t9 - t8:.1f} s")

    # ---- 15. the wide plans ----
    wide_numbers, wide_launches = phase_wide(dev)
    numbers.update(wide_numbers)
    launches.update(wide_launches)
    say(f"[time] phase 15 {time.perf_counter() - t9:.1f} s")

    # ---- 16. the front end ----
    fe_numbers, fe_launches = phase_front_end(dev)
    numbers.update(fe_numbers)
    launches.update(fe_launches)

    # ---- 17. the large sparse path ----
    sp_numbers, sp_launches = phase_sparse(dev)
    numbers.update(sp_numbers)
    launches.update(sp_launches)

    # ---- the f64 warp solve at the shapes of phases 3-17 ----
    held = hold_warp_shapes(dev, np.random.default_rng(170),
                            dict(chol.KERNEL_SHAPES))
    say(f"[warp solve] the {len(held)} f64 warp-solve shapes of phases 3-17 "
        "bit-identical to the twin: " + ", ".join(
            f"({B}, {n}, k={k})" for _, B, n, k in held))
    require(held, "no f64 warp-solve shape in phases 3-17")

    # ---- 18. the stage-structured path ----
    st_numbers, st_launches = phase_stage(dev)
    numbers.update(st_numbers)
    launches.update(st_launches)

    # ---- 19. constraint sharding; K2b's entry plan at f32 ----
    cs_numbers, cs_launches = phase_constraint_sharded(dev)
    numbers.update(cs_numbers)
    launches.update(cs_launches)
    entry_f32_row(dev)

    csrc = "qpalm_tpu_torch/csrc/"
    table = [
        ("fused_palm", "fused_palm", csrc + "fused_palm.cu",
         "qpalm_tpu/solver/fused.py:186"),
        ("fused_palm_nonconvex", "fused_palm_nonconvex",
         csrc + "fused_palm.cu", "qpalm_tpu/solver/fused.py:186"),
        ("fused_palm_dual", "fused_palm_dual", csrc + "fused_palm.cu",
         "qpalm_tpu/solver/fused.py:186"),
        ("fused_palm_stream", "fused_palm_stream", csrc + "fused_palm.cu",
         "qpalm_tpu/solver/fused.py:217"),
        ("chol", "cholesky_upper", csrc + "chol.cu",
         "qpalm_tpu/linalg/pallas_chol.py:98"),
        ("chol_solve", "cholesky_solve", csrc + "chol.cu",
         "qpalm_tpu/linalg/pallas_chol.py:123"),
        ("chol_solve_vec", "chol_solve_vec", csrc + "chol.cu",
         "qpalm_tpu/linalg/pallas_chol.py:123"),
        *((f"chol{part}_{plan}", f"chol{part}_{plan}", csrc + "chol.cu",
           f"qpalm_tpu/linalg/pallas_chol.py:{98 if not part else 123}")
          for plan in ("f64", "global", "global_f64", "global_wide",
                       "global_wide_f64")
          for part in ("", "_solve")),
        ("chol_solve_global_cols", "chol_solve_global_cols",
         csrc + "chol.cu", "qpalm_tpu/linalg/pallas_chol.py:123"),
        *((f"chol{part}_{plan}", f"chol{part}_{plan}", csrc + "chol.cu",
           f"qpalm_tpu/linalg/pallas_chol.py:{98 if not part else 123}")
          for plan in ("global_f64_mpc", "global_wide_f64_qpalm",
                       "f64_bjacobi")
          for part in ("", "_solve")),
        ("probe_scratch", "probe_scratch", csrc + "probe_stream.cu",
         "scripts/probe_mosaic_scratch.py:83"),
        ("probe_assembly", "probe_assembly", csrc + "probe_stream.cu",
         "scripts/probe_mosaic_scratch.py:160"),
        *((name, name, csrc + "chol.cu",
           "qpalm_tpu/linalg/pallas_chol.py:"
           + ("123" if name.startswith("chol_solve") else "98"))
          for name in sorted(st_numbers) + sorted(cs_numbers)),
    ]
    kernels_line = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[counter], **numbers[name])
        for name, counter, src, rep in table]}
    say(json.dumps(kernels_line))
    say(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
