"""qpalm_tpu_torch: the PyTorch and CUDA port of qpalm_tpu, for one NVIDIA
H100.

The port mirrors qpalm_tpu's module paths and names, so each module has a
counterpart in the JAX package that it is held against in the tests.  It
imports torch and numpy, never jax and never qpalm_tpu.  Every path of
the JAX package is ported.  The certified batched pipeline of bench.py:

    batch.stack_problems -> scaling.scale_data -> solver.fused (kernel K1)
    -> polish_device.polish_batch (kernel K2) -> bench.rescue_round (the
    rejected lanes: baseline_c.solve, polish.polish_batch_np,
    finish_np.palm_finish_np) -> referee.check

the bench that measures it (python -m qpalm_tpu_torch.bench), bench.py's
protocol with the C baseline as its divisor:

    bench.run -> rounds of the pipeline above, the rescue in a background
    thread -> the referee on every rep -> bench.measure_baseline
    (baseline_c, native/qpalm_baseline.cpp built by g++ at first use)

the batch front end, for convex and nonconvex batches, with dual-objective
termination, warm starts and host chunking:

    batch.solve_batch / solve_many -> stack_problems
    -> [nonconvex] solver.nonconvex.batch_gamma_pins (LOBPCG on scaled Q)
    -> batch._fused_eligible -> solver.fused.solve_batch_fused (kernel K1)
    -> batch.BatchResult

the general P-ALM loop behind it, for every batch K1 does not take (the
default f64 Settings(), refinement, f64 residuals, a time limit,
use_fused="never", n_pad past 352), and the f64 escalation:

    batch.solve_batch / solve_batch_escalate -> solver.core.full_solve
    (scaling.scale_data, core.init_state, core.solve_from_state: the
    Schur matrix by torch.bmm, kernel K2 for its factor and solves, in
    shared or global memory, f32 or f64; solver.linesearch)
    -> batch.BatchResult

the workloads sweep of scripts/bench_workloads.py, whose larger rows
run K1's streaming tier:

    sweep.run_row -> stack_problems -> solver.fused (kernel K1, on chip or
    streaming) -> polish.polish_batch_np -> finish_np.palm_finish_np
    -> referee.check

and the single-problem front end (README.md's Quick start) with what
stands on it: the MPC chain, the large dense pipeline and the
differentiable solve, all on kernel K2:

    api.solve / QPALM.solve -> validate -> batch.pad_problem
    -> scaling.scale_data -> [nonconvex] LOBPCG pin -> core.init_state
    -> core.solve_from_state (SCHUR or KKT) -> core.finalize -> SolveResult
    workloads.SequentialMPC.step -> QPALM.warm_start / solve / update_bounds
    large.solve_large_dense -> batch.solve_batch (f32) -> polish_batch_np
    | polish_device.polish_batch -> finish_np
    diff.solve_diff -> core (forward) ; backward: K2 factor and solve

compat.Qpalm is the reference binding's shim over QPALM; checkpoint
saves and loads solutions and batches.  The large sparse path, on the
device and on the host, with the file drivers that feed it:

    api.QPALM(sparse=True) -> linalg.sparse.from_scipy -> scaling (sparse)
    -> core.solve_from_state (FACTORIZE_CG: linalg.cg.pcg, Jacobi or
    block-Jacobi, whose blocks kernel K2 factors and solves)
    api.solve (large scipy input) -> host_sparse.solve_sparse_auto
    -> baseline_c.solve_sparse | host_sparse.solve_sparse_direct
    (linalg.sparse_direct.SparseLDL) | the CG path above on the device
    io.load_qps (io/qps.py, io/native.py) ; io.cli

and the stage-structured path of MPC ladders, on one card or across
processes:

    QPALM / solve_batch / SequentialMPC(stage_structured=True)
    (FACTORIZE_STAGE) -> core: M by torch.bmm -> parallel.block_tridiag
    (extract_block_tridiag, thomas_solve: kernel K2 a stage)
    parallel.solve_mpc_stage_sharded -> scale_stage_data -> the loop over
    a mesh (parallel.mesh: LocalMesh, the shards one dimension of a
    device's tensors; DistMesh, torch.distributed) -> spike_solve_local
    (block Thomas a shard, K2; the interface by cyclic reduction)
    parallel.solve_batch_sharded -> core.full_solve a shard

and one QP with its constraint rows split over a mesh:

    parallel.solve_constraint_sharded -> core.setup on the whole problem,
    its m-sized data and state split by rows (parallel.schur.RowSharded)
    -> core.solve_from_state (A'y and the Schur matrix a psum, the m-sized
    norms a pmax, the linesearch's breakpoints gathered; SCHUR on K2)

The reference's benchmark scripts and examples run on the port as
`python -m qpalm_tpu_torch.scripts.<name>` and
`python -m qpalm_tpu_torch.examples.<name>`.

Every Pallas kernel of the repository is a CUDA C++ kernel here (csrc/),
built by nvcc at first use (_build.py); probe.py holds the streaming
tier's memory-plan probes.  A CPU tensor runs each kernel's plain PyTorch
twin instead; a CUDA tensor runs the kernel or raises.  The native
libraries (the C baseline solvers, the sparse LDL' backend and the QPS
reader) are built by g++ from native/ at first use (_build.py).

The host-side modules of the JAX package (its f64 polish, finisher,
generators, validation, C baseline binding, host sparse solvers and file
drivers) cannot be imported without JAX (qpalm_tpu/__init__.py imports
it), so the port keeps its own copies of them (polish.py, finish_np.py,
workloads.py, validate.py, baseline_c.py, host_sparse.py,
linalg/sparse_direct.py, io/), held against the originals in the tests.

    minimize   0.5 x' Q x + q' x + c
    subject to bmin <= A x <= bmax
"""

from . import constants, io
from .constants import (FACTORIZE_CG, FACTORIZE_KKT, FACTORIZE_KKT_OR_SCHUR,
                        FACTORIZE_SCHUR, FACTORIZE_STAGE,
                        QPALM_DUAL_INFEASIBLE, QPALM_DUAL_TERMINATED,
                        QPALM_ERROR, QPALM_MAX_ITER_REACHED,
                        QPALM_PRIMAL_INFEASIBLE, QPALM_SOLVED,
                        QPALM_TIME_LIMIT_REACHED, QPALM_UNSOLVED)
from .api import QPALM, solve
from .host_sparse import SparseQPALM, solve_sparse_auto, \
    solve_sparse_batch, solve_sparse_direct
from .types import Info, QPData, ScalingInfo, Settings, Solution, \
    SolveResult, qpdata_from_numpy, settings_from
from . import (batch, checkpoint, compat, diff, host_sparse,  # noqa: E402
               parallel, polish, polish_device, workloads)

__version__ = "0.1.0"

# the reference's __all__ (qpalm_tpu/__init__.py:49-86), then the port's
# own two names
__all__ = ["QPALM", "solve", "Settings", "batch", "checkpoint", "compat",
           "diff", "io", "parallel", "workloads", "polish", "polish_device",
           "host_sparse", "solve_sparse_direct", "solve_sparse_auto",
           "SparseQPALM", "solve_sparse_batch", "FACTORIZE_KKT",
           "FACTORIZE_SCHUR", "FACTORIZE_KKT_OR_SCHUR", "FACTORIZE_CG",
           "FACTORIZE_STAGE", "Info", "QPData", "ScalingInfo", "Solution",
           "SolveResult", "constants", "QPALM_SOLVED",
           "QPALM_DUAL_TERMINATED", "QPALM_MAX_ITER_REACHED",
           "QPALM_PRIMAL_INFEASIBLE", "QPALM_DUAL_INFEASIBLE",
           "QPALM_TIME_LIMIT_REACHED", "QPALM_UNSOLVED", "QPALM_ERROR",
           "qpdata_from_numpy", "settings_from"]
