"""The reference's benchmark scripts (scripts/*.py of the JAX package) on the
port, each run as a module:

    python -m qpalm_tpu_torch.scripts.<name> [--device cuda|cpu] [flags]

run_qps_suite, bench_mpc, bench_scenarios, bench_sparse,
bench_large_single, bench_large_batch, bench_nonconvex, bench_cross_solver
and bench_scaling.  Each takes the reference script's size flags and
`--device` (default "cuda"; "cpu" runs the kernels' plain twins), prints
the reference script's record keys, times what the reference times, reads
only inputs committed to the repository (benchmarks/qps_*, generators
seeded in the code) and writes its reports only under `--out-dir`
(default `results/`, which .gitignore lists).
"""
