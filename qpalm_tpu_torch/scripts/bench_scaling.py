"""Scaling report on the port (scripts/bench_scaling.py): the two sharded
programs at 1 / 2 / 4 / 8 shards of a `LocalMesh` on ONE device.

  * DP weak scaling: parallel.solve_batch_sharded with a fixed batch a
    shard (the general loop, K2), shards 1 / 2 / 4 / 8.
  * Stage-sharded distribution: parallel.solve_mpc_stage_sharded on a
    fixed chain-of-masses horizon split over 1 / 2 / 4 / 8 stage shards
    (block Thomas a shard on K2, the SPIKE interface), the overhead factor
    of the distributed program at matched iterates.

The "devices" column of the reference counts shards here: k shards of a
LocalMesh are the leading dimension of one device's tensors, not k
devices (the output says so), so these rows measure what the sharded
programs cost and gain on one card, not a multi-card speed-up.  Writes
RESULTS_scaling.md under --out-dir and prints one JSON line.

    python -m qpalm_tpu_torch.scripts.bench_scaling [--device cuda|cpu]
        [--sizes 1,2,4,8] [--per-shard 48] [--chain 10:128] [--reps 3]
"""

import json
import sys
import time

import numpy as np

from ._common import device, out_path, parser, sync


def median_time(fn, dev, reps=3):
    ts = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--per-shard", type=int, default=48)
    ap.add_argument("--chain", default="10:128",
                    help="masses:horizon of the stage-sharded chain")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device(args)
    import torch

    from .. import Settings, constants as C
    from ..batch import stack_problems
    from ..parallel import LocalMesh, solve_batch_sharded
    from ..parallel.mpc_loop import from_mpc_chain, solve_mpc_stage_sharded
    from ..workloads import mpc_chain, random_qp

    sizes = [int(v) for v in args.sizes.split(",")]
    note = (f"k shards of a LocalMesh on one {dev.type} device "
            "(the leading dimension of its tensors), not k devices")
    print(f"[scaling] {note}", flush=True)

    B_PER, N, M = args.per_shard, 32, 48
    s = Settings(eps_abs=1e-4, eps_rel=1e-4, max_iter=200, scaling=2,
                 verbose=False)
    dp_rows = []
    for nd in sizes:
        B = B_PER * nd
        probs = [random_qp(N, M, seed=100 + i) for i in range(B)]
        data = stack_problems(probs, np.float64, device=dev)
        mesh = LocalMesh(nd, device=dev)
        gam = torch.full((B,), s.gamma_init, dtype=torch.float64, device=dev)
        zx, zy = torch.zeros_like(data.q), torch.zeros_like(data.bmin)

        def run():
            return solve_batch_sharded(data, zx, zy, gam, s, False, False,
                                       mesh)[1]

        agg = run()  # the kernels' first use + correctness
        n_solved, total_iters = int(agg["n_solved"]), int(agg["total_iters"])
        assert n_solved == B, (nd, n_solved)
        t = median_time(run, dev, args.reps)
        dp_rows.append({
            "devices": nd, "batch": B, "time_s": round(t, 4),
            "solves_per_s": round(B / t, 1),
            "iters_per_s": round(total_iters / t, 1),
        })
    base = dp_rows[0]["solves_per_s"]
    for r in dp_rows:
        r["weak_efficiency"] = round(
            r["solves_per_s"] / (base * r["devices"]), 3)

    masses, horizon = (int(v) for v in args.chain.split(":"))
    H, A, q, bmin, bmax, meta = mpc_chain(masses, horizon, seed=3)
    sdata = from_mpc_chain(H, A, q, bmin, bmax, meta)
    ss = Settings(eps_abs=1e-6, eps_rel=1e-6, max_iter=500, scaling=2,
                  verbose=False)
    st_rows = []
    for nd in sizes:
        mesh = LocalMesh(nd, device=dev)

        def run():
            return solve_mpc_stage_sharded(sdata, ss, mesh)

        res = run()
        assert int(res.status) == C.QPALM_SOLVED, (nd, int(res.status))
        iters = int(res.iterations)
        t = median_time(run, dev, args.reps)
        st_rows.append({"devices": nd, "time_s": round(t, 4),
                        "iterations": iters,
                        "iters_per_s": round(iters / t, 1)})
    base_t = st_rows[0]["time_s"]
    for r in st_rows:
        r["overhead_factor"] = round(r["time_s"] / base_t, 3)

    lines = [
        "# Scaling report (LocalMesh shards on one device)",
        "",
        "Generated by `python -m qpalm_tpu_torch.scripts.bench_scaling`.",
        f"The device column counts {note}.",
        "",
        "## DP weak scaling (solve_batch_sharded, "
        f"{B_PER} QPs a shard, n={N}, m={M})",
        "",
        "| shards | batch | time (s) | solves/s | weak efficiency |",
        "|---|---|---|---|---|",
    ]
    for r in dp_rows:
        lines.append(f"| {r['devices']} | {r['batch']} | {r['time_s']} | "
                     f"{r['solves_per_s']} | {r['weak_efficiency']} |")
    lines += [
        "",
        "## Stage-sharded distribution overhead (solve_mpc_stage_sharded, "
        f"chain of {masses} masses, horizon {horizon})",
        "",
        "| shards | time (s) | P-ALM iterations | iters/s | overhead "
        "factor |",
        "|---|---|---|---|---|",
    ]
    for r in st_rows:
        lines.append(f"| {r['devices']} | {r['time_s']} | "
                     f"{r['iterations']} | {r['iters_per_s']} | "
                     f"{r['overhead_factor']} |")
    lines.append("")
    path = out_path(args, "RESULTS_scaling.md")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print(json.dumps({"dp": dp_rows, "stage": st_rows, "report": path,
                      "note": note}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
