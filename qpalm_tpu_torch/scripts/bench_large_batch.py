"""Batched dense QPs across K1's streaming wall on the port
(scripts/bench_large_batch.py): n_pad 320 -> 512, each configuration one
batch through large.solve_large_dense (batch.solve_batch, then the f64
host polish and the finisher), every solve f64-KKT-certified at eps 1e-6.

Up to solver.fused.STREAM_N_MAX (n_pad 352) the f32 pass of this pipeline
runs the general loop (SCHUR with refinement, K2), as the reference's
large.py does; the question the reference asked, whether the throughput is
continuous across the wall, is read here across n_pad 352 -> 384.
Workload: the reference randomQP protocol scaled up (simulations/
randomQP.m:22-47, 50% density, m = 1.5 n).  Median of --reps distinct
perturbed batches, every rep time disclosed.

    python -m qpalm_tpu_torch.scripts.bench_large_batch [--reps 3]
        [--configs 320:64,352:64,384:64,448:64,512:64] [--json NAME]
        [--device cuda|cpu]
"""

import json
import statistics
import sys
import time

import numpy as np

from ._common import device, out_path, parser, sync


def make_problems(B, n, m, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        M = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.5)
        Q = M @ M.T / n + 0.1 * np.eye(n)
        A = rng.standard_normal((m, n))
        q = rng.standard_normal(n)
        u = 2 * rng.random(m)
        out.append((Q, A, q, -u, u))
    return out


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--configs", default="320:64,352:64,384:64,448:64,512:64",
                    help="comma-separated n:B pairs")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = device(args)

    from ..large import solve_large_dense

    rows = []
    for cfg in args.configs.split(","):
        n, B = (int(v) for v in cfg.split(":"))
        m = (3 * n) // 2
        # warm-up on a distinct batch (untimed)
        solve_large_dense(make_problems(B, n, m, seed=123456 + n), eps=1e-6,
                          device=dev)
        times, oks, dev_ts, pol_ts = [], [], [], []
        for r in range(args.reps):
            probs = make_problems(B, n, m, seed=1000 * r + n)
            sync(dev)
            t0 = time.perf_counter()
            res = solve_large_dense(probs, eps=1e-6, device=dev)
            times.append(time.perf_counter() - t0)
            oks.append(int(res.ok.sum()))
            dev_ts.append(res.t_device_s)
            pol_ts.append(res.t_polish_s)
        med = statistics.median(times)
        row = {
            "n": n, "m": m, "B": B,
            "solves_per_s": round(B / med, 2),
            "certified": f"{min(oks)}-{max(oks)}/{B}",
            "t_total_reps": [round(t, 3) for t in times],
            "t_device_reps": [round(t, 3) for t in dev_ts],
            "t_polish_reps": [round(t, 3) for t in pol_ts],
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    print("\n| n | m | B | solves/s | certified | device s (med) | "
          "polish s (med) |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['n']} | {r['m']} | {r['B']} | {r['solves_per_s']} "
              f"| {r['certified']} "
              f"| {statistics.median(r['t_device_reps']):.2f} "
              f"| {statistics.median(r['t_polish_reps']):.2f} |")
    if args.json:
        import os

        with open(out_path(args, os.path.basename(args.json)), "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
