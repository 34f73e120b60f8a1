"""Nonconvex QP benchmark sweep on the port (scripts/bench_nonconvex.py):
the CUTEst-analogue table.

The reference benchmarks its nonconvex mode on the CUTEst set (reference:
simulations/cutest_set/run_cutest.m; nonconvex.c:171-183: the LOBPCG
minimum eigenvalue pins gamma to 1/|lambda_min| so that every subproblem
is convex).  Two generated families, every reported solve certified for
STATIONARITY (the KKT conditions) in f64 on the unscaled problem:

  * BOXQP-d (dense, workloads.boxqp): batched on the device, an f32 pass
    (batch.solve_batch: LOBPCG pins, kernel K1), the f64 host polish, and
    a cold f64 re-solve (the general loop on the device) plus polish of the
    lanes the polish rejects; pass / polish / rescue times per row;
  * SPARSEIND (host): a banded Laplacian minus a diagonal shift (Q
    indefinite) with box and coupling rows, through
    host_sparse.solve_sparse_direct with the numpy LOBPCG pin.

Median of REPS distinct instance sets.  Writes RESULTS_nonconvex.md under
--out-dir.

    python -m qpalm_tpu_torch.scripts.bench_nonconvex [--device cuda|cpu]
        [--boxqp 16:512,32:512,64:256] [--sparse-sizes 500,2000,5000]
        [--reps 3] [--max-iter 400] [--out RESULTS_nonconvex.md]
"""

import json
import os
import sys
import time

import numpy as np

from ._common import device, out_path, parser, sync

EPS_CERT = 1e-5


def sparse_indef(n, seed, shift=2.5):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    main = np.full(n, 2.0 - shift)  # eigenvalues in [-shift, 4 - shift]
    off = np.full(n - 1, -1.0)
    Q = sp.diags([off, main, off], [-1, 0, 1], format="csc")
    q = rng.standard_normal(n)
    A = sp.vstack([sp.eye(n),
                   sp.diags([np.ones(n - 5)], [5], shape=(n - 5, n))
                   + sp.diags([np.ones(n - 5)], [0], shape=(n - 5, n))]
                  ).tocsc()
    bmin = np.concatenate([-np.ones(n), -3.0 * np.ones(n - 5)])
    bmax = np.concatenate([np.ones(n), 3.0 * np.ones(n - 5)])
    return Q, A, q, bmin, bmax


def stationarity_ok(Q, A, q, bmin, bmax, x, y, eps=EPS_CERT):
    if not (np.all(np.isfinite(x)) and np.all(np.isfinite(y))):
        return False
    Ax = A @ x
    z = np.clip(Ax, bmin, bmax)
    pri = np.max(np.abs(Ax - z), initial=0.0)
    Qx = Q @ x
    Aty = A.T @ y
    dua = np.max(np.abs(Qx + q + Aty), initial=0.0)
    eps_pri = eps + eps * max(np.max(np.abs(Ax), initial=0.0),
                              np.max(np.abs(z), initial=0.0))
    eps_dua = eps + eps * max(np.max(np.abs(Qx), initial=0.0),
                              np.max(np.abs(q), initial=0.0),
                              np.max(np.abs(Aty), initial=0.0))
    comp = np.max(np.where(y > eps, np.abs(Ax - bmax), 0.0)
                  + np.where(y < -eps, np.abs(Ax - bmin), 0.0), initial=0.0)
    return bool(pri <= eps_pri and dua <= eps_dua and comp <= eps_pri + eps)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--out", default="RESULTS_nonconvex.md")
    ap.add_argument("--boxqp", default="16:512,32:512,64:256",
                    help="comma-separated n:B device rows")
    ap.add_argument("--sparse-sizes", default="500,2000,5000")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-iter", type=int, default=400,
                    help="iterations of the f32 pass (the reference's 400)")
    args = ap.parse_args(argv)
    dev = device(args)
    REPS = args.reps

    from .. import Settings
    from ..batch import solve_batch, stack_problems
    from ..host_sparse import solve_sparse_direct
    from ..polish import polish_batch_np
    from ..types import QPData
    from ..workloads import boxqp

    rows = []
    for cfg in args.boxqp.split(","):
        n, B = (int(v) for v in cfg.split(":"))
        s32 = Settings(dtype="float32", nonconvex=True, eps_abs=1e-4,
                       eps_rel=1e-4, max_iter=args.max_iter, scaling=2,
                       max_refine=0, verbose=False)
        s64 = Settings(nonconvex=True, eps_abs=1e-6, eps_rel=1e-6,
                       max_iter=4000, scaling=2, verbose=False)
        times, t_pass_l, t_pol_l, t_esc_l = [], [], [], []
        cert = sol = esc_n = 0
        for rep in range(REPS):
            probs = [boxqp(n, seed=1000 * n + rep * B + i) for i in range(B)]
            if rep == 0:  # the kernels' first use outside the timed region
                solve_batch(probs, s32, device=dev)
            sync(dev)
            t0 = time.perf_counter()
            res = solve_batch(probs, s32, device=dev)
            x32, y32 = res.x.cpu().numpy(), res.y.cpu().numpy()
            t_pass = time.perf_counter() - t0

            t0 = time.perf_counter()
            d64 = QPData(*(a.numpy() for a in stack_problems(probs,
                                                             np.float64)))
            pol = polish_batch_np(d64, x32, y32, eps_abs=1e-6, eps_rel=1e-6,
                                  rounds=2)
            ok, x64, y64 = pol.ok.copy(), pol.x.copy(), pol.y.copy()
            t_pol = time.perf_counter() - t0

            t0 = time.perf_counter()
            bad = np.where(~ok)[0]
            if len(bad):
                # a cold f64 re-solve: the reference measured a warm start
                # from the polished f32 iterates harmful here
                res2 = solve_batch([probs[i] for i in bad], s64, device=dev)
                sub = QPData(*(a[bad] for a in d64))
                pol2 = polish_batch_np(sub, res2.x.cpu().numpy(),
                                       res2.y.cpu().numpy(), eps_abs=1e-6,
                                       eps_rel=1e-6, rounds=2)
                ok[bad], x64[bad], y64[bad] = pol2.ok, pol2.x, pol2.y
            t_esc = time.perf_counter() - t0
            times.append(t_pass + t_pol + t_esc)
            t_pass_l.append(t_pass)
            t_pol_l.append(t_pol)
            t_esc_l.append(t_esc)
            if rep == 0:
                esc_n = len(bad)
                for i, p in enumerate(probs):
                    ni, mi = p[0].shape[0], p[1].shape[0]
                    cert += int(stationarity_ok(
                        p[0], p[1], p[2], p[3], p[4], x64[i][:ni],
                        y64[i][:mi], eps=1e-6))
                sol = int((res.status.cpu().numpy() == 1).sum())
        row = {"family": "BOXQP-d", "n": n, "B": B,
               "path": "device f32+polish+f64esc",
               "solved": f"{sol}/{B}",
               "stationary_certified": f"{cert}/{B}",
               "certify_eps": 1e-6,
               "escalated_lanes": esc_n,
               "time_s": round(float(np.median(times)), 3),
               "t_pass_s": round(float(np.median(t_pass_l)), 3),
               "t_polish_s": round(float(np.median(t_pol_l)), 3),
               "t_rescue_s": round(float(np.median(t_esc_l)), 3),
               "solves_per_s": round(B / float(np.median(times)), 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for n in (int(v) for v in args.sparse_sizes.split(",")):
        sh = Settings(nonconvex=True, eps_abs=1e-6, eps_rel=1e-6,
                      max_iter=20000, scaling=2, verbose=False)
        times, ok_cnt = [], 0
        for rep in range(REPS):
            Q, A, q, bmin, bmax = sparse_indef(n, seed=77 * n + rep)
            t0 = time.perf_counter()
            r = solve_sparse_direct(Q, A, q, bmin, bmax, settings=sh)
            times.append(time.perf_counter() - t0)
            ok_cnt += int(r.status_str == "solved" and stationarity_ok(
                Q, A, q, bmin, bmax, r.x, r.y, eps=1e-5))
        row = {"family": "SPARSEIND", "n": n, "B": 1,
               "path": "host sparse f64",
               "solved": f"{ok_cnt}/{REPS}",
               "stationary_certified": f"{ok_cnt}/{REPS}",
               "time_s": round(float(np.median(times)), 3),
               "solves_per_s": round(1.0 / float(np.median(times)), 2)}
        rows.append(row)
        print(json.dumps(row), flush=True)

    lines = [
        "# Nonconvex QP sweep (CUTEst analogue)",
        "",
        f"Device: {dev}.  Reference protocol: nonconvex=True, the LOBPCG",
        "minimum eigenvalue pins gamma = 1/|lambda_min| per problem",
        "(nonconvex.c:171-183; run_cutest.m).  Every reported solve is",
        "stationarity-certified in f64 on the unscaled problem.  Device",
        "rows: the f32 batch pass, the f64 active-set polish, an f64",
        "re-solve and re-polish of the lanes the polish rejects.  Host",
        "rows: sparse-direct LDL' f64 at eps 1e-6, certified at 1e-5.",
        f"Median of {REPS} instance sets.",
        "",
        "| family | n | batch | path | solved | stationary certified |"
        " esc lanes | time (s) | pass | polish | rescue | solves/s |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['family']} | {r['n']} | {r['B']} | {r['path']} "
            f"| {r['solved']} | {r['stationary_certified']} "
            f"| {r.get('escalated_lanes', '-')} "
            f"| {r['time_s']} | {r.get('t_pass_s', '-')} "
            f"| {r.get('t_polish_s', '-')} | {r.get('t_rescue_s', '-')} "
            f"| {r['solves_per_s']} |")
    path = out_path(args, os.path.basename(args.out))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
