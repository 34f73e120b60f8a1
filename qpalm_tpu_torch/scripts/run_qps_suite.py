"""QPS-suite benchmark harness (the Maros-Meszaros driver) on the port
(scripts/run_qps_suite.py).

Parse every .qps/.QPS/.SIF file in a directory committed to the repository
(benchmarks/qps_mm, qps_mini, qps_hard, maros), solve at the reference
protocol (eps_abs = eps_rel = 1e-6 by default; reference:
simulations/maros_meszaros/test_maros_meszaros.m:43-106), and report per
problem status / iterations / runtime / objective plus a summary line.

    python -m qpalm_tpu_torch.scripts.run_qps_suite DIR [--eps 1e-6]
        [--device cuda|cpu] [--max-n 2000] [--f32]
        [--route dense|sparse|auto] [--sparse-above 400] [--json NAME]
        [--markdown NAME] [--baseline] [--out-dir results]

Problems are bucketed by padded shape and each bucket is solved as one
batch on the device (batch.solve_batch; `--f32` the float32 pass with f64
escalation of stragglers, batch.solve_batch_escalate).  `--route auto`
sends problems with n > --sparse-above to the host sparse-direct path
(host_sparse.solve_sparse_auto) one at a time with per-problem wall times.
Every solved instance is also KKT-certified in f64 on the unscaled
problem.  `--json` / `--markdown` name files under `--out-dir`.
"""

import glob
import json
import os
import sys
import time

import numpy as np

from ._common import device, out_path, parser, sync


def kkt_certify(Q, A, q, bmin, bmax, x, y, eps):
    """Independent f64 KKT check on the unscaled problem (the criteria of
    termination.c:44-129 with identity scaling, plus complementarity;
    scripts/run_qps_suite.py:42-70).  Returns (ok, pri_norm, dua_norm)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if not (np.all(np.isfinite(x)) and np.all(np.isfinite(y))):
        return False, np.inf, np.inf
    Ax = A @ x
    z = np.clip(Ax, bmin, bmax)
    pri = float(np.max(np.abs(Ax - z))) if Ax.size else 0.0
    Qx = Q @ x
    Aty = A.T @ y
    dua = float(np.max(np.abs(Qx + q + Aty)))
    eps_pri = eps + eps * max(np.max(np.abs(Ax), initial=0.0),
                              np.max(np.abs(z), initial=0.0))
    eps_dua = eps + eps * max(np.max(np.abs(Qx), initial=0.0),
                              np.max(np.abs(q), initial=0.0),
                              np.max(np.abs(Aty), initial=0.0))
    comp = 0.0
    if Ax.size:
        comp = float(np.max(
            np.where(y > eps, np.abs(Ax - bmax), 0.0)
            + np.where(y < -eps, np.abs(Ax - bmin), 0.0), initial=0.0))
    ok = pri <= eps_pri and dua <= eps_dua and comp <= eps_pri + eps
    return ok, pri, dua


def _expected_status(name):
    """Infeasible instances carry their expected certificate status in the
    name; for everything else 'correct' means solved."""
    if name.startswith("PINF"):
        return -3
    if name.startswith("DINF"):
        return -4
    return 1


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("dir")
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--max-n", type=int, default=2000,
                    help="skip problems with more variables (dense memory)")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--route", choices=["dense", "sparse", "auto"],
                    default="dense")
    ap.add_argument("--sparse-above", type=int, default=400,
                    help="auto route: n above this goes to the sparse path")
    ap.add_argument("--json", default=None)
    ap.add_argument("--markdown", default=None,
                    help="write the per-problem results table to this file")
    ap.add_argument("--baseline", action="store_true",
                    help="also run the native single-threaded sparse "
                         "baseline on every sparse-routed problem")
    ap.add_argument("--baseline-time-limit", type=float, default=1200.0,
                    help="per-problem wall-clock cap for the baseline (s)")
    args = ap.parse_args(argv)
    dev = device(args)

    from .. import Settings, baseline_c
    from ..batch import bucket_indices, solve_batch, solve_batch_escalate
    from ..host_sparse import solve_sparse_auto
    from ..io import load_qps

    files = sorted(glob.glob(os.path.join(args.dir, "*.qps"))
                   + glob.glob(os.path.join(args.dir, "*.QPS"))
                   + glob.glob(os.path.join(args.dir, "*.SIF")))
    if not files:
        print(f"no QPS files in {args.dir}", file=sys.stderr)
        return 1

    def sparse_routed(p):
        if args.route == "sparse":
            return True
        return args.route == "auto" and p.n > args.sparse_above

    problems, names, skipped, sparse_probs = [], [], [], []
    for f in files:
        try:
            p = load_qps(f)
        except Exception as e:  # a file the parsers refuse is reported
            skipped.append((os.path.basename(f), f"parse error: {e}"))
            continue
        if sparse_routed(p):
            sparse_probs.append(p)
            continue
        if p.n > args.max_n:
            skipped.append((os.path.basename(f), f"n={p.n} > --max-n"))
            continue
        problems.append((p.Q.toarray(), p.A.toarray(), p.q, p.bmin, p.bmax,
                         p.c))
        names.append(p.name or os.path.basename(f))

    if args.f32:
        settings = Settings(
            dtype="float32", eps_abs=max(args.eps, 1e-4),
            eps_rel=max(args.eps, 1e-4), max_iter=500, scaling=10,
            max_refine=2, verbose=False)
        solver = lambda probs: solve_batch_escalate(  # noqa: E731
            probs, settings, device=dev)
    else:
        settings = Settings(eps_abs=args.eps, eps_rel=args.eps,
                            max_iter=50000, scaling=10, verbose=False)
        solver = lambda probs: solve_batch(  # noqa: E731
            probs, settings, device=dev)

    sizes = [(q.shape[0], bl.shape[0]) for _, _, q, bl, _, _ in problems]
    buckets = bucket_indices(sizes)
    results = [None] * len(problems)
    t_total = 0.0
    for key, idxs in sorted(buckets.items()):
        sub = [problems[i] for i in idxs]
        t0 = time.perf_counter()
        res = solver(sub)
        sync(dev)
        dt = time.perf_counter() - t0
        t_total += dt
        x, y = res.x.cpu().numpy(), res.y.cpu().numpy()
        status, iters = res.status.cpu().numpy(), res.iterations.cpu().numpy()
        obj = res.objective.cpu().numpy()
        for j, i in enumerate(idxs):
            Qd, Ad, qv, bl, bu, cc = problems[i]
            ok, pri, dua = kkt_certify(Qd, Ad, qv, bl, bu,
                                       x[j][: sizes[i][0]],
                                       y[j][: sizes[i][1]], args.eps)
            results[i] = {
                "name": names[i], "n": sizes[i][0], "m": sizes[i][1],
                "status": int(status[j]), "iter": int(iters[j]),
                "objective": float(obj[j]), "time_s": dt / len(idxs),
                "kkt": bool(ok),
            }
        print(f"bucket {key}: {len(idxs)} problems in {dt:.2f}s")

    if sparse_probs:
        sset = Settings(eps_abs=args.eps, eps_rel=args.eps, max_iter=50000,
                        scaling=10, verbose=False)
        for p in sorted(sparse_probs, key=lambda p: p.n):
            t0 = time.perf_counter()
            r = solve_sparse_auto(p.Q, p.A, p.q, p.bmin, p.bmax,
                                  settings=sset, c=p.c, device=dev)
            dt = time.perf_counter() - t0
            t_total += dt
            ok, pri, dua = kkt_certify(p.Q, p.A, p.q, p.bmin, p.bmax,
                                       r.x, r.y, args.eps)
            row = {
                "name": p.name, "n": p.n, "m": p.m, "status": int(r.status),
                "iter": int(r.iterations), "objective": float(r.objective),
                "time_s": dt, "kkt": bool(ok), "route": "sparse",
            }
            if args.baseline:
                t0 = time.perf_counter()
                try:
                    rb = baseline_c.solve_sparse(
                        p.Q, p.A, p.q, p.bmin, p.bmax, eps_abs=args.eps,
                        eps_rel=args.eps, max_iter=10 ** 9, scaling=10,
                        rescue=False, time_limit=args.baseline_time_limit)
                    row["baseline_time_s"] = time.perf_counter() - t0
                    row["baseline_iter"] = rb["iter"]
                    row["baseline_status"] = rb["status"]
                    if rb["status"] == 1:
                        okb, _, _ = kkt_certify(
                            p.Q, p.A, p.q, p.bmin, p.bmax, rb["x"], rb["y"],
                            args.eps)
                        row["baseline_kkt"] = bool(okb)
                except Exception as e:  # missing library / native error
                    row["baseline_status"] = 0
                    row["baseline_error"] = str(e)
            results.append(row)
            base = ""
            if "baseline_time_s" in row:
                base = (f" | base {row['baseline_time_s']:.2f}s "
                        f"it={row['baseline_iter']} "
                        f"st={row['baseline_status']}")
            print(f"sparse {p.name}: n={p.n} m={p.m} "
                  f"status={r.status_str} iter={r.iterations} "
                  f"obj={r.objective:.6e} kkt={'y' if ok else 'N'} "
                  f"{dt:.2f}s{base}", flush=True)

    for r in results:
        r["expected"] = _expected_status(r["name"])
        r["correct"] = r["status"] == r["expected"] and (
            r["expected"] != 1 or r.get("kkt", True))
    n_correct = sum(1 for r in results if r["correct"])
    n_solved = sum(1 for r in results if r["status"] == 1)
    print(f"\n{'name':<16} {'n':>6} {'m':>7} {'status':>7} {'iter':>7} "
          f"{'kkt':>4} {'time':>8} {'ok':>3} objective")
    for r in results:
        print(f"{r['name']:<16} {r['n']:>6} {r['m']:>7} {r['status']:>7} "
              f"{r['iter']:>7} {'y' if r.get('kkt') else '-':>4} "
              f"{r.get('time_s', 0.0):>7.2f}s "
              f"{'y' if r['correct'] else 'N':>3} "
              f"{r['objective']: .6e}")
    for name, why in skipped:
        print(f"{name:<16} SKIPPED ({why})")
    print(f"\ncorrect {n_correct}/{len(results)} (solved {n_solved}, "
          f"+{len(skipped)} skipped) in {t_total:.2f}s solve time "
          f"on {dev}")

    if args.markdown:
        with open(out_path(args, os.path.basename(args.markdown)), "w") as f:
            f.write("# QPS suite results\n\n")
            f.write(f"Protocol: eps_abs = eps_rel = {args.eps}, scaling 10, "
                    f"max_iter 50000, device {dev}.\n\n")
            f.write("| name | n | m | status | expected | iter | objective "
                    "| kkt | time (s) | ok |\n"
                    "|---|---|---|---|---|---|---|---|---|---|\n")
            for r in results:
                f.write(f"| {r['name']} | {r['n']} | {r['m']} "
                        f"| {r['status']} | {r['expected']} | {r['iter']} "
                        f"| {r['objective']:.6e} "
                        f"| {'yes' if r.get('kkt') else '-'} "
                        f"| {r.get('time_s', 0.0):.2f} "
                        f"| {'yes' if r['correct'] else 'NO'} |\n")
            f.write(f"\n**correct {n_correct}/{len(results)}** in "
                    f"{t_total:.2f}s total solve time.\n")
    if args.json:
        with open(out_path(args, os.path.basename(args.json)), "w") as f:
            json.dump({"results": results, "skipped": skipped,
                       "solve_time_s": t_total, "device": str(dev)}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
