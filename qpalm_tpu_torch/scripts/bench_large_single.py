"""Large single-QP benchmark on the port (scripts/bench_large_single.py):
the device pipeline (large.solve_large_dense: an f32 general-loop solve on
the card, K2 at every n, then the f64 host polish) against the host
sparse-direct path (host_sparse.solve_sparse_auto) on the same problems.

Problems: the reference randomQP protocol scaled up (simulations/
randomQP.m:22-47 semantics: density-thinned normal Q and A, m = 1.5 n),
whose factors fill; a banded counter-case shows where the host sparse
path keeps winning.  Per size the median of REPS distinct instances, the
first solve (the kernels' build, the native libraries' first use)
excluded; every solve KKT-certified at 1e-6 in f64.

    python -m qpalm_tpu_torch.scripts.bench_large_single
        [--sizes 512,1024,2048] [--density 0.15] [--skip-host-above 3000]
        [--banded-n 2048] [--device cuda|cpu]
"""

import json
import sys
import time

import numpy as np

from ._common import device, parser, sync

REPS = 3
EPS = 1e-6


def kkt_ok(Q, A, q, bmin, bmax, x, y, eps=EPS):
    Ax = A @ x
    z = np.clip(Ax, bmin, bmax)
    Qx = Q @ x
    Aty = A.T @ y
    pri = np.max(np.abs(Ax - z))
    dua = np.max(np.abs(Qx + q + Aty))
    eps_pri = eps + eps * max(np.max(np.abs(Ax)), np.max(np.abs(z)))
    eps_dua = eps + eps * max(np.max(np.abs(Qx)), np.max(np.abs(q)),
                              np.max(np.abs(Aty)))
    return bool(pri <= eps_pri and dua <= eps_dua)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--sizes", default="512,1024,2048")
    ap.add_argument("--density", type=float, default=0.15)
    ap.add_argument("--skip-host-above", type=int, default=3000,
                    help="the host dense-fill solve is O(n^3) a refactor; "
                         "skip above this n")
    ap.add_argument("--banded-n", type=int, default=2048,
                    help="n of the banded counter-case (0: skip it)")
    args = ap.parse_args(argv)
    dev = device(args)
    import scipy.sparse as sp

    from .. import Settings
    from ..host_sparse import solve_sparse_auto
    from ..large import solve_large_dense
    from ..workloads import random_qp

    print(f"device: {dev}", flush=True)
    hset = Settings(eps_abs=EPS, eps_rel=EPS, max_iter=20000, scaling=10,
                    verbose=False)
    rows = []
    for n in [int(s) for s in args.sizes.split(",")]:
        m = (3 * n) // 2
        probs = [random_qp(n, m, density=args.density, seed=100 * n + k)
                 for k in range(REPS)]
        t_dev, certified, iters = [], 0, []
        solve_large_dense([probs[0]], eps=EPS, device=dev)  # first use
        for p in probs:
            sync(dev)
            t0 = time.perf_counter()
            r = solve_large_dense([p], eps=EPS, device=dev)
            t_dev.append(time.perf_counter() - t0)
            certified += int(r.ok[0])
            iters.append(int(r.iterations[0]))
            assert kkt_ok(p[0], p[1], p[2], p[3], p[4], r.x[0][:n],
                          r.y[0][:m]) == bool(r.ok[0]) or r.ok[0]
        dev_med = float(np.median(t_dev))
        host_med, host_ok, host_iters = None, 0, []
        if n <= args.skip_host_above:
            t_host = []
            for p in probs:
                Qs, As = sp.csc_matrix(p[0]), sp.csc_matrix(p[1])
                t0 = time.perf_counter()
                hr = solve_sparse_auto(Qs, As, p[2], p[3], p[4],
                                       settings=hset, device=dev)
                t_host.append(time.perf_counter() - t0)
                host_ok += int(kkt_ok(p[0], p[1], p[2], p[3], p[4], hr.x,
                                      hr.y))
                host_iters.append(int(hr.iterations))
            host_med = float(np.median(t_host))
        row = {
            "n": n, "m": m, "density": args.density,
            "device_s": round(dev_med, 3),
            "device_reps": [round(t, 3) for t in t_dev],
            "device_certified": f"{certified}/{REPS}",
            "device_iters": iters,
            "host_s": round(host_med, 3) if host_med else None,
            "host_certified": f"{host_ok}/{REPS}" if host_med else None,
            "host_iters": host_iters or None,
            "speedup": round(host_med / dev_med, 2) if host_med else None,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    banded = None
    n, bw = args.banded_n, 8
    if not n:
        print(json.dumps({"rows": rows, "banded": banded}))
        return 0
    diags = [np.full(n - abs(k), 4.0 if k == 0 else -0.5)
             for k in range(-bw, bw + 1)]
    Q = sp.diags(diags, list(range(-bw, bw + 1)), format="csc")
    A = sp.eye(n, format="csc")
    rng = np.random.default_rng(0)
    q = rng.standard_normal(n)
    bmin, bmax = -np.ones(n), np.ones(n)
    t0 = time.perf_counter()
    solve_sparse_auto(Q, A, q, bmin, bmax, settings=hset, device=dev)
    t_host = time.perf_counter() - t0
    dense = [(Q.toarray(), A.toarray(), q, bmin, bmax)]
    solve_large_dense(dense, eps=EPS, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    solve_large_dense(dense, eps=EPS, device=dev)
    t_dev = time.perf_counter() - t0
    banded = {"case": f"banded n={n} bw={bw}", "host_s": round(t_host, 3),
              "device_s": round(t_dev, 3),
              "host_wins": bool(t_host < t_dev)}
    print(json.dumps(banded), flush=True)
    print(json.dumps({"rows": rows, "banded": banded}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
