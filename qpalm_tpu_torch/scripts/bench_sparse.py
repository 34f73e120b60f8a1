"""Sparse-backend benchmark on the port (scripts/bench_sparse.py): the four
large-sparse problem classes through the auto-router
(host_sparse.solve_sparse_auto: the native LDL' backends on the host, or
matrix-free preconditioned CG on the device), plus an AMD-vs-RCM fill
table.

For each class the backend's end-to-end wall time, iterations and the
unscaled KKT residuals.  Writes RESULTS_sparse.md under --out-dir and
prints one JSON line.  `--scale` multiplies every size (1: the
reference's n = 5000 / 2000 classes).

    python -m qpalm_tpu_torch.scripts.bench_sparse [--device cuda|cpu]
        [--scale 1.0]
"""

import json
import sys
import time

import numpy as np

from ._common import device, out_path, parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    dev = device(args)
    import scipy.sparse as sp

    from .. import constants as C
    from ..host_sparse import solve_sparse_auto
    from ..linalg.sparse_direct import SparseLDL

    rng = np.random.default_rng(0)
    sz = lambda v: max(8, int(round(v * args.scale)))  # noqa: E731

    def banded_illcond(n, m):
        L = sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                     [0, 1, -1])
        Q = (L @ L + 1e-6 * sp.eye(n)).tocsc()
        A = sp.diags([np.ones(m), 0.5 * np.ones(m)], [0, 1],
                     shape=(m, n)).tocsc()
        return Q, A

    def dense_rows(n, m, k=5):
        Q, _ = banded_illcond(n, m)
        A = sp.vstack([sp.diags(np.ones(m - k), 0, shape=(m - k, n)),
                       sp.csc_matrix(rng.standard_normal((k, n))
                                     / np.sqrt(n))]).tocsc()
        return Q, A

    def heavy_fill(n, m, dens):
        Qr = sp.random(n, n, density=dens, random_state=rng)
        Q = (Qr @ Qr.T + sp.eye(n)).tocsc()
        A = (sp.random(m, n, density=dens, random_state=rng)
             + 0.5 * sp.eye(m, n)).tocsc()
        return Q, A

    def cg_class(n, m):
        Q = sp.diags([2.0 * np.ones(n), -0.5 * np.ones(n - 1),
                      -0.5 * np.ones(n - 1)], [0, 1, -1]).tocsc()
        A = sp.random(m, n, density=5e-4, random_state=1,
                      data_rvs=rng.standard_normal).tocsc()
        return Q, A

    cases = [
        ("banded ill-cond", *banded_illcond(sz(5000), sz(2000))),
        ("dense rows", *dense_rows(sz(5000), sz(2000))),
        ("heavy fill", *heavy_fill(sz(2000), sz(1500), 0.003)),
        ("well-cond random (CG)", *cg_class(sz(5000), sz(7000))),
    ]
    rows = []
    for name, Q, A in cases:
        n, m = Q.shape[0], A.shape[0]
        q = rng.standard_normal(n)
        u = 1 + rng.random(m)
        t0 = time.perf_counter()
        r = solve_sparse_auto(Q, A, q, -u, u, eps_abs=1e-6, eps_rel=1e-6,
                              verbose=False, device=dev)
        dt = time.perf_counter() - t0
        assert r.status == C.QPALM_SOLVED, (name, r.status_str)
        x, y = np.asarray(r.x), np.asarray(r.y)
        stat = float(np.abs(Q @ x + q + A.T @ y).max())
        Ax = A @ x
        pv = max(0.0, float((Ax - u).max()), float((-u - Ax).max()))
        rows.append({
            "case": name, "n": n, "m": m, "time_s": round(dt, 2),
            "iterations": int(r.iterations),
            "stationarity": f"{stat:.1e}", "primal_viol": f"{pv:.1e}",
        })
        print(f"{name}: {rows[-1]}", file=sys.stderr)

    fills = []
    for n, dens in [(sz(500), 0.01), (sz(1000), 0.005), (sz(2000), 0.002)]:
        Ar = sp.random(n, n, density=dens, random_state=rng, format="csc")
        M = (Ar @ Ar.T + sp.eye(n)).tocsc()
        f_amd = SparseLDL(M, ordering="amd").lnz
        f_rcm = SparseLDL(M, ordering="rcm").lnz
        fills.append({"n": n, "density": dens, "amd_lnz": int(f_amd),
                      "rcm_lnz": int(f_rcm),
                      "ratio": round(f_rcm / max(f_amd, 1), 2)})

    lines = [
        "# Sparse-backend benchmark",
        "",
        "Generated by `python -m qpalm_tpu_torch.scripts.bench_sparse` "
        f"(device {dev}).  All solves at eps 1e-6 through "
        "`solve_sparse_auto`, which routes by estimated factor cost: "
        "native LDL' (simplicial/supernodal, Schur/KKT form, AMD/RCM "
        "ordering) on the host or matrix-free preconditioned CG on the "
        "device.",
        "",
        "| case | n | m | time (s) | iters | stationarity | primal viol |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(f"| {r['case']} | {r['n']} | {r['m']} | "
                     f"{r['time_s']} | {r['iterations']} | "
                     f"{r['stationarity']} | {r['primal_viol']} |")
    lines += [
        "",
        "## AMD vs RCM ordering (exact LDL' fill, irregular patterns)",
        "",
        "| n | density | AMD lnz | RCM lnz | RCM/AMD |",
        "|---|---|---|---|---|",
    ]
    for f in fills:
        lines.append(f"| {f['n']} | {f['density']} | {f['amd_lnz']} | "
                     f"{f['rcm_lnz']} | {f['ratio']} |")
    lines.append("")
    path = out_path(args, "RESULTS_sparse.md")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print(json.dumps({"cases": rows, "fills": fills, "report": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
