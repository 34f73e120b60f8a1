"""Large sparse QP demo on the port (examples/sparse_demo.py): the direct
and matrix-free backends side by side.

The large-sparse front door (host_sparse.solve_sparse_auto) routes by
estimated factor cost: the native LDL' backends on the host (simplicial or
supernodal, AMD/RCM ordering, Schur or quasi-definite KKT form) while a
factorization stays cheap, matrix-free preconditioned CG on the device
past the budget.  Three classes through the auto-router and one through
QPALM's CG path (api.QPALM with sparse scipy input), at eps 1e-6.
`--scale` multiplies every size (1: the reference's).

    python -m qpalm_tpu_torch.examples.sparse_demo [--device cuda|cpu]
        [--scale 1.0]
"""

import sys
import time

import numpy as np

from ..scripts._common import device, parser


def kkt_report(Q, A, q, u, r, label, t):
    x, y = np.asarray(r.x), np.asarray(r.y)
    g = Q @ x + q + A.T @ y
    Ax = A @ x
    pv = max(0.0, float((Ax - u).max()), float((-u - Ax).max()))
    print(f"{label:>28}: {r.status_str}, {r.iterations} iters, "
          f"{t:.2f}s, stationarity {np.abs(g).max():.1e}, "
          f"primal viol {pv:.1e}")


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    dev = device(args)
    import scipy.sparse as sp

    from .. import QPALM, Settings, solve_sparse_auto

    rng = np.random.default_rng(0)
    sz = lambda v: max(8, int(round(v * args.scale)))  # noqa: E731

    # 1) banded, ill-conditioned: direct LDL' (simplicial + AMD)
    n, m = sz(5000), sz(2000)
    L = sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1])
    Q = (L @ L + 1e-6 * sp.eye(n)).tocsc()
    A = sp.diags([np.ones(m), 0.5 * np.ones(m)], [0, 1],
                 shape=(m, n)).tocsc()
    q = rng.standard_normal(n)
    u = 1 + rng.random(m)
    t0 = time.perf_counter()
    r = solve_sparse_auto(Q, A, q, -u, u, eps_abs=1e-6, eps_rel=1e-6,
                          verbose=False, device=dev)
    kkt_report(Q, A, q, u, r, "banded ill-cond (LDL')",
               time.perf_counter() - t0)

    # 2) banded Q + a few dense rows in A: the quasi-definite KKT form
    #    keeps the factor sparse where the Schur form would densify
    A2 = sp.vstack([sp.diags(np.ones(m - 5), 0, shape=(m - 5, n)),
                    sp.csc_matrix(rng.standard_normal((5, n)) / np.sqrt(n))
                    ]).tocsc()
    t0 = time.perf_counter()
    r = solve_sparse_auto(Q, A2, q, -u, u, eps_abs=1e-6, eps_rel=1e-6,
                          verbose=False, device=dev)
    kkt_report(Q, A2, q, u, r, "dense rows (KKT form)",
               time.perf_counter() - t0)

    # 3) irregular random sparsity with heavy fill: supernodal panels
    n3, m3 = sz(2000), sz(1500)
    Qr = sp.random(n3, n3, density=0.003, random_state=rng)
    Q3 = (Qr @ Qr.T + sp.eye(n3)).tocsc()
    A3 = (sp.random(m3, n3, density=0.003, random_state=rng)
          + 0.5 * sp.eye(m3, n3)).tocsc()
    q3 = rng.standard_normal(n3)
    u3 = 1 + rng.random(m3)
    t0 = time.perf_counter()
    r = solve_sparse_auto(Q3, A3, q3, -u3, u3, eps_abs=1e-6, eps_rel=1e-6,
                          verbose=False, device=dev)
    kkt_report(Q3, A3, q3, u3, r, "heavy fill (supernodal)",
               time.perf_counter() - t0)

    # 4) the matrix-free CG path on the device (no n x n memory): its home
    #    is well-conditioned operators
    Q4 = sp.diags([2.0 * np.ones(n), -0.5 * np.ones(n - 1),
                   -0.5 * np.ones(n - 1)], [0, 1, -1]).tocsc()
    m4 = sz(7000)
    A4 = sp.random(m4, n, density=5e-4, random_state=1,
                   data_rvs=rng.standard_normal).tocsc()
    u4 = 2 * rng.random(m4) + 0.5
    t0 = time.perf_counter()
    solver = QPALM(Q4, A4, q, -u4, u4,
                   settings=Settings(eps_abs=1e-6, eps_rel=1e-6,
                                     verbose=False, delta=10.0), device=dev)
    res = solver.solve()
    print(f"{'matrix-free CG (class)':>28}: {res.info.status}, "
          f"{int(res.info.iter)} iters, {time.perf_counter()-t0:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
