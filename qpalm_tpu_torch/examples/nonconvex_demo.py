"""Nonconvex QP demo on the port (examples/nonconvex_demo.py): an
indefinite Hessian regularized by the LOBPCG gamma pin (reference:
examples/qpalm_mex_nonconvex_demo.m:16-19, settings.nonconvex = true).

    python -m qpalm_tpu_torch.examples.nonconvex_demo [--device cuda|cpu]
"""

import sys

import numpy as np

from ..scripts._common import device, parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = device(args)
    from .. import Settings, solve

    rng = np.random.default_rng(42)
    n = 10
    Q = rng.standard_normal((n, n))
    Q = 0.5 * (Q + Q.T)  # symmetric indefinite
    lam = np.linalg.eigvalsh(Q)
    print(f"eigenvalue range of Q: [{lam[0]:.3f}, {lam[-1]:.3f}]")

    A = np.eye(n)
    q = rng.standard_normal(n)
    res = solve(Q, A, q, -np.ones(n), np.ones(n),
                settings=Settings(nonconvex=True, eps_abs=1e-6, eps_rel=1e-6,
                                  verbose=True), device=dev)
    print("status:", res.info.status)
    x = res.solution.x
    print("x =", x)

    # stationarity on the box: interior coordinates have zero gradient,
    # boundary coordinates the right sign
    g = Q @ x + q
    for j in range(n):
        if abs(x[j]) < 1 - 1e-6:
            assert abs(g[j]) < 1e-4, (j, g[j])
        elif x[j] >= 1 - 1e-6:
            assert g[j] <= 1e-4
        else:
            assert g[j] >= -1e-4
    print("stationary point verified")
    return 0


if __name__ == "__main__":
    sys.exit(main())
