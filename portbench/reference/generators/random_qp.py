"""QPALM's random QP class (simulations/randomQP.m): at a size n of its
sweep n = 20:20:100, m = n constraints, Q = M M' with M n x n and about
`density` of its entries N(0, 1) (sprandn), A m x n at the same density,
q ~ N(0, I), and symmetric boxes -u <= Ax <= u with u ~ U(0, 2), so that
x = 0 is feasible and every problem has its solution."""

from __future__ import annotations

import numpy as np


def problems(cfg, batch, seed):
    """`batch` problems (Q, A, q, bmin, bmax) of the configuration `cfg`
    (its n, m and density), from `seed` (an int or a sequence of ints)."""
    n, m, d = int(cfg["n"]), int(cfg["m"]), float(cfg["density"])
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((batch, n, n)) * (rng.random((batch, n, n)) < d)
    Q = M @ M.transpose(0, 2, 1)
    A = rng.standard_normal((batch, m, n)) * (rng.random((batch, m, n)) < d)
    q = rng.standard_normal((batch, n))
    u = 2.0 * rng.random((batch, m))
    return [(Q[i], A[i], q[i], -u[i], u[i]) for i in range(batch)]
