"""The "Random QP" problem class of OSQP's benchmark suite (Stellato,
Banjac, Goulart, Bemporad and Boyd, OSQP: an operator splitting solver for
quadratic programs, Math. Prog. Comp. 12 (2020), its appendix on the
benchmark problems):

    minimise 0.5 x'Px + q'x  subject to  l <= Ax <= u

at n variables and m = 10 n constraints, with P = M M' + alpha I, M n x n
with about `density` (15%) of its entries N(0, 1), A m x n at the same
density, q ~ N(0, I), and two-sided bounds l = -U(0, 1), u = U(0, 1)
drawn apart, so that x = 0 is feasible and P > 0 makes the solution
unique.  The suite's code draws its sparse matrices with
scipy.sparse.random and may draw one-sided constraints (u = A v + U(0,
1), l = -inf) where the paper states two-sided ones; it is not in this
repository to check against, and this follows the paper.  Here each entry is nonzero with probability `density`, stored
dense."""

from __future__ import annotations

import numpy as np


def _sparse_normal(rng, shape, density):
    """An array of `shape` whose entries are N(0, 1) with probability
    `density` and 0 otherwise (only the nonzeros are drawn from the normal
    distribution)."""
    mask = rng.random(shape) < density
    out = np.zeros(shape)
    out[mask] = rng.standard_normal(int(mask.sum()))
    return out


def problems(cfg, batch, seed):
    """`batch` problems (P, A, q, l, u) of the configuration `cfg` (its n,
    m, density and alpha), from `seed` (an int or a sequence of ints)."""
    n, m = int(cfg["n"]), int(cfg["m"])
    d, alpha = float(cfg["density"]), float(cfg["alpha"])
    rng = np.random.default_rng(seed)
    M = _sparse_normal(rng, (batch, n, n), d)
    P = M @ M.transpose(0, 2, 1)
    P[:, np.arange(n), np.arange(n)] += alpha
    A = _sparse_normal(rng, (batch, m, n), d)
    q = rng.standard_normal((batch, n))
    lo = -rng.random((batch, m))
    hi = rng.random((batch, m))
    return [(P[i], A[i], q[i], lo[i], hi[i]) for i in range(batch)]
