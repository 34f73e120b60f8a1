"""Problem generators of the benchmarks, copied so that the port needs no
JAX to make them.

`make_problems` (bench.py:110-120) makes the headline class: random
strictly convex dense QPs, Q = M M'/n + 0.1 I with a 50%-dense M, dense A,
and symmetric random boxes on Ax.  The headline batch is
make_problems(512, 64, 96, seed=7 + 1000 k) for round k.

`boxqp` (scripts/bench_nonconvex.py:39-52) makes BOXQP-d: a dense
symmetric indefinite Q, x in [-1, 1]^n and n/4 coupling rows bounded by
+-2 (m = n + n/4).  That bench's rows are boxqp(n, seed=1000 n + i).
"""

from __future__ import annotations

import numpy as np


def make_problems(batch, n, m, seed=7):
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(batch):
        M = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.5)
        Q = M @ M.T / n + 0.1 * np.eye(n)
        A = rng.standard_normal((m, n))
        q = rng.standard_normal(n)
        u = 2 * rng.random(m)
        probs.append((Q, A, q, -u, u))
    return probs


def boxqp(n, seed, coupling=True):
    rng = np.random.default_rng(seed)
    Qf = rng.standard_normal((n, n))
    Q = 0.5 * (Qf + Qf.T)  # indefinite
    q = rng.standard_normal(n)
    if coupling:
        A = np.concatenate([np.eye(n), rng.standard_normal((n // 4, n))])
        bmin = np.concatenate([-np.ones(n), -2.0 * np.ones(n // 4)])
        bmax = np.concatenate([np.ones(n), 2.0 * np.ones(n // 4)])
    else:
        A = np.eye(n)
        bmin, bmax = -np.ones(n), np.ones(n)
    return Q, A, q, bmin, bmax
