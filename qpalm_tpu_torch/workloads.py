"""The headline problem generator (copied from bench.py:110-120).

Random strictly convex dense QPs: Q = M M'/n + 0.1 I with a 50%-dense M,
dense A, and symmetric random boxes on Ax.  The headline batch is
make_problems(512, 64, 96, seed=7 + 1000 k) for round k.
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
