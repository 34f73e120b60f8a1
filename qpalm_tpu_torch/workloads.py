"""Problem generators of the benchmarks, copied so that the port needs no
JAX to make them.

`make_problems` (bench.py:110-120) makes the headline class: random
strictly convex dense QPs, Q = M M'/n + 0.1 I with a 50%-dense M, dense A,
and symmetric random boxes on Ax.  The headline batch is
make_problems(512, 64, 96, seed=7 + 1000 k) for round k.

`boxqp` (scripts/bench_nonconvex.py:39-52) makes BOXQP-d: a dense
symmetric indefinite Q, x in [-1, 1]^n and n/4 coupling rows bounded by
+-2 (m = n + n/4).  That bench's rows are boxqp(n, seed=1000 n + i).

`random_qp`, `lasso` and `portfolio` are the families of the workloads
sweep (scripts/bench_workloads.py, sweep.py), copied bit for bit from
qpalm_tpu/workloads.py:24-87.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def random_qp(n: int, m: Optional[int] = None, density: float = 0.5,
              seed: int = 0) -> Tuple:
    """Random convex QP (reference protocol: simulations/randomQP.m:22-47)."""
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    M = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    Q = M @ M.T / n + 1e-2 * np.eye(n)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    q = rng.standard_normal(n)
    u = rng.random(m) * 2.0
    return Q, A, q, -u, u


def lasso(n: int, gamma: float = 1.0, seed: int = 0) -> Tuple:
    """Sparse regressor selection / lasso QP (reference: simulations/lasso.m).

    Variables are [x (n); residual t (m); abs-value bound s (n)] with
    minimize 0.5||t||^2 + gamma 1's  s.t.  Cx - t = d, -s <= x <= s.
    """
    rng = np.random.default_rng(seed)
    m = 2 * n
    C = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.5)
    x_hat = (rng.standard_normal(n) * (rng.random(n) < 0.5)) / n
    d = C @ x_hat + rng.standard_normal(m) / 4
    N = n + m + n
    Q = np.zeros((N, N))
    Q[n:n + m, n:n + m] = np.eye(m)
    A = np.zeros((m + 2 * n, N))
    A[:m, :n] = C
    A[:m, n:n + m] = -np.eye(m)
    A[m:m + n, :n] = np.eye(n)
    A[m:m + n, n + m:] = np.eye(n)
    A[m + n:, :n] = -np.eye(n)
    A[m + n:, n + m:] = np.eye(n)
    lb = np.concatenate([d, np.zeros(2 * n)])
    ub = np.concatenate([d, np.full(2 * n, 1e20)])
    q = np.concatenate([np.zeros(n + m), gamma * np.ones(n)])
    return Q, A, q, lb, ub


def portfolio(n: int, gamma: float = 1.0, seed: int = 0) -> Tuple:
    """Factor-model portfolio QP (reference: simulations/portfolio.m:22-50).

    Variables [w (n); y (k)], minimize 0.5 w'Dw + 0.5||y||^2 - gamma mu'w
    s.t. 1'w = 1, F'w = y, 0 <= w <= 1e20.
    """
    rng = np.random.default_rng(seed)
    k = max(1, int(np.ceil(n / 10)))
    F = rng.standard_normal((n, k)) * (rng.random((n, k)) < 0.5)
    D = np.diag(rng.random(n) * np.sqrt(k))
    mu = rng.standard_normal(n)
    N = n + k
    Q = np.zeros((N, N))
    Q[:n, :n] = D
    Q[n:, n:] = np.eye(k)
    A = np.zeros((1 + k + n, N))
    A[0, :n] = 1.0
    A[1:1 + k, :n] = F.T
    A[1:1 + k, n:] = -np.eye(k)
    A[1 + k:, :n] = np.eye(n)
    lb = np.concatenate([[1.0], np.zeros(k + n)])
    ub = np.concatenate([[1.0], np.zeros(k), np.full(n, 1e20)])
    q = np.concatenate([-gamma * mu, np.zeros(k)])
    return Q, A, q, lb, ub
