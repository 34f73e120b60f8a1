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

`mpc_chain` (the oscillating-masses chain MPC, reference chain80w.m) and
`SequentialMPC`, its closed loop over api.QPALM, are
qpalm_tpu/workloads.py:90-278.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import constants as C


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


def _chain_dynamics(n_masses: int, dt: float = 0.1):
    """Discretized oscillating-masses chain: nx = 2*n_masses states
    (positions, velocities), nu = n_masses - 1 actuators between masses."""
    nm = n_masses
    nx = 2 * nm
    nu = max(nm - 1, 1)
    # continuous: pos' = vel, vel' = spring coupling + actuation
    K = -2.0 * np.eye(nm)
    for i in range(nm - 1):
        K[i, i + 1] = 1.0
        K[i + 1, i] = 1.0
    Ac = np.zeros((nx, nx))
    Ac[:nm, nm:] = np.eye(nm)
    Ac[nm:, :nm] = K
    Bc = np.zeros((nx, nu))
    for j in range(nu):
        Bc[nm + j, j] = 1.0
        if nm + j + 1 < nx:  # single-mass chain: one direct actuator
            Bc[nm + j + 1, j] = -1.0
    # forward-Euler discretization
    Ad = np.eye(nx) + dt * Ac
    Bd = dt * Bc
    return Ad, Bd


def mpc_stage_permutation(nx: int, nu: int, N: int) -> np.ndarray:
    """Permutation taking z = [x_1..x_N | u_0..u_{N-1}] to stage-interleaved
    order z' = [x_1, u_0, x_2, u_1, ...] — the ordering under which the
    P-ALM Schur matrix is block-tridiagonal with block size nx+nu
    (the structure qpalm_tpu.parallel.block_tridiag partitions across
    devices)."""
    perm = []
    for k in range(N):
        perm.extend(range(k * nx, (k + 1) * nx))
        perm.extend(range(N * nx + k * nu, N * nx + (k + 1) * nu))
    return np.asarray(perm)


def mpc_chain(n_masses: int = 6, horizon: int = 10, x0=None, seed: int = 0):
    """Sparse (stage-banded) MPC QP for the oscillating-masses chain.

    Decision vector z = [x_1..x_N, u_0..u_{N-1}], with equality dynamics
    x_{k+1} = A x_k + B u_k, box constraints on states and inputs, and a
    quadratic tracking objective.  The banded structure is the KKT-block
    partitioning target flagged in SURVEY.md §2.4.

    Returns (Q, A, q, bmin, bmax, meta) with meta carrying what the
    closed loop (SequentialMPC) needs.
    """
    rng = np.random.default_rng(seed)
    Ad, Bd = _chain_dynamics(n_masses)
    nx, nu = Bd.shape
    N = horizon
    if x0 is None:
        x0 = 0.5 * rng.standard_normal(nx)
    x0 = np.asarray(x0, float)

    nz = N * nx + N * nu
    Qw = np.eye(nx)
    Rw = 0.1 * np.eye(nu)
    H = np.zeros((nz, nz))
    for k in range(N):
        H[k * nx:(k + 1) * nx, k * nx:(k + 1) * nx] = Qw
        off = N * nx + k * nu
        H[off:off + nu, off:off + nu] = Rw
    q = np.zeros(nz)

    # dynamics: x_{k+1} - A x_k - B u_k = (A x0 for k=0, else 0)
    m_eq = N * nx
    Aeq = np.zeros((m_eq, nz))
    beq = np.zeros(m_eq)
    for k in range(N):
        rows = slice(k * nx, (k + 1) * nx)
        Aeq[rows, k * nx:(k + 1) * nx] = np.eye(nx)
        if k > 0:
            Aeq[rows, (k - 1) * nx:k * nx] = -Ad
        off = N * nx + k * nu
        Aeq[rows, off:off + nu] = -Bd
    beq[:nx] = Ad @ x0

    # box constraints on all states and inputs
    Abox = np.eye(nz)
    x_lim = 4.0 * np.ones(N * nx)
    u_lim = 0.5 * np.ones(N * nu)
    lb_box = -np.concatenate([x_lim, u_lim])
    ub_box = np.concatenate([x_lim, u_lim])

    A = np.vstack([Aeq, Abox])
    bmin = np.concatenate([beq, lb_box])
    bmax = np.concatenate([beq, ub_box])
    meta = {
        "Ad": Ad, "Bd": Bd, "nx": nx, "nu": nu, "N": N, "x0": x0,
        "m_eq": m_eq,
    }
    return H, A, q, bmin, bmax, meta


class SequentialMPC:
    """The closed-loop MPC: solve, apply u_0, step the plant, shift the
    initial-state equality, warm start, re-solve — the reference's
    chain80w/randomMPCsequential protocol (chain80w.m:86-120), through the
    port's QPALM on `device` (with stage_structured=True on the
    stage-interleaved problem by FACTORIZE_STAGE, block Thomas on K2), or
    with backend="sparse" through the host
    sparse-direct lifecycle (host_sparse.SparseQPALM: the symbolic analysis
    made once and reused across the bound updates).  A device step reads
    the solution and Info off the device (one copy) and uploads the
    shifted bounds, nothing else."""

    def __init__(self, n_masses=6, horizon=10, seed=0, settings=None,
                 stage_structured=False, backend="device", device="cuda"):
        from .api import QPALM
        from .types import Settings

        H, A, q, bmin, bmax, meta = mpc_chain(n_masses, horizon, seed=seed)
        self.meta = meta
        self.bmin = bmin
        self.bmax = bmax
        settings = settings or Settings(
            eps_abs=1e-6, eps_rel=1e-6, proximal=False, scaling=2,
            verbose=False,
        )
        self._sparse = backend == "sparse"
        self._perm = None
        if stage_structured and not self._sparse:
            # stage-interleave the variables so that the Newton system is
            # block-tridiagonal, solved in O(S nb^3) by block Thomas
            # (qpalm_tpu/workloads.py:223-234)
            self._perm = mpc_stage_permutation(meta["nx"], meta["nu"],
                                               meta["N"])
            H = H[np.ix_(self._perm, self._perm)]
            A = A[:, self._perm]
            q = q[self._perm]
            settings = settings.replace(
                factorization_method=C.FACTORIZE_STAGE,
                stage_block=meta["nx"] + meta["nu"])
        if self._sparse:
            import scipy.sparse as sp

            from .host_sparse import SparseQPALM

            self.solver = SparseQPALM(sp.csc_matrix(H), sp.csc_matrix(A), q,
                                      bmin, bmax, settings=settings)
        else:
            self.solver = QPALM(H, A, q, bmin, bmax, settings=settings,
                                device=device)
        self.x = meta["x0"].copy()
        self._prev = None

    def step(self):
        """One closed-loop step. Returns (status, iters, u0)."""
        meta = self.meta
        nx, nu, N = meta["nx"], meta["nu"], meta["N"]
        if self._prev is not None:
            self.solver.warm_start(self._prev[0], self._prev[1])
        if self._sparse:
            r = self.solver.solve()
            status = C.STATUS_STRINGS.get(r.status, "?")
            iters, z, y = r.iterations, r.x, r.y
        else:
            res = self.solver.solve()
            status, iters = res.info.status, res.info.iter
            z, y = res.solution.x, res.solution.y
        self._prev = (z, y)
        if self._perm is not None:
            z = np.empty_like(z)
            z[self._perm] = self._prev[0]  # back to [x_1..x_N | u_0..]
        u0 = z[N * nx: N * nx + nu]
        # plant update and receding-horizon bound shift
        self.x = meta["Ad"] @ self.x + meta["Bd"] @ u0
        self.bmin[:nx] = meta["Ad"] @ self.x
        self.bmax[:nx] = self.bmin[:nx]
        self.solver.update_bounds(self.bmin, self.bmax)
        return status, iters, u0

    def run(self, n_steps: int) -> List[int]:
        iters = []
        for _ in range(n_steps):
            status, it, _ = self.step()
            assert status == "solved", status
            iters.append(it)
        return iters
