"""Host-facing solver API for one problem (counterpart of qpalm_tpu/api.py).

`QPALM` mirrors the reference lifecycle qpalm_setup / qpalm_warm_start /
qpalm_solve / qpalm_update_* (reference: include/qpalm.h:43-138,
interfaces/python/qpalm.py:191-226).  The problem is padded in numpy, as in
the reference, and solved by the port's batch-first general loop
(solver/core.py) as a batch of one on `device`: kernel K2 factors and
solves the Newton systems on the card, its plain twins on the CPU.

The sparse branch (`sparse=True`, scipy-sparse input from n = 2048, or
FACTORIZE_CG) keeps Q and A sparse (linalg.sparse.SparseMatrix, no
padding) and solves the Newton systems matrix-free with preconditioned CG
(FACTORIZE_CG, Jacobi or block-Jacobi on K2); no n x n matrix is formed.
`solve` sends large scipy-sparse convex problems to
`host_sparse.solve_sparse_auto` (the native sparse-direct solvers, or CG
on `device`), as the reference does.

FACTORIZE_STAGE keeps the problem's exact shapes (no padding, which
would shift the stage blocks) and solves each Newton system by block
Thomas on the stage blocks (parallel/block_tridiag.py, K2 a stage).

The host keeps copies of the padded bounds, so an update uploads them
and reads nothing back; a solve reads its result off the device in
one copy.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from . import constants as C
from .batch import _PAD_BOUND, _densify, _round_up, check_device, \
    pad_problem
from .linalg.sparse import from_scipy
from .scaling import scale_data
from .solver import core
from .solver.nonconvex import lobpcg_min_eig
from .types import Info, QPData, Settings, Solution, SolveResult
from .validate import validate_data, validate_settings

__all__ = ["QPALM", "solve", "Settings"]


class QPALM:
    """A QPALM solver instance for one problem on `device` ("cuda": the
    CUDA kernels; "cpu": their plain twins).

    minimize 0.5 x'Qx + q'x + c   s.t.   bmin <= A x <= bmax

    Accepts dense numpy arrays or scipy sparse matrices for Q (n x n,
    symmetric) and A (m x n).  Sparse input is densified unless the sparse
    branch takes it: `sparse=True`, or None with scipy input from n = 2048
    or FACTORIZE_CG.
    """

    def __init__(self, Q, A, q, bmin, bmax, c=0.0,
                 settings: Optional[Settings] = None,
                 pad_multiple: int = 8,
                 sparse: Optional[bool] = None,
                 device="cuda"):
        t0 = time.perf_counter()
        settings = settings or Settings()
        validate_settings(settings)
        self.device = check_device(device)
        q = np.asarray(q, float).ravel()
        bmin = np.asarray(bmin, float).ravel()
        bmax = np.asarray(bmax, float).ravel()

        is_scipy = hasattr(Q, "tocoo") and hasattr(A, "tocoo")
        if sparse is None:
            sparse = (is_scipy and Q.shape[0] >= 2048) \
                or settings.factorization_method == C.FACTORIZE_CG
        self.sparse = bool(sparse)
        dtype = np.dtype(settings.dtype)

        if self.sparse:
            # the large-problem path (qpalm_tpu/api.py:124-164): Q and A
            # stay sparse, no padding, Newton systems by CG
            if not is_scipy:
                Q = sp.csc_matrix(np.asarray(Q))
                A = sp.csc_matrix(np.asarray(A))
            self.n, self.m = validate_data(Q, A, q, bmin, bmax)
            if settings.enable_dual_termination:
                raise ValueError(
                    "enable_dual_termination requires a factorization of Q "
                    "and is unsupported on the sparse (CG) path")
            settings = settings.replace(factorization_method=C.FACTORIZE_CG)
            self._n_pad, self._m_pad = self.n, max(self.m, 1)
            bl = np.maximum(np.asarray(bmin, dtype), -_PAD_BOUND)
            bu = np.minimum(np.asarray(bmax, dtype), _PAD_BOUND)
            if self.m == 0:
                A = sp.csc_matrix((1, self.n))
                bl = np.array([-_PAD_BOUND], dtype)
                bu = np.array([_PAD_BOUND], dtype)
            self._bl, self._bu = bl, bu
            tensor = lambda a: torch.from_numpy(  # noqa: E731
                np.asarray(a, dtype)[None]).to(self.device)
            self._data = QPData(
                Q=from_scipy(Q, dtype, self.device),
                A=from_scipy(A, dtype, self.device), q=tensor(q),
                bmin=tensor(bl), bmax=tensor(bu), c=tensor(c))
        else:
            Q = _densify(Q)
            A = _densify(A)
            self.n, self.m = validate_data(Q, A, q, bmin, bmax)
            if settings.factorization_method == C.FACTORIZE_STAGE:
                # padding would shift the stage blocks: exact shapes
                # (qpalm_tpu/api.py:169-175)
                if self.n % settings.stage_block:
                    raise ValueError("FACTORIZE_STAGE: n must be divisible "
                                     "by stage_block")
                pad_multiple = 1
            self._n_pad = _round_up(self.n, pad_multiple)
            self._m_pad = _round_up(max(self.m, 1), pad_multiple)
            Qp, Ap, qp, bl, bu = pad_problem(Q, A, q, bmin, bmax,
                                             self._n_pad, self._m_pad, dtype)
            # clip user infinities to the QPALM convention; the host keeps
            # the bounds for the updates
            self._bl = np.maximum(bl, -_PAD_BOUND)
            self._bu = np.minimum(bu, _PAD_BOUND)
            self._data = QPData(*(torch.from_numpy(a[None]).to(self.device)
                                  for a in (Qp, Ap, qp, self._bl, self._bu,
                                            np.asarray(c, dtype))))

        # nonconvex setup: the minimum eigenvalue of the *scaled* Q pins
        # gamma (reference: qpalm_setup -> set_settings_nonconvex,
        # qpalm.c:294-296; qpalm_tpu/api.py:195-225)
        self._gamma_override: Optional[float] = None
        if settings.nonconvex:
            sQ = scale_data(self._data, settings.scaling)[0].Q \
                if settings.scaling else self._data.Q
            if self.n <= 3:
                # LOBPCG's 3-vector subspace degenerates for n <= 3; the
                # margin keeps Q + I/gamma strictly PD (nonconvex.c:122-124)
                Qs = (sQ.to_dense() if self.sparse else sQ[0]) \
                    [:self.n, :self.n].cpu().numpy()
                lam = float(np.linalg.eigvalsh(Qs)[0]) - 1e-6
            else:
                # the start vector spans the padded dims too
                x0 = np.random.default_rng(0).random(self._n_pad) \
                    .astype(dtype)
                x0 /= np.linalg.norm(x0)
                lam = float(lobpcg_min_eig(
                    sQ, torch.from_numpy(x0[None]).to(self.device))[0])
            if lam < 0:
                settings = settings.replace(proximal=True)
                self._gamma_override = 1.0 / abs(lam)
            else:
                settings = settings.replace(nonconvex=False)
        self.settings = settings

        self._ws_x: Optional[np.ndarray] = None
        self._ws_y: Optional[np.ndarray] = None
        self._initialized = False  # a warm start is pending
        self.info: Optional[Info] = None
        self.solution: Optional[Solution] = None
        self._setup_time = time.perf_counter() - t0

    # -- lifecycle ---------------------------------------------------------

    def warm_start(self, x=None, y=None):
        """Starting iterates for the next solve only (reference:
        qpalm_warm_start, src/qpalm.c:322-399)."""
        dtype = np.dtype(self.settings.dtype)
        self._ws_x = self._ws_y = None
        if x is not None:
            self._ws_x = np.zeros(self._n_pad, dtype)
            self._ws_x[:self.n] = np.asarray(x, float).ravel()
        if y is not None:
            self._ws_y = np.zeros(self._m_pad, dtype)
            self._ws_y[:self.m] = np.asarray(y, float).ravel()
        self._initialized = True

    def solve(self) -> SolveResult:
        """Run the solver (reference: qpalm_solve, src/qpalm.c:401-736)."""
        settings = self.settings
        dev = self.device

        def ws(v):
            if not self._initialized or v is None:
                return None
            return torch.from_numpy(v[None]).to(dev)

        gi = None
        if self._gamma_override is not None:
            gi = torch.full((1,), self._gamma_override,
                            dtype=self._data.Q.dtype, device=dev)
        if settings.verbose:
            # header and run banner (reference: util.c:107-119)
            print(f"qpalm_tpu 0.1.0  (n = {self.n}, m = {self.m})")
            print("  iter |   pri res    |   dua res    |     tau")
        t0 = time.perf_counter()
        st, sdata, scal = core.setup(self._data, settings, ws(self._ws_x),
                                     ws(self._ws_y), gi, gi)
        if settings.time_limit >= C.QPALM_INFTY:
            final = core.solve_from_state(st, sdata, scal, settings)
        else:
            # host chunking in place of the reference's in-loop wall-clock
            # abort (qpalm.c:680-708; qpalm_tpu/api.py:273-299)
            chunk = max(1, min(200, settings.max_iter))
            limit = chunk
            while True:
                final = core.solve_from_state(st, sdata, scal, settings,
                                              max_iter=limit)
                if bool(final.done[0]) or int(final.iter[0]) >= \
                        settings.max_iter:
                    break
                if time.perf_counter() - t0 > settings.time_limit:
                    final = final._replace(status=torch.full_like(
                        final.status, C.QPALM_TIME_LIMIT_REACHED))
                    break
                st = final
                limit = min(limit + chunk, settings.max_iter)
        x_sol, y_sol, obj = core.finalize(final, sdata, scal, settings)
        # one copy off the device: x, y, the certificates and the numbers
        # of Info
        n_pad, m_pad = self._n_pad, self._m_pad
        nums = (final.iter, final.iter_out, final.status,
                final.pri_res_norm, final.dua_res_norm,
                final.dua2_res_norm, obj, final.dual_objective)
        host = torch.cat([x_sol[0].double(), y_sol[0].double(),
                          final.delta_x[0].double(),
                          final.delta_y[0].double(),
                          torch.stack([t[0].double() for t in nums])]
                         ).cpu().numpy()
        solve_time = time.perf_counter() - t0
        xs, ys = host[:n_pad], host[n_pad:n_pad + m_pad]
        dx = host[n_pad + m_pad:2 * n_pad + m_pad]
        dy = host[2 * n_pad + m_pad:2 * (n_pad + m_pad)]
        it, it_out, status, pri, dua, dua2, objective, dual_obj = \
            host[2 * (n_pad + m_pad):].tolist()
        if settings.verbose:
            # the final boxed message (reference: util.c:121-206)
            print("-" * 54)
            print(f"status:     {C.STATUS_STRINGS.get(int(status), 'unknown')}")
            print(f"iterations: {int(it)} (outer: {int(it_out)})")
            print(f"objective:  {objective:.6e}")
            print(f"pri res:    {pri:.4e}   dua res: {dua:.4e}")
            print(f"solve time: {solve_time:.6f} s")
            print("-" * 54)

        self._initialized = False  # one-shot warm start (qpalm.c:497)
        info = Info(iter=int(it), iter_out=int(it_out),
                    status_val=int(status), pri_res_norm=pri,
                    dua_res_norm=dua, dua2_res_norm=dua2,
                    objective=objective, dual_objective=dual_obj,
                    setup_time=self._setup_time, solve_time=solve_time,
                    run_time=self._setup_time + solve_time)
        sol = Solution(x=xs[:self.n].copy(), y=ys[:self.m].copy())
        self.info = info
        self.solution = sol
        return SolveResult(solution=sol, info=info,
                           delta_x=dx[:self.n].copy(),
                           delta_y=dy[:self.m].copy(), state=final)

    # -- parametric updates (reference: src/qpalm.c:739-871) ---------------

    def update_settings(self, settings: Settings):
        validate_settings(settings)
        if settings.scaling < self.settings.scaling:
            raise ValueError(
                "Decreasing the number of scaling iterations is not allowed"
            )
        self.settings = settings

    def _upload(self, **fields):
        dtype = np.dtype(self.settings.dtype)
        self._data = self._data._replace(**{
            k: torch.from_numpy(np.asarray(v, dtype)[None]).to(self.device)
            for k, v in fields.items()})

    def update_bounds(self, bmin=None, bmax=None):
        bl, bu = self._bl, self._bu
        if bmin is not None:
            new_bl = np.asarray(bmin, float).ravel()
            if new_bl.shape != (self.m,):
                raise ValueError("bmin must have length m")
            bl = bl.copy()
            bl[:self.m] = np.maximum(new_bl, -_PAD_BOUND)
        if bmax is not None:
            new_bu = np.asarray(bmax, float).ravel()
            if new_bu.shape != (self.m,):
                raise ValueError("bmax must have length m")
            bu = bu.copy()
            bu[:self.m] = np.minimum(new_bu, _PAD_BOUND)
        if np.any(bl > bu):
            raise ValueError("Lower bound greater than upper bound")
        self._bl, self._bu = bl, bu
        self._upload(bmin=bl, bmax=bu)

    def update_q(self, q):
        new_q = np.asarray(q, float).ravel()
        if new_q.shape != (self.n,):
            raise ValueError("q must have length n")
        qp = np.zeros(self._n_pad)
        qp[:self.n] = new_q
        self._upload(q=qp)


def solve(Q, A, q, bmin, bmax, c=0.0, settings: Optional[Settings] = None,
          x0=None, y0=None, device="cuda", **settings_kw) -> SolveResult:
    """One-shot convenience wrapper: setup, (warm start), solve on
    `device`.

    Large scipy-sparse convex problems (n >= 2048 with no explicit
    factorization_method) route through `host_sparse.solve_sparse_auto`,
    which picks the native direct LDL' backends or matrix-free CG (on
    `device`) by estimated factor cost, as qpalm_tpu/api.py:388-410 does;
    its result is repackaged as a SolveResult of numpy arrays with no
    state."""
    if settings is None:
        settings = Settings(**settings_kw)
    elif settings_kw:
        settings = settings.replace(**settings_kw)
    is_scipy = hasattr(Q, "tocoo") and hasattr(A, "tocoo")
    if (is_scipy and Q.shape[0] >= 2048
            and not settings.enable_dual_termination
            and settings.factorization_method == C.FACTORIZE_KKT_OR_SCHUR
            and settings.time_limit >= C.QPALM_INFTY):
        from .host_sparse import solve_sparse_auto

        t0 = time.perf_counter()
        r = solve_sparse_auto(Q, A, q, bmin, bmax, settings, c=c, x0=x0,
                              y0=y0, device=device)
        dt = time.perf_counter() - t0
        nan_n = np.full(np.shape(q), np.nan)
        nan_m = np.full(np.shape(bmin), np.nan)
        return SolveResult(
            solution=Solution(x=np.asarray(r.x), y=np.asarray(r.y)),
            info=Info(iter=int(r.iterations), iter_out=0,
                      status_val=int(r.status),
                      pri_res_norm=float(r.pri_res_norm),
                      dua_res_norm=float(r.dua_res_norm),
                      dua2_res_norm=float("nan"),
                      objective=float(r.objective),
                      dual_objective=float("nan"), setup_time=0.0,
                      solve_time=dt, run_time=dt),
            delta_x=np.asarray(r.delta_x) if r.delta_x is not None
            else nan_n,
            delta_y=np.asarray(r.delta_y) if r.delta_y is not None
            else nan_m,
            state=None)
    solver = QPALM(Q, A, q, bmin, bmax, c=c, settings=settings,
                   device=device)
    if x0 is not None or y0 is not None:
        solver.warm_start(x0, y0)
    return solver.solve()
