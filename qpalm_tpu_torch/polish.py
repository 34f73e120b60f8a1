"""Host float64 active-set polish (counterpart of the numpy path of
qpalm_tpu/polish.py:263-587), the port's own copy.

The f32 pass finds each lane's active set long before the last digits of x
are right.  The polish takes that active set and solves the equality-
constrained QP it implies with one regularized KKT factorization per lane
in float64 on the host:

    [ Q        A_act' ] [x]    [ -q    ]
    [ A_act   -delta*I ] [nu] = [ b_act ]      (inactive rows: nu_k = 0)

then refines against the unregularized system, re-detects the active set,
and runs the full unscaled KKT check (primal feasibility, stationarity,
complementarity sign) at the target eps.  A lane whose check fails is
reported not ok; the caller retries it or hands it to finish_np.

The numerics are numpy only.  `compress=True` solves the active-rows-only
system by numpy's batched LU here: the reference's native Bunch-Kaufman
path (native/batch_kkt.cpp) and its `precision="mixed"` are not copied yet
(ROADMAP.md, section 1 item 2), so this copy is slower than the
reference's at large n.  With `compress=False` it is the reference's
full-system path operation for operation.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np

from . import constants as C


class PolishResult(NamedTuple):
    x: np.ndarray  # (B, n) polished primal solutions
    y: np.ndarray  # (B, m) polished dual solutions
    ok: np.ndarray  # (B,) bool: full KKT check passed at (eps_abs, eps_rel)
    pri_res: np.ndarray  # (B,) achieved unscaled primal residual inf-norm
    dua_res: np.ndarray  # (B,) achieved unscaled dual residual inf-norm
    objective: np.ndarray  # (B,)


_DELTA_REG = 1e-9  # KKT regularization; removed by iterative refinement


def _np_solve_or_nan(K, rhs):
    """Batched np.linalg.solve that NaN-fills exactly-singular lanes
    instead of raising: a singular polish KKT (a wrong f32 active set on a
    degenerate problem) must mark the lane failed, not stop the batch."""
    try:
        return np.linalg.solve(K, rhs)
    except np.linalg.LinAlgError:
        # one singular lane fails the whole stacked call: find the singular
        # lanes by their condition number, NaN-fill only those, and solve
        # the healthy lanes in one batched call
        out = np.full(rhs.shape, np.nan, rhs.dtype)
        with np.errstate(all="ignore"):
            cond = np.linalg.cond(K)
        good = np.isfinite(cond) & (cond < 1.0 / np.finfo(K.dtype).eps)
        if good.any():
            try:
                out[good] = np.linalg.solve(K[good], rhs[good])
            except np.linalg.LinAlgError:
                # cond missed a numerically singular lane: solve the rest
                # one lane at a time
                for i in np.flatnonzero(good):
                    try:
                        out[i] = np.linalg.solve(K[i], rhs[i])
                    except np.linalg.LinAlgError:
                        pass
        return out


def _np_polish_chunk(Q, A, q, bmin, bmax, c, x0, y0,
                     eps_abs, eps_rel, act_tol, rounds, refine_steps,
                     compress=True):
    """Polish a (B, ...) chunk in numpy (qpalm_tpu/polish.py:298-509).

    `compress=True` solves the KKT system with the inactive rows removed
    (a symmetric permutation that moves each lane's active rows first,
    truncated at the chunk's largest active count): the inactive rows are
    decoupled `nu_k = 0` equations, so the compacted system has the same
    solution while the LU shrinks from (n+m)^3 to (n+mact_max)^3."""
    B, m, n = A.shape
    has_lb = bmin > -C.QPALM_INFTY
    has_ub = bmax < C.QPALM_INFTY
    # y_strong: a multiplier this large marks the row active regardless of
    #   slack (above the f32 dual noise at this tolerance); y_zero: |y| below
    #   this is numerically zero, aligned with the complementarity check
    y_strong, y_zero = act_tol, eps_abs
    eq = has_lb & has_ub & (
        bmax - bmin <= 1e-12 * np.maximum(1.0, np.abs(bmax))
    )

    def _mv(M, v):                       # (B, r, c) @ (B, c) -> (B, r)
        return np.matmul(M, v[:, :, None])[:, :, 0]

    def _vm(v, M):                       # (B, r) @ (B, r, c) -> (B, c)
        return np.matmul(v[:, None, :], M)[:, 0, :]

    def detect(x, y):
        # active: a clearly nonzero multiplier of the matching sign, or at
        # the bound without a wrong-sign multiplier (which un-sticks a row a
        # previous round forced to its bound); equalities always, on bmin
        Ax = _mv(A, x)
        act_lo = has_lb & (
            (y < -y_strong) | ((Ax - bmin < act_tol) & (y <= y_zero))
        )
        act_hi = has_ub & (
            (y > y_strong) | ((bmax - Ax < act_tol) & (y >= -y_zero))
        )
        act_lo = act_lo | eq
        act_hi = act_hi & ~act_lo
        return act_lo, act_hi

    def kkt_solve(act_lo, act_hi):
        act = act_lo | act_hi
        b_side = np.where(act_lo, bmin, bmax)
        if compress:
            # active rows first per lane, truncated at the chunk max
            order = np.argsort(~act, axis=1, kind="stable")
            cap = int(act.sum(axis=1).max()) if m else 0
            idx = order[:, :cap]                       # (B, cap)
            sel = np.take_along_axis(act, idx, 1)      # (B, cap)
            Asub = np.take_along_axis(A, idx[:, :, None], 1)
            bsub = np.take_along_axis(b_side, idx, 1)
            mc = cap
        else:
            idx = sel = None
            Asub, bsub, mc = A, b_side, m
        wc = sel if compress else act
        Aact = Asub * wc[:, :, None].astype(Q.dtype)
        nk = n + mc
        K = np.empty((B, nk, nk), Q.dtype)
        K[:, :n, :n] = Q
        K[:, :n, n:] = Aact.transpose(0, 2, 1)
        K[:, n:, :n] = Aact
        K22 = K[:, n:, n:]
        K22[...] = 0.0
        dix = np.arange(mc)
        K22[:, dix, dix] = np.where(wc, -_DELTA_REG, 1.0)
        rhs = np.concatenate([-q, np.where(wc, bsub, 0.0)], axis=1)
        sol = _np_solve_or_nan(K, rhs[:, :, None])[:, :, 0]
        for _ in range(refine_steps):
            sx, sn = sol[:, :n], sol[:, n:]
            top = _mv(Q, sx) + _vm(sn, Aact)
            bot = _mv(Aact, sx) + np.where(wc, 0.0, sn)
            r = rhs - np.concatenate([top, bot], axis=1)
            sol = sol + _np_solve_or_nan(K, r[:, :, None])[:, :, 0]
        x = sol[:, :n]
        if compress:
            y = np.zeros((B, m), Q.dtype)
            np.put_along_axis(y, idx, sol[:, n:] * sel, 1)
        else:
            y = np.where(act, sol[:, n:], 0.0)
        return x, y

    def check(x, y):
        Ax = _mv(A, x)
        z = np.clip(Ax, np.maximum(bmin, -C.QPALM_INFTY),
                    np.minimum(bmax, C.QPALM_INFTY))
        pri_norm = (np.max(np.abs(Ax - z), axis=1) if m
                    else np.zeros(B, x.dtype))
        Qx = _mv(Q, x)
        Aty = _vm(y, A)
        dua = Qx + q + Aty
        dua_norm = np.max(np.abs(dua), axis=1)
        eps_pri = eps_abs + eps_rel * np.maximum(
            np.max(np.abs(Ax), axis=1), np.max(np.abs(z), axis=1)
        )
        eps_dua = eps_abs + eps_rel * np.maximum(
            np.max(np.abs(Qx), axis=1),
            np.maximum(np.max(np.abs(q), axis=1),
                       np.max(np.abs(Aty), axis=1)),
        )
        comp_viol = (np.max(
            np.where(y > eps_abs, np.abs(Ax - bmax), 0.0)
            + np.where(y < -eps_abs, np.abs(Ax - bmin), 0.0), axis=1,
        ) if m else np.zeros(B, x.dtype))
        viol = np.maximum(
            np.maximum(pri_norm / eps_pri, dua_norm / eps_dua),
            comp_viol / (eps_pri + eps_abs),
        )
        obj = np.sum((0.5 * Qx + q) * x, axis=1) + c
        return viol, pri_norm, dua_norm, obj

    # best-point tracking: a misdetected round never degrades the result
    best_chk = check(x0, y0)
    best_x, best_y = x0.copy(), y0.copy()
    x, y = x0, y0
    for _ in range(rounds):
        act_lo, act_hi = detect(x, y)
        x, y = kkt_solve(act_lo, act_hi)
        chk = check(x, y)
        better = chk[0] < best_chk[0]
        best_chk = tuple(np.where(better, a, b)
                         for a, b in zip(chk, best_chk))
        best_x = np.where(better[:, None], x, best_x)
        best_y = np.where(better[:, None], y, best_y)
    viol, pri_norm, dua_norm, obj = best_chk
    return PolishResult(
        x=best_x, y=best_y, ok=viol <= 1.0,
        pri_res=pri_norm, dua_res=dua_norm, objective=obj,
    )


def polish_batch_np(
    data,
    x: np.ndarray,
    y: np.ndarray,
    eps_abs: float = 1e-6,
    eps_rel: float = 1e-6,
    act_tol: float = 1e-4,
    rounds: int = 2,
    refine_steps: int = 2,
    threads: int = 4,
    compress: bool = True,
) -> PolishResult:
    """Polish a stacked batch of f32 solutions to (eps_abs, eps_rel) in f64
    on the host (qpalm_tpu/polish.py:512-576, same contract).

    `data` holds the unscaled problem (Q, A, q, bmin, bmax, c), batch
    first, as numpy arrays or CPU tensors; `x`/`y` are the f32 pass's
    solutions.  The batch is cut into `threads` chunks polished in a thread
    pool (LAPACK releases the GIL), each with one BLAS thread.
    `compress=False` solves the full (n+m) KKT system; the default solves
    the compacted active-rows-only system, the same solution in exact
    arithmetic with another LU rounding path."""
    Q, A, q, bmin, bmax, c = (np.asarray(a, np.float64) for a in (
        data.Q, data.A, data.q, data.bmin, data.bmax, data.c))
    x0 = np.asarray(x, np.float64)
    y0 = np.asarray(y, np.float64)
    B = Q.shape[0]
    nch = max(1, min(threads, B))
    bounds = np.linspace(0, B, nch + 1).astype(int)
    args = [(Q[a:b], A[a:b], q[a:b], bmin[a:b], bmax[a:b], c[a:b],
             x0[a:b], y0[a:b], eps_abs, eps_rel, act_tol, rounds,
             refine_steps, compress)
            for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    # one BLAS thread per chunk: the chunks already use the cores, and the
    # per-lane LAPACK calls are too small for threaded BLAS
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # pragma: no cover - without it BLAS keeps its own
        import contextlib
        threadpool_limits = lambda limits: contextlib.nullcontext()
    with threadpool_limits(limits=1):
        if len(args) == 1:
            parts = [_np_polish_chunk(*args[0])]
        else:
            with ThreadPoolExecutor(max_workers=len(args)) as pool:
                parts = list(pool.map(lambda t: _np_polish_chunk(*t), args))
    return PolishResult(*(np.concatenate([getattr(p, f) for p in parts])
                          for f in PolishResult._fields))
