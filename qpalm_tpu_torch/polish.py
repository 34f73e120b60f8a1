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

`compress=True` (the default) solves the active-rows-only system by the
native batched Bunch-Kaufman factor (dsytrf/dsytrs, native/batch_kkt.cpp
in libqpalm_ldl, linalg/sparse_direct.py) whenever that library loads, as
the reference does: half the operations of an LU on these symmetric
systems, and the factor is reused by the refinement's re-solves.  Lanes
the factor cannot serve fall back to numpy's LU on a rebuilt K;
`precision="mixed"` factors in float32 and refines in float64.  Without
the library it solves by numpy's batched LU (qpalm_tpu/polish.py:381).
With `compress=False` it is the reference's full-system path operation
for operation, numpy LU included.
"""

from __future__ import annotations

import threading
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

# Per-thread reusable K buffers: the bench calls the polish once a round
# with the same shapes, and a fresh np.zeros of a large stack costs its
# page faults every time.  Keyed by (shape, dtype); only the last buffer
# of each thread is kept (qpalm_tpu/polish.py:54-84).
_kbuf_local = threading.local()


def _get_kbuf(shape, dtype):
    """Uninitialized per-thread buffer; the caller writes every element
    (build_K does).  Reused across calls of the same shape."""
    cached = getattr(_kbuf_local, "buf", None)
    if cached is not None and cached.shape == shape and cached.dtype == dtype:
        return cached
    buf = np.empty(shape, dtype)
    _kbuf_local.buf = buf
    return buf


def _get_kf_buf(shape):
    """Per-thread float32 factor workspace of the mixed-precision path (the
    native factor writes every element)."""
    cached = getattr(_kbuf_local, "fbuf", None)
    if cached is not None and cached.shape == shape:
        return cached
    buf = np.empty(shape, np.float32)
    _kbuf_local.fbuf = buf
    return buf


def _bkkt_lib():
    """The native batched symmetric-indefinite solver (Bunch-Kaufman
    dsytrf/dsytrs, native/batch_kkt.cpp) of the port's libqpalm_ldl, or
    None when that library does not build or load (qpalm_tpu/polish.py:
    87-96)."""
    from .linalg.sparse_direct import load_library

    lib = load_library()
    return lib if lib is not None and hasattr(lib, "bkkt_factor_solve") \
        else None


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
                     compress=True, precision="f64"):
    """Polish a (B, ...) chunk (qpalm_tpu/polish.py:298-509).

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

        def build_K(fresh=False):
            # every element of K is written, so the reusable buffer can be
            # handed out uninitialized; `fresh` allocates a new one, for
            # the failed lanes' rebuild after the factor overwrote the
            # shared buffer (the healthy lanes' factors must survive for
            # the refinement's re-solves)
            K = (np.empty((B, nk, nk), Q.dtype) if fresh
                 else _get_kbuf((B, nk, nk), Q.dtype))
            K[:, :n, :n] = Q
            K[:, :n, n:] = Aact.transpose(0, 2, 1)
            K[:, n:, :n] = Aact
            K22 = K[:, n:, n:]
            K22[...] = 0.0
            dix = np.arange(mc)
            K22[:, dix, dix] = np.where(wc, -_DELTA_REG, 1.0)
            return K

        K = build_K()
        rhs = np.concatenate([-q, np.where(wc, bsub, 0.0)], axis=1)
        # the native Bunch-Kaufman path, compress only: compress=False
        # stays the operation-for-operation twin of the full-system polish
        lib = _bkkt_lib() if compress else None
        sol = resolve = None
        if (lib is not None and precision == "mixed"
                and hasattr(lib, "bkkt_factor_solve_f32")):
            # a float32 factor (half the operations and traffic) and float64
            # refinement against the unregularized system: pass
            # refine_steps >= 2.  K survives (the factor lives in the f32
            # workspace), so the lanes it fails solve on K itself; the KKT
            # check gates every lane as at f64
            Kf = _get_kf_buf((B, nk, nk))
            ipiv = np.empty((B, nk), np.int32)
            failv = np.empty(B, np.int32)
            sol_m = rhs.copy()
            nf = lib.bkkt_factor_solve_f32(B, nk, K, Kf, ipiv, sol_m, failv)
            if 0 <= nf < B:
                bad = np.where(failv.astype(bool))[0]
                if len(bad):
                    sol_m[bad] = _np_solve_or_nan(
                        K[bad], rhs[bad, :, None])[:, :, 0]
                sol = sol_m

                def resolve(r):
                    rc = np.ascontiguousarray(r)
                    if lib.bkkt_resolve_f32(B, nk, Kf, ipiv, rc, failv) != 0:
                        return np.zeros_like(rc)
                    if len(bad):
                        rc[bad] = _np_solve_or_nan(
                            K[bad], r[bad, :, None])[:, :, 0]
                    return rc
        if lib is not None and sol is None:
            ipiv = np.empty((B, nk), np.int32)
            failv = np.empty(B, np.int32)
            sol_n = rhs.copy()
            nf = lib.bkkt_factor_solve(B, nk, K, ipiv, sol_n, failv)
            if 0 <= nf < B:
                bad = np.where(failv.astype(bool))[0]
                if len(bad):
                    # the factor overwrote the failed lanes' K: rebuild
                    # those and solve them by LU; the healthy lanes keep
                    # their factors
                    K_bad = build_K(fresh=True)[bad]
                    sol_n[bad] = _np_solve_or_nan(
                        K_bad, rhs[bad, :, None])[:, :, 0]
                sol = sol_n

                def resolve(r):
                    rc = np.ascontiguousarray(r)
                    if lib.bkkt_resolve(B, nk, K, ipiv, rc, failv) != 0:
                        # skip the correction; the KKT check still gates
                        # the result
                        return np.zeros_like(rc)
                    if len(bad):
                        rc[bad] = _np_solve_or_nan(
                            K_bad, r[bad, :, None])[:, :, 0]
                    return rc
            else:
                # a native error (nf < 0) or every lane failed: K was
                # overwritten, rebuild it and take the LU path
                K = build_K()
        if sol is None:
            sol = _np_solve_or_nan(K, rhs[:, :, None])[:, :, 0]

            def resolve(r):
                return _np_solve_or_nan(K, r[:, :, None])[:, :, 0]
        for _ in range(refine_steps):
            sx, sn = sol[:, :n], sol[:, n:]
            top = _mv(Q, sx) + _vm(sn, Aact)
            bot = _mv(Aact, sx) + np.where(wc, 0.0, sn)
            r = rhs - np.concatenate([top, bot], axis=1)
            sol = sol + resolve(r)
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
    precision: str = "f64",
) -> PolishResult:
    """Polish a stacked batch of f32 solutions to (eps_abs, eps_rel) in f64
    on the host (qpalm_tpu/polish.py:512-576, same contract).

    `data` holds the unscaled problem (Q, A, q, bmin, bmax, c), batch
    first, as numpy arrays or CPU tensors; `x`/`y` are the f32 pass's
    solutions.  The batch is cut into `threads` chunks polished in a thread
    pool (LAPACK releases the GIL), each with one BLAS thread.
    `compress=False` solves the full (n+m) KKT system by LU; the default
    solves the compacted active-rows-only system, the same solution in
    exact arithmetic, by the native Bunch-Kaufman factor where the library
    loads.  `precision="mixed"` factors it in float32 and recovers float64
    accuracy by `refine_steps` (>= 2) rounds of float64 refinement; the KKT
    check gates every lane as at "f64"."""
    Q, A, q, bmin, bmax, c = (np.asarray(a, np.float64) for a in (
        data.Q, data.A, data.q, data.bmin, data.bmax, data.c))
    x0 = np.asarray(x, np.float64)
    y0 = np.asarray(y, np.float64)
    B = Q.shape[0]
    nch = max(1, min(threads, B))
    bounds = np.linspace(0, B, nch + 1).astype(int)
    args = [(Q[a:b], A[a:b], q[a:b], bmin[a:b], bmax[a:b], c[a:b],
             x0[a:b], y0[a:b], eps_abs, eps_rel, act_tol, rounds,
             refine_steps, compress, precision)
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
            parts = list(_polish_pool().map(
                lambda t: _np_polish_chunk(*t), args))
    return PolishResult(*(np.concatenate([getattr(p, f) for p in parts])
                          for f in PolishResult._fields))


_pool_holder = []


def _polish_pool():
    """The persistent worker pool: a fresh pool a call costs its start and
    loses the per-thread K buffers (qpalm_tpu/polish.py:582-587)."""
    if not _pool_holder:
        _pool_holder.append(ThreadPoolExecutor(max_workers=8))
    return _pool_holder[0]
