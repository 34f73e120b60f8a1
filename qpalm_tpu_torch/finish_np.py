"""Host float64 finisher: a batched lockstep dense P-ALM loop in numpy
(the port's own copy of qpalm_tpu/finish_np.py:37-290).

Role in the pipeline.  The certified-accuracy path is
  f32 fused pass on the card  ->  f64 active-set polish (one KKT solve and
  a check, polish.py).
A small tail of lanes defeats the polish: their f32 solution sits at the
float32 accuracy floor with a misidentified active set, and the polish's
re-detection oscillates instead of converging.  Those lanes need real f64
P-ALM iterations; this module runs them, warm-started, in plain numpy
(batched `np.matmul` / `np.linalg.solve` over the lanes).

Semantics: the proximal / no-scaling / SCHUR configuration of the solver
(reference src/qpalm.c:484-711, iteration.c:24-229, linesearch.c:14-120),
warm-started, with unscaled termination, the criterion the polish
certifies.  Simplifications, safe for a finisher: no Ruiz scaling (data
arrive unscaled, f64 Newton solves absorb the conditioning), no gamma boost
(plain gamma_upd stepping), no infeasibility certificates (an infeasible
lane simply hits max_iter and reports not ok).  Accuracy is claimed only
by the caller re-running the polish KKT check on the returned iterates,
never by this loop's own status.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import constants as C


class FinishResult(NamedTuple):
    x: np.ndarray  # (B, n)
    y: np.ndarray  # (B, m)
    status: np.ndarray  # (B,) int — QPALM_SOLVED when the loop converged
    iterations: np.ndarray  # (B,)


def _linesearch_bisection_np(eta, beta, delta, alpha, iters=40):
    """Vectorized numpy twin of solver/linesearch.py:linesearch_bisection
    (the exact piecewise-linear derivative root; reference
    linesearch.c:96-117).  Shapes: eta/beta (B,), delta/alpha (B, 2m)."""
    tiny = np.finfo(np.float64).tiny
    dd = delta * delta
    da = delta * alpha

    def ab_at(tau):
        act = (delta * tau[:, None] - alpha) > 0
        a = eta + np.sum(np.where(act, dd, 0.0), axis=1)
        b = beta - np.sum(np.where(act, da, 0.0), axis=1)
        return a, b

    a0, b0 = ab_at(np.full_like(eta, tiny))
    # IEEE overflow/div-by-zero in the -b / max(a, tiny) guards is by
    # design (a == 0 on a dead lane gives +-inf, clamped by the bracket);
    # silence the RuntimeWarnings for the whole bisection
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        s = alpha / delta
        s_valid = np.where(s > 0, s, 0.0)
        s_max = np.max(np.where(np.isfinite(s_valid), s_valid, 0.0), axis=1)
        act_fin = delta > 0
        a_fin = eta + np.sum(np.where(act_fin, dd, 0.0), axis=1)
        b_fin = beta - np.sum(np.where(act_fin, da, 0.0), axis=1)
        tau_fin = -b_fin / np.maximum(a_fin, tiny)
        hi = np.maximum(np.maximum(s_max, tau_fin), 1.0) * 1.01 + 1.0
        lo = np.zeros_like(hi)
        tau = np.minimum(-b0 / np.maximum(a0, tiny), hi)
        tau = np.where(tau > 0, tau, 0.5 * hi)
        for _ in range(iters):
            a, b = ab_at(tau)
            prop = -b / np.maximum(a, tiny)
            mid = 0.5 * (lo + hi)
            prop = np.where((prop > lo) & (prop < hi), prop, mid)
            pa, pb = ab_at(prop)
            pos = pa * prop + pb > 0
            lo = np.where(pos, lo, prop)
            hi = np.where(pos, prop, hi)
            tau = prop
        a, b = ab_at(tau)
        tau_star = -b / np.maximum(a, tiny)
        return np.where(a0 * tiny + b0 > 0, -b0 / a0, tau_star)


def palm_finish_np(
    data,
    x_ws: np.ndarray,
    y_ws: np.ndarray,
    eps_abs: float = 1e-6,
    eps_rel: float = 1e-6,
    max_iter: int = 400,
    inner_max_iter: int = 100,
    rho: float = 0.1,
    theta: float = 0.25,
    delta: float = 100.0,
    sigma_max: float = 1e9,
    sigma_init: float = 2e1,
    gamma_init: float = 1e7,
    gamma_upd: float = 10.0,
    gamma_max: float = 1e7,
    eps_abs_in: float = 1.0,
    eps_rel_in: float = 1.0,
) -> FinishResult:
    """Warm-started lockstep f64 P-ALM over a small stacked batch.

    `data` is a stacked QPData (numpy float64, possibly padded — padded
    rows carry huge bounds and never activate); `x_ws`/`y_ws` (B, n)/(B, m)
    are the seeds (typically the failed polish iterates).  Defaults mirror
    the reference settings (constants.py) for the fields this loop uses.
    """
    Q = np.asarray(data.Q, np.float64)
    A = np.asarray(data.A, np.float64)
    q = np.asarray(data.q, np.float64)
    bmin = np.asarray(data.bmin, np.float64)
    bmax = np.asarray(data.bmax, np.float64)
    B, m, n = A.shape

    x = np.array(x_ws, np.float64)
    y = np.array(y_ws, np.float64)
    # A non-finite warm start poisons the whole lane (the proximal center,
    # sigma heuristic and residuals all inherit the NaN and no number of
    # iterations recovers), while a cold start solves the same instances
    # in milliseconds — measured on the f32-NaN lasso lanes the fused pass
    # hands over.  Zero both vectors of any lane carrying a non-finite
    # entry: cold-starting that lane IS the correct warm start.
    lane_bad = ~(np.isfinite(x).all(axis=1) & np.isfinite(y).all(axis=1))
    if lane_bad.any():
        x[lane_bad] = 0.0
        y[lane_bad] = 0.0
    Qx = np.einsum("bij,bj->bi", Q, x)  # pure Qx (no proximal term)
    Ax = np.einsum("bmn,bn->bm", A, x)
    x0 = x.copy()
    gamma = np.full(B, float(gamma_init))

    # sigma heuristic (reference iteration.c:50-84, as in core.init_state)
    f = 0.5 * np.einsum("bi,bi->b", x, Qx) + np.einsum("bi,bi->b", q, x)
    dist = Ax - np.clip(Ax, bmin, bmax)
    dist2 = np.einsum("bm,bm->b", dist, dist)
    sig0 = np.clip(
        sigma_init * np.maximum(1.0, np.abs(f))
        / np.maximum(1.0, 0.5 * dist2),
        1e-4, 1e4,
    )
    sigma = np.broadcast_to(sig0[:, None], (B, m)).copy()

    eps_a_in = np.full(B, float(eps_abs_in))
    eps_r_in = np.full(B, float(eps_rel_in))
    pri_res_in = np.zeros((B, m))
    act_old = np.zeros((B, m), bool)
    no_change = np.zeros(B, np.int32)
    # previous Newton step's active-set change count: the stall counter
    # reads the PREVIOUS step's enter/leave (qpalm.c:664-665, core.py
    # inner_step), so the current trip's diff only takes effect next trip
    prev_changed = np.ones(B, np.int32)
    iter_out = np.zeros(B, np.int32)
    prev_iter = np.zeros(B, np.int32)
    done = np.zeros(B, bool)
    status = np.full(B, C.QPALM_MAX_ITER_REACHED, np.int32)
    iters = np.zeros(B, np.int32)
    eye = np.eye(n)
    # the reported multiplier is yh at the solved iteration (the solver
    # stores final.yh, solver/core.py:892 / reference qpalm.c:761)
    y_out = y.copy()

    for it in range(max_iter):
        live = ~done
        if not live.any():
            break
        # ---- residuals (iteration.c:24-48) ----
        sinv = 1.0 / sigma
        Axys = Ax + y * sinv
        z = np.clip(Axys, bmin, bmax)
        pri_res = Ax - z
        yh = y + sigma * pri_res
        Atyh = np.einsum("bmn,bm->bn", A, yh)
        df = Qx + q + (x - x0) / gamma[:, None]
        dphi = df + Atyh

        # ---- termination, unscaled (termination.c:44-129) ----
        pri_norm = np.max(np.abs(pri_res), axis=1)
        dua_norm = np.max(np.abs(Qx + q + Atyh), axis=1)
        dua2_norm = np.max(np.abs(dphi), axis=1)
        eps_pri = eps_abs + eps_rel * np.maximum(
            np.max(np.abs(Ax), axis=1), np.max(np.abs(z), axis=1)
        )
        max_norm = np.maximum(
            np.max(np.abs(Qx), axis=1),
            np.maximum(np.max(np.abs(q), axis=1),
                       np.max(np.abs(Atyh), axis=1)),
        )
        eps_dua = eps_abs + eps_rel * max_norm
        eps_dua_in = eps_a_in + eps_r_in * max_norm

        solved = live & (pri_norm < eps_pri) & (dua_norm < eps_dua)
        status[solved] = C.QPALM_SOLVED
        y_out = np.where(solved[:, None], yh, y_out)
        done |= solved
        iters[~done] = it + 1
        live = ~done
        if not live.any():
            break

        subproblem_done = live & (
            (dua2_norm <= eps_dua_in) | (no_change == 3)
        )
        exhausted = live & ~subproblem_done & (
            iters - prev_iter >= inner_max_iter
        )
        outer = subproblem_done | exhausted

        # ---- outer update (qpalm.c:515-660) ----
        if outer.any():
            do_sig = outer & (iter_out > 0) & (pri_norm > eps_pri)
            cond = (do_sig[:, None]
                    & (np.abs(pri_res)
                       > theta * np.abs(pri_res_in))
                    & act_old)
            mult = np.maximum(
                1.0, delta * np.abs(pri_res) / (pri_norm[:, None] + 1e-6)
            )
            sigma = np.where(cond, np.minimum(mult * sigma, sigma_max),
                             sigma)
            dual_upd = subproblem_done  # y <- yh on converged subproblems
            y = np.where(dual_upd[:, None], yh, y)
            eps_a_in = np.where(subproblem_done,
                                np.maximum(eps_abs, rho * eps_a_in),
                                eps_a_in)
            eps_r_in = np.where(subproblem_done,
                                np.maximum(eps_rel, rho * eps_r_in),
                                eps_r_in)
            g_new = np.where(outer & (gamma < gamma_max),
                             np.minimum(gamma * gamma_upd, gamma_max),
                             gamma)
            gamma = g_new
            x0 = np.where(outer[:, None], x, x0)
            pri_res_in = np.where(outer[:, None], pri_res, pri_res_in)
            iter_out = iter_out + outer
            prev_iter = np.where(outer, iters, prev_iter)
            no_change = np.where(outer, 0, no_change)

        # ---- inner Newton step (iteration.c:213-229, newton.c:96-113) ----
        # an outer-update trip takes no Newton step (core.py's lax.switch
        # picks exactly one branch per iteration) — outer lanes sit this
        # one out and re-enter next trip with the refreshed y/x0/sigma.
        # The O(n^3) factor/solve and matvecs run on the INNER lanes only
        # (gather/scatter): done and outer lanes would discard the work
        inner = live & ~outer
        active = (Axys <= bmin) | (Axys >= bmax)
        no_change = np.where(inner,
                             np.where(prev_changed > 0, 0, no_change + 1),
                             no_change)
        changed = (active != act_old).sum(axis=1)
        prev_changed = np.where(inner, changed, prev_changed)
        act_old = np.where(inner[:, None], active, act_old)
        idx = np.where(inner)[0]
        if len(idx) == 0:
            continue
        Qi, Ai, gi = Q[idx], A[idx], gamma[idx]
        sigi, yi, Axi = sigma[idx], y[idx], Ax[idx]
        w = np.where(active[idx], sigi, 0.0)
        Aw = Ai * w[:, :, None]
        M = Qi + np.matmul(Ai.transpose(0, 2, 1), Aw) \
            + (1.0 / gi)[:, None, None] * eye
        d = np.linalg.solve(M, -dphi[idx, :, None])[:, :, 0]
        Qd = np.einsum("bij,bj->bi", Qi, d) + d / gi[:, None]
        Ad = np.einsum("bmn,bn->bm", Ai, d)

        eta = np.einsum("bi,bi->b", d, Qd)
        beta = np.einsum("bi,bi->b", d, df[idx])
        ss = np.sqrt(sigi)
        s_ad = ss * Ad
        bl = np.maximum(bmin[idx], -C.QPALM_INFTY)
        bu = np.minimum(bmax[idx], C.QPALM_INFTY)
        bp_delta = np.concatenate([-s_ad, s_ad], axis=1)
        alpha_lo = (yi + sigi * (Axi - bl)) / ss
        alpha_hi = (-yi + sigi * (bu - Axi)) / ss
        bp_alpha = np.concatenate([alpha_lo, alpha_hi], axis=1)
        tau = _linesearch_bisection_np(eta, beta, bp_delta, bp_alpha)

        x[idx] += tau[:, None] * d
        Qx[idx] += tau[:, None] * (Qd - d / gi[:, None])
        Ax[idx] += tau[:, None] * Ad

    # unconverged lanes report their latest dual estimate
    y_out = np.where((status == C.QPALM_SOLVED)[:, None], y_out, y)
    return FinishResult(x=x, y=y_out, status=status, iterations=iters)
