"""Host-driven P-ALM solver over the native sparse LDL' backend — the
large-sparse *direct* path (the LADEL equivalence class the CG mode cannot
replace on ill-conditioned problems): the port's copy of
qpalm_tpu/host_sparse.py, on the port's types, validation, LOBPCG and
native libraries (linalg/sparse_direct.py, baseline_c.py, built from
native/ by _build.py).  `solve_sparse_auto`'s CG fallback runs the port's
`api.solve` on `device` (default "cuda").

Architecture mirrors the reference's split (reference: src/qpalm.c solve
loop over the src/solver_interface.c backend seam): the iteration logic
runs on the host in numpy/scipy — per-iteration vector work is O(n + m +
nnz) and trivially fast — while every Newton system

    M = Q + A' diag(sigma * active) A  (+ 1/gamma I)

is factored by the native up-looking LDL' (native/sparse_ldl.cpp) with the
symbolic analysis done ONCE on the all-active superset pattern and numeric
refactorization only when the active set / penalties / gamma changed — the
same factor-caching economy as solver/core.py's dense path.

Semantics follow solver/core.py (itself anchored line-by-line to the
reference): residuals iteration.c:24-48, sigma schedule iteration.c:86-145,
gamma boost iteration.c:158-205, exact linesearch linesearch.c:14-120,
termination + infeasibility certificates termination.c:44-240.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp

from . import constants as C
from .types import Settings
from .validate import validate_data, validate_settings


class HostResult(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    status: int
    status_str: str
    iterations: int
    objective: float
    pri_res_norm: float
    dua_res_norm: float
    delta_y: Optional[np.ndarray] = None
    delta_x: Optional[np.ndarray] = None


def _norm_inf(v):
    return float(np.abs(v).max()) if v.size else 0.0


def _linesearch(d, Qd, Ad, df, Ax, y, sigma, sqs, bmin, bmax):
    """Exact linesearch (reference linesearch.c:14-120), numpy sort form."""
    eta = float(d @ Qd)
    beta = float(d @ df)
    s_ad = sqs * Ad
    with np.errstate(divide="ignore", invalid="ignore"):
        delta = np.concatenate([-s_ad, s_ad])
        alpha = np.concatenate([
            (y + sigma * (Ax - bmin)) / sqs,
            (-y + sigma * (bmax - Ax)) / sqs,
        ])
        s = alpha / delta
    l_mask = s > 0
    p_mask = delta > 0
    j_mask = np.logical_xor(p_mask, l_mask)
    a = eta + float((delta[j_mask] ** 2).sum())
    b = beta - float((delta[j_mask] * alpha[j_mask]).sum())
    idx = np.argsort(np.where(l_mask, s, np.inf))
    for i in idx:
        if not l_mask[i]:
            break
        if a * s[i] + b > 0:
            break
        dd = delta[i] * delta[i]
        da = delta[i] * alpha[i]
        if p_mask[i]:
            a += dd
            b -= da
        else:
            a -= dd
            b += da
    return -b / a


def solve_sparse_direct(Q, A, q, bmin, bmax, settings: Optional[Settings]
                        = None, c: float = 0.0, x0=None, y0=None,
                        reuse: Optional[dict] = None,
                        **settings_kw) -> HostResult:
    """Solve one sparse QP on the host with the native LDL' Newton backend.

    Q/A: scipy sparse (any format), q/bmin/bmax: 1-D arrays.  Supports
    proximal, scaling, warm starts and infeasibility certificates like the
    device solver.

    `settings.factorization_method` selects the Newton system form
    (reference newton.c:22-113 / solver_interface.c:20-75):
      - FACTORIZE_SCHUR: factor M = Q + A' Sigma_act A (+ 1/gamma I) —
        right when A'A stays sparse.
      - FACTORIZE_KKT: factor the quasi-definite augmented system
        [[Q + 1/gamma I, A_act'], [A_act, -Sigma_act^{-1}]] (inactive rows
        decoupled to identity, reference qpalm_form_kkt,
        solver_interface.c:119-169) — right when A has dense-ish rows that
        would fill the Schur form; quasi-definiteness makes the no-pivot
        LDL' stable (Vanderbei).
      - FACTORIZE_KKT_OR_SCHUR (default): run the symbolic analysis on
        BOTH superset patterns and keep the one with the lower estimated
        factor FLOPs (~2*lnz^2/size) — the exact-fill analogue of the
        reference's nnz cost model.
    """
    from .linalg.sparse_direct import SparseLDL

    if settings is None:
        settings = Settings(**settings_kw)
    elif settings_kw:
        settings = settings.replace(**settings_kw)
    validate_settings(settings)
    Q = sp.csc_matrix(Q).astype(np.float64)
    A = sp.csc_matrix(A).astype(np.float64)
    q = np.asarray(q, np.float64).ravel().copy()
    bmin = np.asarray(bmin, np.float64).ravel().copy()
    bmax = np.asarray(bmax, np.float64).ravel().copy()
    validate_data(Q, A, q, bmin, bmax)
    # reference semantics: infinite bounds are clamped to +-QPALM_INFTY so
    # breakpoint arithmetic stays finite (constants.h QPALM_INFTY)
    bmin = np.maximum(bmin, -C.QPALM_INFTY)
    bmax = np.minimum(bmax, C.QPALM_INFTY)
    n, m = Q.shape[0], A.shape[0]
    s = settings
    # bound finiteness is classified on the ORIGINAL bounds: after Ruiz
    # scaling a finite E*bmax can exceed QPALM_INFTY and an unscaled
    # threshold would misclassify it (device twin compares against
    # E*QPALM_INFTY, core.py is_primal/dual_infeasible)
    has_lb_rows = bmin > -C.QPALM_INFTY
    has_ub_rows = bmax < C.QPALM_INFTY

    # ---- Ruiz scaling (reference scaling.c:34-113) ------------------------
    D = np.ones(n)
    E = np.ones(m)
    cost = 1.0
    if s.scaling:
        for _ in range(s.scaling if m > 0 else 0):
            absA = abs(A)
            col = np.maximum(absA.max(axis=0).toarray().ravel(), 0.0)
            row = np.maximum(absA.max(axis=1).toarray().ravel(), 0.0)
            Dt = 1.0 / np.sqrt(np.where(col < C.MIN_SCALING, 1.0, col))
            Et = 1.0 / np.sqrt(np.where(row < C.MIN_SCALING, 1.0, row))
            A = sp.diags(Et) @ A @ sp.diags(Dt)
            D *= Dt
            E *= Et
        q = D * q
        cost = 1.0 / max(1.0, _norm_inf(q))
        q = cost * q
        Q = cost * (sp.diags(D) @ Q @ sp.diags(D))
        Q = Q.tocsc()
        A = A.tocsc()
        finite_lo = bmin > -C.QPALM_INFTY
        finite_hi = bmax < C.QPALM_INFTY
        bmin = np.where(finite_lo, E * bmin, bmin)
        bmax = np.where(finite_hi, E * bmax, bmax)
    Dinv = 1.0 / D
    Einv = 1.0 / E
    cinv = 1.0 / cost

    # ---- nonconvex gamma pinning (reference nonconvex.c:171-183, run on
    # the SCALED Q like qpalm_setup -> set_settings_nonconvex,
    # qpalm.c:294-296).  lambda_min comes from the matrix-free LOBPCG with
    # the reference's safe lower bound, so Q + (1/gamma) I stays strictly
    # PD and the no-pivot LDL' (Schur PD-ness / KKT quasi-definiteness)
    # remains valid
    nonconvex = bool(s.nonconvex)
    gamma_pinned = False
    gamma_max_eff = float(s.gamma_max)
    if nonconvex:
        from .solver.nonconvex import lobpcg_min_eig_np

        if reuse is not None and "nc_lam_costfree" in reuse:
            # parametric re-solves keep Q and the Ruiz D (Ruiz runs on A
            # only), but the cost scaling tracks q — cache the bound for
            # D Q D and rescale (qpalm_update_q/bounds never re-run
            # set_settings_nonconvex either, solver pins once)
            lam = reuse["nc_lam_costfree"] * cost
        else:
            lam = lobpcg_min_eig_np(lambda v: Q @ v, n)
            if reuse is not None:
                reuse["nc_lam_costfree"] = lam * cinv
        if lam < 0:
            s = s.replace(proximal=True)
            gamma_pinned = True
            gamma_max_eff = 1.0 / abs(lam)
        else:
            nonconvex = False
            s = s.replace(nonconvex=False)

    # ---- symbolic analysis on the all-active superset pattern -------------
    # (cached across parametric re-solves via `reuse`: q/bound updates keep
    # the pattern, so the etree/supernode/ordering work — the expensive
    # setup half — is done once, like the reference's persistent
    # work->solver->sym across qpalm_update_* calls)
    At = A.T.tocsc()
    fm = fm_req = s.factorization_method
    if reuse is not None and reuse.get("fm") == fm_req:
        ldl = reuse["ldl"]
        ldl_kkt = reuse["ldl_kkt"]
    else:
        ldl = ldl_kkt = None
        if fm == C.FACTORIZE_KKT_OR_SCHUR and m > 0:
            # don't even BUILD the Schur candidate when a handful of
            # dense-ish rows make A'A near-dense (sum of squared row
            # counts bounds its pattern): forming + analyzing a 25M-nnz
            # pattern just to reject it dominated setup profiles
            row_nnz = np.diff(A.tocsr().indptr).astype(np.int64)
            est_schur_nnz = Q.nnz + int((row_nnz ** 2).sum())
            kkt_nnz = Q.nnz + 2 * A.nnz + n + m
            if est_schur_nnz > 20 * kkt_nnz:
                fm = C.FACTORIZE_KKT
        # analysis patterns are built cancellation-free (abs values):
        # scipy's sparse `+`/`@` drop exactly-cancelling entries, and a
        # dropped structural nonzero makes a later factor() raise
        # "pattern not contained in analyzed pattern" mid-solve on
        # integer-structured problems
        if fm != C.FACTORIZE_KKT:  # Schur covers every non-KKT mode here
            absA = abs(A)
            pattern = (abs(Q) + (absA.T @ absA) + sp.eye(n)).tocsc()
            ldl = SparseLDL(pattern)
        if fm in (C.FACTORIZE_KKT, C.FACTORIZE_KKT_OR_SCHUR):
            kkt_pattern = sp.bmat(
                [[abs(Q) + sp.eye(n), abs(At)], [abs(A), sp.eye(m)]],
                format="csc",
            )
            ldl_kkt = SparseLDL(kkt_pattern)
        if fm == C.FACTORIZE_KKT_OR_SCHUR:
            # keep the cheaper factor: estimated FLOPs ~ 2*lnz^2/size (the
            # exact-fill analogue of the reference's nnz rule,
            # solver_interface.c:20-75)
            schur_flops = 2.0 * ldl.lnz ** 2 / max(n, 1)
            kkt_flops = 2.0 * ldl_kkt.lnz ** 2 / max(n + m, 1)
            if kkt_flops < schur_flops:
                ldl = None
            else:
                ldl_kkt = None
        if reuse is not None:
            reuse.update(fm=fm_req, ldl=ldl, ldl_kkt=ldl_kkt)
    use_kkt = ldl_kkt is not None
    kkt_tmpl = reuse.get("kkt_tmpl") if reuse is not None else None
    if use_kkt:
        # loop-invariant half of the Gershgorin-style bound on
        # ||A' Sigma_act A||: ||A'||_inf (A is fixed after scaling)
        absA_kkt = abs(A)
        gersh_r1 = float(absA_kkt.sum(axis=0).max()) if A.nnz else 0.0

    # ---- warm start / state (qpalm.c:322-399) -----------------------------
    gamma = gamma_max_eff if gamma_pinned else float(s.gamma_init)
    eps_k_abs, eps_k_rel = float(s.eps_abs_in), float(s.eps_rel_in)
    if x0 is not None:
        x = np.asarray(x0, np.float64).ravel() * Dinv
    else:
        x = np.zeros(n)
    y = (np.asarray(y0, np.float64).ravel() * Einv * cost
         if y0 is not None else np.zeros(m))
    Qx = Q @ x + (x / gamma if s.proximal else 0.0)
    Ax = A @ x
    xprev_center = x.copy()  # x0 proximal center
    f = 0.5 * float(x @ Qx) + float(q @ x)
    dist = Ax - np.clip(Ax, bmin, bmax)
    sig0 = np.clip(
        s.sigma_init * max(1.0, abs(f)) / max(1.0, 0.5 * float(dist @ dist)),
        1e-4, 1e4,
    )
    sigma = np.full(m, sig0)
    eps_abs_in, eps_rel_in = s.eps_abs_in, s.eps_rel_in
    pri_res_in = np.zeros(m)
    active = np.zeros(m, bool)
    active_old = np.zeros(m, bool)
    factor_valid = False
    gamma_shrunk = False
    gamma_maxed = gamma_pinned  # pinned gamma never boosts (device twin:
    # core.init_state gamma_maxed = nonconvex)
    gersh = 0.0
    nb_enter = nb_leave = 0
    no_change = 0
    it_out = prev_it = 0
    best_pri_outer = np.inf
    stall_outer = 0
    act_stable_outer = 0
    active_prev_outer = np.zeros(m, bool)
    x_prev = x.copy()
    tQd = np.zeros(n)
    tAd = np.zeros(m)
    td = np.zeros(n)
    tau = 0.0
    status = C.QPALM_MAX_ITER_REACHED
    delta_y_cert = delta_x_cert = None
    pri_norm = dua_norm = np.inf

    import time as _time

    if s.verbose:
        # banner + header (reference util.c:107-119, device twin api.py)
        print(f"qpalm_tpu sparse-direct  (n = {n}, m = {m}, "
              f"{'KKT' if use_kkt else 'Schur'} form)")
        print("  iter |   pri res    |   dua res    |     tau")
    t_solve0 = _time.perf_counter()
    it = 0
    for it in range(s.max_iter):
        # wall-clock limit (reference qpalm.c:680-708 time_limit): the
        # host loop checks the clock between iterations, like the device
        # path's host-chunked enforcement
        if (s.time_limit < C.QPALM_INFTY
                and _time.perf_counter() - t_solve0 > s.time_limit):
            status = C.QPALM_TIME_LIMIT_REACHED
            break
        # ---- residuals (iteration.c:24-48) ----
        Axys = Ax + y / sigma
        z = np.clip(Axys, bmin, bmax)
        pri_res = Ax - z
        yh = y + sigma * pri_res
        # strictly-inside rows have yh = y + sigma*(-y/sigma) = 0 in exact
        # arithmetic, but once the terminal boost pushes sigma past the
        # reference cap, y/sigma underflows below Ax's ulp and the
        # cancellation never happens — a stale multiplier (~1e-4) then
        # survives on a slack row and breaks the complementarity
        # certificate.  Zero those rows explicitly (exact-equivalent;
        # gated on sigma > 1e10 so reference-range paths stay bit-exact
        # with the device twin).
        if m and sigma.max() > 1e10:
            yh = np.where(
                (Axys > bmin) & (Axys < bmax) & (sigma > 1e10), 0.0, yh)
        df = Qx + q - (xprev_center / gamma if s.proximal else 0.0)
        Atyh = At @ yh
        dphi = df + Atyh

        # ---- termination (termination.c:44-129) ----
        pri_norm = _norm_inf(Einv * pri_res)
        dd = dphi - ((x - xprev_center) / gamma if s.proximal else 0.0)
        dua_norm = _norm_inf(Dinv * dd) * cinv
        dua2_norm = _norm_inf(Dinv * dphi) * cinv
        eps_pri = s.eps_abs + s.eps_rel * max(
            _norm_inf(Einv * Ax), _norm_inf(Einv * z)
        )
        max_norm = max(
            _norm_inf(Dinv * Qx), _norm_inf(Dinv * q),
            _norm_inf(Dinv * Atyh),
        ) * cinv
        eps_dua = s.eps_abs + s.eps_rel * max_norm
        eps_dua_in = eps_abs_in + eps_rel_in * max_norm

        if s.verbose:
            print(f"{it:6d} | {pri_norm:.6e} | {dua_norm:.6e} | "
                  f"{tau:8.4f}"
                  + (f" | out {it_out} sig [{sigma.min():.1e},"
                     f"{sigma.max():.1e}] act {int(active.sum())} "
                     f"+{nb_enter}/-{nb_leave} gam {gamma:.1e}"
                     if os.environ.get("QPALM_DEBUG_SCHED") else ""))
        if pri_norm < eps_pri and dua_norm < eps_dua:
            status = C.QPALM_SOLVED
            y = yh
            break

        # ---- infeasibility certificates (termination.c:136-240) ----
        dy = yh - y
        eps_p = s.eps_prim_inf * _norm_inf(E * dy)
        if eps_p > 0:
            At_dy = Dinv * (At @ dy)
            has_ub = has_ub_rows
            has_lb = has_lb_rows
            oob = float(
                np.sum(np.where(has_ub, bmax * np.maximum(dy, 0.0), 0.0))
                + np.sum(np.where(has_lb, bmin * np.minimum(dy, 0.0), 0.0))
            )
            if _norm_inf(At_dy) <= eps_p and oob <= -eps_p:
                status = C.QPALM_PRIMAL_INFEASIBLE
                delta_y_cert = E * (cinv * dy)
                break
        dx = x - x_prev
        eps_d = s.eps_dual_inf * _norm_inf(D * dx)
        if eps_d > 0:
            A_dx = Einv * tAd
            has_ub = has_ub_rows
            has_lb = has_lb_rows
            viol = np.any((has_ub & (A_dx >= eps_d))
                          | (has_lb & (A_dx <= -eps_d)))
            # tQd_pure = tau*Q@d captured at the step with the step's
            # gamma (device twin: core.py is_dual_infeasible; the pure
            # form is immune to later gamma updates)
            dxQdx = float(dx @ tQd_pure)
            dxdx = float((D * dx) @ (D * dx))
            e2 = s.eps_dual_inf * s.eps_dual_inf
            cs = cost if s.scaling else 1.0
            curv = dxQdx <= -cs * e2 * dxdx or (
                dxQdx <= cs * e2 * dxdx and float(q @ dx) <= -cs * eps_d
            )
            if (not viol) and curv:
                status = C.QPALM_DUAL_INFEASIBLE
                delta_x_cert = D * dx
                break

        subproblem_done = dua2_norm <= eps_dua_in
        outer_trigger = subproblem_done or no_change == 3
        exhausted = it == prev_it + s.inner_max_iter

        if outer_trigger or exhausted:
            # ---- outer update (qpalm.c:515-660) ----
            no_change = 0
            if it_out > 0 and pri_norm > eps_pri:
                pn = _norm_inf(pri_res)
                cond = (np.abs(pri_res) > s.theta * np.abs(pri_res_in)) \
                    & active
                mult = np.maximum(
                    1.0, s.delta * np.abs(pri_res) / (pn + 1e-6)
                )
                new_sig = np.where(
                    cond, np.minimum(mult * sigma, s.sigma_max), sigma
                )
                if np.any(new_sig != sigma):
                    sigma = new_sig
                    factor_valid = False
            # ---- stagnation rescue (beyond-reference; see POWELL20 note
            # in RESULTS_maros.md).  The reference boosts sigma only on
            # rows that are ACTIVE and not shrinking (iteration.c:86-145),
            # proportionally to their share of the max residual — on
            # degenerate chains whose active set grows one row per outer
            # iteration (POWELL20's cyclic differences), sigma crawls and
            # the dual ascent stalls for thousands of iterations.  When the
            # primal residual fails to halve across 5 consecutive outer
            # updates, escalate sigma globally by delta: the dual step size
            # grows exponentially under stall instead of linearly.
            if it_out > 0:
                if pri_norm < 0.5 * best_pri_outer:
                    stall_outer = 0
                else:
                    stall_outer += 1
                best_pri_outer = min(best_pri_outer, pri_norm)
                if stall_outer >= 5 and pri_norm > eps_pri:
                    sigma = np.minimum(sigma * s.delta, s.sigma_max)
                    factor_valid = False
                    stall_outer = 0
                    best_pri_outer = pri_norm
            # ---- terminal sigma boost (beyond-reference; KKT mode only).
            # On degenerate active sets (CVXQP1_L) sigma saturates at
            # sigma_max while the active set is settled, and pri_res then
            # decays geometrically at 1/(1+sigma*lambda) for hundreds of
            # iterations.  The quasi-definite KKT factorization is stable
            # in the near-equality limit (its (2,2) pivots are dominated
            # by the Schur term, not -1/sigma), so once (a) the subproblem
            # is converged, (b) the active set is unchanged across 3
            # consecutive outer updates, and (c) every active row's sigma
            # sits at sigma_max, the active rows jump to sigma = 1e13 —
            # the remaining primal error collapses in 1-2 outer updates
            # instead of hundreds.  The Schur form is excluded: at 1e13
            # its condition number breaks f64.
            if use_kkt and outer_trigger and it_out > 1:
                if np.array_equal(active, active_prev_outer):
                    act_stable_outer += 1
                else:
                    act_stable_outer = 0
                active_prev_outer = active.copy()
                if (act_stable_outer >= 3 and pri_norm > eps_pri
                        and active.any()
                        and sigma[active].min() >= s.sigma_max * 0.999
                        and sigma.max() < 1e13):
                    sigma = np.where(active, 1e13, sigma)
                    factor_valid = False
            if outer_trigger:
                y = yh
                eps_abs_in = max(s.eps_abs, s.rho * eps_abs_in)
                eps_rel_in = max(s.eps_rel, s.rho * eps_rel_in)
            if nonconvex:
                # gamma stays pinned at 1/|lambda_min| (no boost/step);
                # the proximal center moves only when the primal residual
                # has caught up to the eps_k ladder (qpalm.c:586-609;
                # device twin: core.py outer_update nonconvex branch)
                if outer_trigger:
                    eps_k = eps_k_abs + eps_k_rel * max(
                        _norm_inf(Einv * Ax), _norm_inf(Einv * z)
                    )
                    if pri_norm < eps_k:
                        xprev_center = x.copy()
                        eps_k_abs = max(s.eps_abs, s.rho * eps_k_abs)
                        eps_k_rel = max(s.eps_rel, s.rho * eps_k_rel)
            elif s.proximal:
                check = (outer_trigger and not gamma_maxed and it_out > 0
                         and nb_enter == 0 and nb_leave == 0
                         and pri_norm < eps_pri)
                stepped = (min(gamma * s.gamma_upd, gamma_max_eff)
                           if gamma < gamma_max_eff else gamma)
                new_gamma = gamma
                if check:
                    Axys2 = Ax + y / sigma
                    act2 = (Axys2 <= bmin) | (Axys2 >= bmax)
                    nb_e2 = int(np.sum(act2 & ~active_old))
                    nb_l2 = int(np.sum(~act2 & active_old))
                    # the boost check overwrites active and the counts
                    # (qpalm.c:617-618 side effect) but NOT active_old —
                    # that baseline is copied only at the end of a Newton
                    # step (newton.c:116; device twin: core.py)
                    active = act2
                    nb_enter, nb_leave = nb_e2, nb_l2
                    if nb_e2 == 0 and nb_l2 == 0:
                        nact = int(act2.sum())
                        new_gamma = (max(s.gamma_max,
                                         1e14 / max(gersh, 1e-30))
                                     if nact > 0 else 1e12)
                        if nact > 0:
                            gamma_maxed = True
                    else:
                        new_gamma = stepped
                else:
                    new_gamma = stepped
                if new_gamma != gamma:
                    Qx = Qx + (1.0 / new_gamma - 1.0 / gamma) * x
                    gamma = new_gamma
                    factor_valid = False
                xprev_center = x.copy()
            pri_res_in = pri_res.copy()
            it_out += 1
            prev_it = it
        else:
            # ---- inner semismooth-Newton step (qpalm.c:662-678) ----
            # the stall counter reads the PREVIOUS Newton step's
            # enter/leave counts (qpalm.c:664-665; device twin:
            # core.py inner_step) — update it from the carried counts
            # before computing this trip's active-set diff
            no_change = 0 if nb_enter + nb_leave > 0 else no_change + 1
            act = (Axys <= bmin) | (Axys >= bmax)
            nb_enter = int(np.sum(act & ~active_old))
            nb_leave = int(np.sum(~act & active_old))
            changed = bool(np.any(act != active))
            active = act
            active_old = act.copy()
            if changed or not factor_valid:
                if use_kkt:
                    # quasi-definite augmented form (qpalm_form_kkt,
                    # solver_interface.c:119-169): active rows carry
                    # -1/sigma on the diagonal, inactive rows decouple to
                    # the identity with their A-column zeroed.  The KKT
                    # matrix is assembled ONCE with an index tracer; every
                    # refactor after that is two numpy fancy-index ops
                    # (scipy bmat/adds per iteration dominated profiles),
                    # and the (1,1)-block 1/gamma shift rides the native
                    # partial diagonal shift (LADEL diag_size semantics)
                    act_mask = active.astype(np.float64)
                    dblock_vals = np.where(active, -1.0 / sigma, 1.0)
                    if kkt_tmpl is None:
                        nQ, nA = Q.nnz, A.nnz
                        Q_tr = Q.copy()
                        Q_tr.data = np.arange(1, nQ + 1, dtype=np.float64)
                        A_tr = A.copy()
                        A_tr.data = np.arange(nQ + 1, nQ + nA + 1,
                                              dtype=np.float64)
                        D_tr = sp.diags(np.arange(
                            nQ + nA + 1, nQ + nA + m + 1,
                            dtype=np.float64))
                        K_tr = sp.bmat([[Q_tr, A_tr.T], [A_tr, D_tr]],
                                       format="csc")
                        K_tr.sort_indices()
                        kkt_tmpl = (K_tr,
                                    K_tr.data.astype(np.int64) - 1)
                        if reuse is not None:
                            reuse["kkt_tmpl"] = kkt_tmpl
                    Kmat, kkt_idx = kkt_tmpl
                    src_vals = np.concatenate(
                        [Q.data, A.data * act_mask[A.indices],
                         dblock_vals])
                    Kmat.data[:] = src_vals[kkt_idx]
                    while True:
                        try:
                            ldl_kkt.factor(
                                Kmat,
                                shift=(1.0 / gamma if s.proximal else 0.0),
                                shift_size=n,
                            )
                            break
                        except np.linalg.LinAlgError:
                            # LDL' diagonal safeguard: the pinned gamma
                            # should keep Q + (1/gamma) I PD (LOBPCG safe
                            # bound), but rounding on hard spectra can
                            # still zero a pivot — harden the pin and
                            # retry (the reference aborts here;
                            # nonconvex.c's bound makes it unreachable)
                            if not (nonconvex and gamma > 1e-12):
                                raise
                            Qx += (10.0 / gamma - 1.0 / gamma) * x
                            gamma *= 0.1
                            gamma_max_eff = gamma
                            gamma_shrunk = True
                    # Gershgorin-style upper bound on ||A' Sigma_act A||:
                    # ||A'||_inf * ||Sigma_act A||_inf (the exact row-sum
                    # bound needs A'A, which KKT mode exists to avoid; a
                    # larger bound only picks a smaller terminal gamma)
                    r2 = (sp.diags(np.where(active, sigma, 0.0))
                          @ absA_kkt).sum(axis=1).max() if A.nnz else 0.0
                    gersh = gersh_r1 * float(r2)
                else:
                    w = np.where(active, sigma, 0.0)
                    Aw = A.copy()
                    Aw.data = A.data * w[A.indices]  # pattern-stable mask
                    AtsA = (A.T @ Aw).tocsc()
                    M = (Q + AtsA).tocsc()
                    # Gershgorin bound of AtsA (nonconvex.c:185-210)
                    gersh = float(np.abs(AtsA).sum(axis=1).max()) \
                        if AtsA.nnz else 0.0
                    while True:
                        try:
                            ldl.factor(M, shift=(1.0 / gamma if s.proximal
                                                 else 0.0))
                            break
                        except np.linalg.LinAlgError:
                            # LDL' diagonal safeguard (see the KKT twin)
                            if not (nonconvex and gamma > 1e-12):
                                raise
                            Qx += (10.0 / gamma - 1.0 / gamma) * x
                            gamma *= 0.1
                            gamma_max_eff = gamma
                            gamma_shrunk = True
                factor_valid = True
            if gamma_shrunk:
                # the residual/rhs quantities were computed with the old
                # gamma — recompute the Newton gradient so the direction
                # matches the hardened matrix
                gamma_shrunk = False
                df = Qx + q - xprev_center / gamma
                dphi = df + Atyh
            if use_kkt:
                rhs = np.concatenate([-dphi, np.zeros(m)])
                sol = ldl_kkt.solve(rhs)
                ginv = 1.0 / gamma if s.proximal else 0.0
                for _ in range(min(int(s.max_refine), 3)):
                    # refinement against the KKT operator (newton.c:57-92),
                    # applied matrix-free: Aact @ v = mask*(A@v) and
                    # Aact' @ w = A'(mask*w)
                    r = rhs.copy()
                    sx, sn = sol[:n], sol[n:]
                    r[:n] -= (Q @ sx + ginv * sx
                              + At @ (act_mask * sn))
                    r[n:] -= act_mask * (A @ sx) + dblock_vals * sn
                    if _norm_inf(r) <= 1e-12 * max(1.0, _norm_inf(rhs)):
                        break
                    sol = sol + ldl_kkt.solve(r)
                d = sol[:n]
            else:
                d = ldl.solve(-dphi)
            Qd = Q @ d + (d / gamma if s.proximal else 0.0)
            Ad = A @ d
            tau = _linesearch(d, Qd, Ad, df, Ax, y, sigma,
                              np.sqrt(sigma), bmin, bmax)
            x_prev = x.copy()
            td = tau * d
            tQd = tau * Qd
            tQd_pure = tQd - td / gamma if s.proximal else tQd
            tAd = tau * Ad
            x = x + td
            Qx = Qx + tQd
            Ax = Ax + tAd
    else:
        it = s.max_iter

    Qx_pure = Qx - (x / gamma if s.proximal else 0.0)
    obj = float((0.5 * Qx_pure + q) @ x) * cinv + c
    if s.verbose:
        # final boxed message (reference util.c:121-206)
        print("-" * 54)
        print(f"status:     {C.STATUS_STRINGS.get(int(status), '?')}")
        print(f"iterations: {it}")
        print(f"objective:  {obj:.6e}")
        print(f"pri res:    {pri_norm:.4e}   dua res: {dua_norm:.4e}")
        print(f"solve time: {_time.perf_counter() - t_solve0:.6f} s")
        print("-" * 54)
    return HostResult(
        x=D * x,
        y=E * (cinv * y),
        status=int(status),
        status_str=C.STATUS_STRINGS.get(int(status), "?"),
        iterations=int(it),
        objective=obj,
        pri_res_norm=pri_norm,
        dua_res_norm=dua_norm,
        delta_y=delta_y_cert,
        delta_x=delta_x_cert,
    )


class SparseQPALM:
    """Stateful sparse-direct solver: the reference qpalm_setup /
    qpalm_warm_start / qpalm_update_* / qpalm_solve lifecycle
    (include/qpalm.h:43-138) on the host sparse path.

    The symbolic analysis (etree, supernode partition, fill-reducing
    ordering, KKT-vs-Schur choice) is done once at construction and
    reused across `update_q`/`update_bounds` re-solves — q and bound
    updates keep the sparsity pattern, exactly the economy the reference
    gets from its persistent symbolic factorization across
    qpalm_update_* calls (solver_interface.c:319-405)."""

    def __init__(self, Q, A, q, bmin, bmax,
                 settings: Optional[Settings] = None, c: float = 0.0,
                 **settings_kw):
        if settings is None:
            settings = Settings(**settings_kw)
        elif settings_kw:
            settings = settings.replace(**settings_kw)
        self.settings = settings
        self.Q = sp.csc_matrix(Q)
        self.A = sp.csc_matrix(A)
        self.q = np.asarray(q, np.float64).ravel().copy()
        self.bmin = np.asarray(bmin, np.float64).ravel().copy()
        self.bmax = np.asarray(bmax, np.float64).ravel().copy()
        self.c = float(c)
        self._reuse: dict = {}
        self._x0 = self._y0 = None

    def warm_start(self, x0=None, y0=None) -> None:
        self._x0 = None if x0 is None else np.asarray(x0, np.float64)
        self._y0 = None if y0 is None else np.asarray(y0, np.float64)

    def update_q(self, q) -> None:
        self.q = np.asarray(q, np.float64).ravel().copy()

    def update_bounds(self, bmin=None, bmax=None) -> None:
        if bmin is not None:
            self.bmin = np.asarray(bmin, np.float64).ravel().copy()
        if bmax is not None:
            self.bmax = np.asarray(bmax, np.float64).ravel().copy()

    def update_settings(self, **kw) -> None:
        self.settings = self.settings.replace(**kw)

    def solve(self) -> HostResult:
        r = solve_sparse_direct(
            self.Q, self.A, self.q, self.bmin, self.bmax, self.settings,
            c=self.c, x0=self._x0, y0=self._y0, reuse=self._reuse,
        )
        # successive solves warm-start from the last iterate, like the
        # reference python binding's stateful usage
        self._x0, self._y0 = r.x, r.y
        return r


def solve_sparse_batch(problems, settings: Optional[Settings] = None,
                       threads: int = 1, **settings_kw):
    """Solve a list of sparse QPs `(Q, A, q, bmin, bmax)` on the host.

    Problems sharing a sparsity pattern reuse one symbolic analysis
    (etree/supernodes/ordering) — the main batch economy.  `threads > 1`
    fans the problems over host threads, but measured on this class it
    is counterproductive (the per-iteration scipy assembly work holds
    the GIL and the native factor kernels contend for the same cores:
    4 threads ran 0.9-2.6x SLOWER than sequential on both supernodal and
    banded workloads), so the default is sequential; the option remains
    for hosts with many idle cores.  Handles are mutable per-solve and
    never shared across threads.  Returns HostResults in input order —
    the sparse host counterpart of `batch.solve_batch` for problems too
    large to stack densely on device.
    """
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    if settings is None:
        settings = Settings(**settings_kw)
    elif settings_kw:
        settings = settings.replace(**settings_kw)

    def pattern_key(Q, A):
        h = hashlib.sha1()
        for M in (sp.csc_matrix(Q), sp.csc_matrix(A)):
            h.update(repr(M.shape).encode())
            h.update(np.ascontiguousarray(M.indptr).tobytes())
            h.update(np.ascontiguousarray(M.indices).tobytes())
        return h.hexdigest()

    def worker(chunk):
        cache: dict = {}
        out = []
        for idx, (Q, A, q, bl, bu) in chunk:
            reuse = cache.setdefault(pattern_key(Q, A), {})
            out.append((idx, solve_sparse_direct(
                Q, A, q, bl, bu, settings, reuse=reuse)))
        return out

    nw = max(1, min(threads, len(problems)))
    chunks = [[] for _ in range(nw)]
    for i, p in enumerate(problems):
        chunks[i % nw].append((i, p))
    results: list = [None] * len(problems)
    if nw == 1:
        parts = [worker(chunks[0])]
    else:
        with ThreadPoolExecutor(nw) as ex:
            parts = list(ex.map(worker, chunks))
    for part in parts:
        for i, r in part:
            results[i] = r
    return results


def _native_engine_ok(s: Settings) -> bool:
    """True when every knob the native C engine hard-codes is at its
    reference default, so routing to it cannot change semantics.  The C
    engine receives eps_abs/eps_rel/max_iter/scaling/delta/time_limit and
    implements the framework stagnation rescue; everything else must match
    the reference defaults compiled into it."""
    from . import constants as C2
    d = Settings()
    fixed = ("eps_abs_in", "eps_rel_in", "rho", "theta", "sigma_max",
             "sigma_init", "proximal", "gamma_init", "gamma_upd",
             "gamma_max", "nonconvex", "inner_max_iter", "eps_prim_inf",
             "eps_dual_inf", "enable_dual_termination", "dtype")
    if any(getattr(s, f) != getattr(d, f) for f in fixed):
        return False
    if s.verbose:
        return False  # the C loop has no iteration printer
    return s.factorization_method in (C2.FACTORIZE_SCHUR,
                                      C2.FACTORIZE_KKT_OR_SCHUR)


def _solve_native_engine(Qc, Ac, q, bmin, bmax, s: Settings,
                         c: float) -> Optional[HostResult]:
    """Run the native C sparse engine (framework mode: rescue on) and wrap
    its result as a HostResult.  Returns None when the library is absent
    or the engine reports an internal error (callers fall through to the
    Python path)."""
    from . import baseline_c
    from . import constants as C2

    lib = baseline_c.load_library()
    if lib is None or not hasattr(lib, "qpalm_sparse_baseline_solve"):
        return None
    tl = s.time_limit if s.time_limit < C.QPALM_INFTY else 0.0
    try:
        r = baseline_c.solve_sparse(
            Qc, Ac, np.asarray(q, np.float64),
            np.asarray(bmin, np.float64), np.asarray(bmax, np.float64),
            eps_abs=s.eps_abs, eps_rel=s.eps_rel, max_iter=s.max_iter,
            scaling=s.scaling, delta=s.delta, rescue=True, time_limit=tl)
    except Exception:
        return None
    if r["status"] == 0:
        return None  # internal error: fall through to the Python path
    x, y = r["x"], r["y"]
    Ax = Ac @ x
    z = np.clip(Ax, np.maximum(bmin, -C.QPALM_INFTY),
                np.minimum(bmax, C.QPALM_INFTY))
    pri = _norm_inf(Ax - z) if Ax.size else 0.0
    dua = _norm_inf(Qc @ x + np.asarray(q) + Ac.T @ y)
    return HostResult(
        x=x, y=y, status=int(r["status"]),
        status_str=C2.STATUS_STRINGS.get(int(r["status"]), "unknown"),
        iterations=int(r["iter"]), objective=float(r["objective"]) + c,
        pri_res_norm=pri, dua_res_norm=dua,
        delta_y=r.get("delta_y"), delta_x=r.get("delta_x"),
    )


def solve_sparse_auto(Q, A, q, bmin, bmax, settings: Optional[Settings]
                      = None, c: float = 0.0, x0=None, y0=None,
                      fill_ratio: float = 30.0,
                      direct_flop_budget: float = 2e10, device="cuda",
                      **settings_kw):
    """Large-sparse front door: pick the direct LDL' path or the
    matrix-free CG path by *estimated factor cost* — the sparse analogue
    of the reference's KKT-vs-Schur nnz selector
    (reference: solver_interface.c:20-75, threshold philosophy:
    `qpalm_set_factorization_method`).

    The symbolic analysis is O(nnz) and gives the exact LDL' fill for the
    all-active superset pattern.  Two direct routes exist: the scalar
    up-looking backend for low-fill structured/banded patterns
    (`lnz <= fill_ratio * nnz`), and the supernodal BLAS-panel backend,
    which keeps heavy-fill factorizations viable until the estimated
    factor FLOPs (~2*lnz^2/n) exceed `direct_flop_budget` (~1 s of dgemm
    at the default).  Only patterns beyond both route to Jacobi /
    block-Jacobi PCG, which runs on `device` (the port's api.solve).

    `solve_sparse_auto.route` names the route the last call took:
    "native" (the C engine), "direct" (solve_sparse_direct) or "cg".
    """
    from . import constants as C2
    from .linalg.sparse_direct import estimate_fill, load_library

    if settings is None:
        settings = Settings(**settings_kw)
    elif settings_kw:
        settings = settings.replace(**settings_kw)
    Qc = sp.csc_matrix(Q)
    Ac = sp.csc_matrix(A)
    n = Qc.shape[0]
    use_direct = False
    if load_library() is not None:
        # dense-ish rows make A'A near-dense: estimating the Schur fill
        # would itself build a huge pattern just to route, and the direct
        # solver's own pre-check picks the sparse KKT form anyway
        if Ac.shape[0] > 0:
            row_nnz = np.diff(Ac.tocsr().indptr).astype(np.int64)
            est_schur_nnz = Qc.nnz + int((row_nnz ** 2).sum())
            kkt_nnz = Qc.nnz + 2 * Ac.nnz + n + Ac.shape[0]
            if est_schur_nnz > 20 * kkt_nnz:
                solve_sparse_auto.route = "direct"
                return solve_sparse_direct(Qc, Ac, q, bmin, bmax,
                                           settings, c=c, x0=x0, y0=y0)
        pattern = (Qc + (Ac.T @ Ac) + sp.eye(n)).tocsc()
        try:
            # ordering + exact etree count only — no factor allocation;
            # solve_sparse_direct redoes its own full symbolic once
            lnz = estimate_fill(pattern)
            est_flops = 2.0 * lnz * lnz / max(n, 1)
            mean_cols = lnz / max(n, 1)
            supernodal = mean_cols >= 24.0
            use_direct = (lnz <= fill_ratio * pattern.nnz
                          or (supernodal
                              and est_flops <= direct_flop_budget))
        except Exception:
            use_direct = False
            supernodal = False
        # Native C engine fast path: for light-fill patterns (scalar LDL
        # territory) the per-iteration cost is dominated by the Python
        # loop, not the factorization — the C twin of this solver
        # (native/qpalm_sparse_baseline.cpp, rescue=True) runs the same
        # schedule ~10-20x faster (POWELL20 n=1000: 24 ms vs 520 ms;
        # iteration-parity asserted in tests/test_sparse_baseline.py).
        # Only taken when every Settings knob the C engine hard-codes is
        # at its reference default and no warm start is requested.
        if (use_direct and not supernodal and x0 is None and y0 is None
                and _native_engine_ok(settings)):
            r = _solve_native_engine(Qc, Ac, q, bmin, bmax, settings, c)
            if r is not None:
                solve_sparse_auto.route = "native"
                return r
    if use_direct:
        solve_sparse_auto.route = "direct"
        return solve_sparse_direct(Qc, Ac, q, bmin, bmax, settings, c=c,
                                   x0=x0, y0=y0)
    from .api import solve as device_solve

    solve_sparse_auto.route = "cg"
    r = device_solve(Qc, Ac, np.asarray(q), np.asarray(bmin),
                     np.asarray(bmax),
                     settings=settings.replace(
                         factorization_method=C2.FACTORIZE_CG),
                     x0=x0, y0=y0, device=device)

    def _cert(v):
        v = np.asarray(v)
        return v if np.isfinite(v).all() else None

    return HostResult(
        x=np.asarray(r.solution.x), y=np.asarray(r.solution.y),
        status=int(r.info.status_val), status_str=r.info.status,
        iterations=int(r.info.iter), objective=float(r.info.objective),
        pri_res_norm=float(r.info.pri_res_norm),
        dua_res_norm=float(r.info.dua_res_norm),
        delta_y=_cert(r.delta_y), delta_x=_cert(r.delta_x),
    )


solve_sparse_auto.route = None
