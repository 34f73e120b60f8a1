"""Kernel K1: the whole P-ALM iteration loop of a batch in one launch.

Replaces the Pallas kernel of qpalm_tpu/solver/fused.py (`_make_kernel`'s
inner `kernel`, launched per 128-lane block by `fused_chunk`) in both of its
memory tiers: convex (proximal or plain), nonconvex under per-problem gamma
pins, and dual-objective termination.  The CUDA source is
csrc/fused_palm.cu: one block of threads per problem.  In the on-chip tier
Q, A, the Schur matrix and the state sit in shared memory; in the streaming
tier, for shapes whose on-chip plan exceeds a block's shared memory, Q and
A stay in global memory, A passes through shared memory in row panels, and
the upper triangle of the Schur matrix lives in a global scratch, factored
in row panels (csrc/stream.cuh; `pick_tier` chooses, `stream_plan` sizes
the panels).  `fused_palm_plain` below is its plain twin;
it follows fused.py:538-906 operation by operation on batch-first tensors,
and is what a CPU tensor runs.

Around the kernel sits the host glue of the reference: `_prepare` (cast,
Ruiz scaling, initial state), `_init_fused` (cold and warm start, gamma
pins), `_finish` (unscaling, final multipliers) and `solve_batch_fused`
(one launch, or host-chunked launches with an early exit between them).

State layout, batch first and packed into three tensors:
    nst (B, 8, n): x, x0, Qx, A'y, x_prev, tau*Qd, tau*d, cert_x
    mst (B, 7, m): y, Ax, sigma, pri_res_in, act_old, tau*Ad, cert_y
    sc  (B, 18):   per-problem scalars, the rows of the reference's `sc`
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C
from .. import trace
from .._build import check_launch, kernels
from ..linalg.chol import SMEM_LIMIT, cholesky_upper_plain
from ..precision import full_f32_matmul
from ..scaling import identity_scaling, scale_data
from ..types import QPData, ScalingInfo, Settings

# scalar-state rows (the reference's SC layout, fused.py:68-70)
_GAMMA, _EPSA_IN, _EPSR_IN, _DONE, _ITER, _PREV_ITER, _NO_CHANGE, \
    _GAMMA_MAXED, _ITER_OUT, _GERSH, _NB_CHANGED, _PRI_NORM, _DUA_NORM, \
    _STATUS, _GAMMA_MAX, _EPSK_ABS, _EPSK_REL, _COBJ, _SC_ROWS = range(19)
# rows of the packed n- and m-vector state
_X, _X0, _QX, _ATY, _XPREV, _TQD, _TD, _CERTX, _N_ROWS = range(9)
_Y, _AX, _SIG, _PRIN, _ACTOLD, _TAD, _CERTY, _M_ROWS = range(8)


class FusedState(NamedTuple):
    nst: torch.Tensor  # (B, 8, n)
    mst: torch.Tensor  # (B, 7, m)
    sc: torch.Tensor   # (B, 18)


# Largest padded n the streaming tier takes.  This is a routing rule, not a
# limit of the card: past it the reference leaves its fused kernel for the
# general solver loop (qpalm_tpu/solver/fused.py:65 STREAM_WALL, reached from
# qpalm_tpu/batch.py:162), and so does batch.solve_batch (solver/core.py).
STREAM_N_MAX = 352


# The streaming tier's panels (fused_palm.cu): A's rows per staging panel
# and M's rows per Cholesky panel (a multiple of 8), each at most, and b at
# least
STREAM_P_MAX, STREAM_B_MAX, STREAM_B_MIN = 16, 32, 8


def stream_plan(n: int, m: int):
    """The streaming tier's shared-memory plan at (n, m), as fused_palm.cu's
    stream_plan: (P, b, stage, nbytes).  The 18 n- and 19 m-vectors and the
    reduction scratch sit as on chip; a staging region starts after the
    15th m-vector (16-byte aligned, float offset `stage`) with two
    mbarriers, max(2 P n, b n) floats of panels (two row panels of A for
    the Schur assembly, then b rows of M for the blocked Cholesky, then two
    row panels of the factor for the solves) and 4 floats of slack.  It overlaps the last four m-vectors and the reduction
    scratch, dead while those run.  P and b take what the vectors leave
    under SMEM_LIMIT, P at least 1 and b at least STREAM_B_MIN; nbytes over
    SMEM_LIMIT means no plan.  The minimum fits wherever the vectors alone
    fit (n <= STREAM_N_MAX), so this admits the shapes the plan without
    panels admitted."""
    stage = (18 * n + 15 * m + 3) & ~3
    avail = SMEM_LIMIT // 4 - stage - 8
    P = max(1, min(STREAM_P_MAX, avail // (2 * n)))
    b = max(STREAM_B_MIN, min(STREAM_B_MAX, avail // n // 8 * 8))
    floats = max(18 * n + 19 * m + 2 * 12 * 8,
                 stage + 8 + max(2 * P * n, b * n))
    return P, b, stage, 4 * floats


def fused_smem_bytes(n: int, m: int, stream: bool = False) -> int:
    """Shared memory one block of K1 uses at (n, m).  On chip: Q, A, the
    Schur matrix M, 18 n-vectors, 19 m-vectors and the reduction scratch;
    streaming: `stream_plan`'s.  It mirrors fused_palm.cu's
    qp_fused_smem_bytes and qp_fused_stream_smem_bytes, so the plan can be
    checked where the library cannot be built."""
    if stream:
        return stream_plan(n, m)[3]
    return 4 * (2 * n * n + m * n + 18 * n + 19 * m + 2 * 12 * 8)


def pick_tier(n: int, m: int):
    """K1's memory plan for a padded (n, m) shape, the counterpart of the
    reference's pick_qa_panel (fused.py:85-142) re-derived for a block's
    227 KB of shared memory: "smem" when Q, A, M and the state fit on chip,
    "stream" when only the state does and n <= STREAM_N_MAX, else None (no
    fused plan: the general loop's shapes)."""
    if fused_smem_bytes(n, m) <= SMEM_LIMIT:
        return "smem"
    if n <= STREAM_N_MAX and fused_smem_bytes(n, m, True) <= SMEM_LIMIT:
        return "stream"
    return None


def _tier(qa_panel: int, n: int, m: int) -> str:
    """The tier a `qa_panel` argument selects, with the reference's meaning
    (fused.py:944-945): -2 from the shape, 0 on chip, > 0 streaming.  The
    panel height itself is not taken: the streaming kernel's panels come
    from `stream_plan`."""
    if qa_panel == -2:
        tier = pick_tier(n, m)
        if tier is None:
            raise NotImplementedError(
                f"fused_palm: n={n}, m={m} has no fused memory plan (n over "
                f"{STREAM_N_MAX}, or the streaming tier's vectors over "
                f"{SMEM_LIMIT} bytes of shared memory): the reference runs "
                "the general solver loop there, as batch.solve_batch does "
                "(solver/core.py)")
        return tier
    if qa_panel < 0:
        raise ValueError(f"qa_panel must be -2, 0 or positive, got {qa_panel}")
    return "stream" if qa_panel else "smem"


def _float_settings(s: Settings) -> np.ndarray:
    """The float settings the kernel reads, in fused_palm.cu's FSet order,
    each rounded to f32 as the reference's weakly typed constants are."""
    return np.array([
        s.eps_abs, s.eps_rel, s.eps_prim_inf, s.eps_dual_inf, s.rho,
        s.theta, s.delta, s.sigma_max, s.gamma_upd,
        s.eps_dual_inf * s.eps_dual_inf, s.dual_objective_limit,
    ], np.float32)


# The plain twin sums in the CUDA kernel's order, so that the two round
# alike (the kernel is built without FMA contraction): a warp's xor
# butterfly over 32 lanes, a 256-thread block of 8 warps combined in warp
# order, and the sequential sums over the rows of A.
_BLOCK = 256


def _butterfly(v):
    """warp_sum over the last axis (32 lanes): the value lane 0 ends with,
    lane 0 adding lane 16's partial, then lane 8's, ... as the xor steps
    do."""
    for half in (16, 8, 4, 2, 1):
        v = v[..., :half] + v[..., half:2 * half]
    return v[..., 0]


def _strided(v, width):
    """Each of `width` threads sums elements t, t + width, ... of the last
    axis in order (zeros past its end); returns the (..., width) partials."""
    L = v.shape[-1]
    c = max(1, -(-L // width))
    v = torch.nn.functional.pad(v, (0, c * width - L)).unflatten(-1,
                                                                 (c, width))
    s = torch.zeros_like(v[..., 0, :])
    for i in range(c):
        s = s + v[..., i, :]
    return s


def _in_order(v):
    """Sequential sum over the last axis."""
    s = torch.zeros_like(v[..., 0])
    for k in range(v.shape[-1]):
        s = s + v[..., k]
    return s


def _lane_sum(v):
    """One warp's dot-product sum over the last axis (k = lane, lane+32...)."""
    return _butterfly(_strided(v, 32))


def _block_sum(v):
    """block_reduce's sum of per-thread values over the last axis, keepdim."""
    warps = _butterfly(_strided(v, _BLOCK).unflatten(-1, (_BLOCK // 32, 32)))
    return _in_order(warps)[..., None]


def _warp_rows_sum(v):
    """Rows j summed by warp j % 8 in order, then the 8 warps in order."""
    return _in_order(_strided(v, _BLOCK // 32))[..., None]


def gershgorin_completion(M):
    """Gershgorin row bound of the streaming tier (stream.cuh:
    gershgorin_add_q), read from M's upper triangle only: for row j, the
    column sum of |M[k, j]| over k < j in order, plus the lane-strided warp
    sum of |M[j, k]| over k >= j; the largest over j, (B, 1)."""
    cols = _in_order(torch.triu(M, 1).abs().transpose(1, 2))
    rows = _lane_sum(torch.triu(M).abs())
    return (cols + rows).amax(1, keepdim=True)


def _solve_kernel_order(R, b):
    """R'R x = b as the kernel's warp does it: forward saxpy over rows of R,
    backward inner products summed by lanes."""
    n = R.shape[-1]
    y = b.clone()
    z = torch.empty_like(b)
    for j in range(n):
        z[:, j] = y[:, j] / R[:, j, j]
        y[:, j + 1:] -= z[:, j, None] * R[:, j, j + 1:]
    x = torch.zeros_like(b)
    for k in range(n - 1, -1, -1):
        dot = _lane_sum(R[:, k, k + 1:] * x[:, k + 1:])
        x[:, k] = (z[:, k] - dot) / R[:, k, k]
    return x


def _linesearch_plain(eta, beta, sqs, Ad, Ax, y, sig, bmin, bmax):
    """Sort-free exact linesearch (fused.py:467-536): safeguarded Newton /
    bisection on the piecewise-linear derivative.  Vectors (B, m), scalars
    (B, 1); returns tau (B, 1)."""
    sad = sqs * Ad
    alo = (y + sig * (Ax - bmin)) / sqs
    ahi = (-y + sig * (bmax - Ax)) / sqs
    tiny = float(np.finfo(np.float32).tiny)
    zero = torch.zeros((), dtype=sad.dtype, device=sad.device)
    dd = sad * sad

    def ftz(v):
        # the reference runs with denormals flushed to zero (TPU, and XLA on
        # the CPU): sad * tiny must vanish there too, or a hinge sitting
        # exactly at its breakpoint (alo or ahi == 0) reads as active at 0+
        return torch.where(v.abs() < tiny, zero, v)

    def ab_at(tau):
        st = ftz(sad * tau)
        act1 = (-st - alo) > 0
        act2 = (st - ahi) > 0
        a = eta + _block_sum(torch.where(act1, dd, zero)
                             + torch.where(act2, dd, zero))
        b = beta - _block_sum(torch.where(act1, -sad * alo, zero)
                              + torch.where(act2, sad * ahi, zero))
        return a, b

    a0, b0 = ab_at(tiny)
    big = 1e30
    s1 = alo / (-sad)
    s2 = ahi / sad
    smax = torch.maximum(
        torch.where((s1 > 0) & (s1 < big), s1, zero).amax(1, keepdim=True),
        torch.where((s2 > 0) & (s2 < big), s2, zero).amax(1, keepdim=True),
    )
    actf1 = -sad > 0
    actf2 = sad > 0
    a_fin = eta + _block_sum(torch.where(actf1, dd, zero)
                             + torch.where(actf2, dd, zero))
    b_fin = beta - _block_sum(torch.where(actf1, -sad * alo, zero)
                              + torch.where(actf2, sad * ahi, zero))
    tau_fin = -b_fin / torch.clamp(a_fin, min=tiny)
    hi = torch.clamp(torch.maximum(smax, tau_fin), min=1.0) * 1.01 + 1.0
    lo = torch.zeros_like(hi)
    tau = torch.minimum(-b0 / torch.clamp(a0, min=tiny), hi)
    tau = torch.where(tau > 0, tau, 0.5 * hi)
    for _ in range(26):
        a, b = ab_at(tau)
        prop = -b / torch.clamp(a, min=tiny)
        mid = 0.5 * (lo + hi)
        prop = torch.where((prop > lo) & (prop < hi), prop, mid)
        pa, pb = ab_at(prop)
        # the sign of pa * prop + pb with one rounding, as a fused
        # multiply-add gives it (the reference kernel's XLA build, and the
        # CUDA kernel's fmaf): at the exact minimizer it is a rounding coin
        # flip that decides which end the bisection keeps
        pos = pa.double() * prop.double() + pb.double() > 0
        lo = torch.where(pos, lo, prop)
        hi = torch.where(pos, prop, hi)
        tau = prop
    a, b = ab_at(tau)
    tau_star = -b / torch.clamp(a, min=tiny)
    return torch.where(ftz(a0 * tiny) + b0 > 0, -b0 / a0, tau_star)


def fused_palm_plain(data: QPData, scal: ScalingInfo, st: FusedState, T: int,
                     s: Settings, stream: bool = False) -> FusedState:
    """Plain twin of the CUDA kernel: T iterations on every problem of the
    batch in lockstep, state written under masks (fused.py:538-906).
    `stream` assembles the Schur matrix in the streaming tier's order."""
    Q, A, q, bmin, bmax = data.Q, data.A, data.q, data.bmin, data.bmax
    Dinv, Einv = scal.Dinv, scal.Einv
    cinv = scal.cinv[:, None]
    nst, mst, sc = (t.clone() for t in st)
    n = Q.shape[-1]
    nonconvex = bool(s.nonconvex)  # implies proximal (solve_batch_fused)
    prox = bool(s.proximal)
    eps_abs, eps_rel = float(s.eps_abs), float(s.eps_rel)
    dual_limit = float(np.float32(s.dual_objective_limit))
    zero = torch.zeros((), dtype=Q.dtype, device=Q.device)
    one = torch.ones((), dtype=Q.dtype, device=Q.device)
    eye = torch.eye(n, dtype=Q.dtype, device=Q.device)

    Ev = 1.0 / Einv
    Dv = 1.0 / Dinv
    cfac = 1.0 / cinv
    has_ub = bmax < Ev * C.QPALM_INFTY
    has_lb = bmin > -Ev * C.QPALM_INFTY
    cs = cfac if s.scaling else torch.ones_like(cfac)
    e2 = float(np.float32(s.eps_dual_inf * s.eps_dual_inf))

    def mx(v):
        return v.abs().amax(1, keepdim=True)

    sm = _block_sum

    def row(k):
        return sc[:, k:k + 1]

    for _ in range(T):
        if bool((sc[:, _DONE] > 0.5).all()):
            break
        x, x0, Qx, aty, xprev, tqd, td, certx = nst.unbind(1)
        y, Ax, sig, prin, actold, tad, certy = mst.unbind(1)
        gamma = row(_GAMMA)
        done = row(_DONE) > 0.5

        # residuals (iteration.c:24-48)
        Axys = Ax + y * (1.0 / sig)
        z = torch.minimum(torch.maximum(Axys, bmin), bmax)
        pri_res = Ax - z
        yh = y + sig * pri_res
        df = Qx + q
        if prox:
            df = df - x0 / gamma
        Atyh = _in_order((A * yh[:, :, None]).transpose(1, 2))
        dphi = df + Atyh

        # termination (termination.c:44-129)
        pri_norm = mx(Einv * pri_res)
        dd_ = dphi - (x - x0) / gamma if prox else dphi
        dua_norm = mx(Dinv * dd_) * cinv
        dua2_norm = mx(Dinv * dphi) * cinv
        axz_max = torch.maximum(mx(Einv * Ax), mx(Einv * z))
        eps_pri = eps_abs + eps_rel * axz_max
        max_norm = torch.maximum(
            mx(Dinv * Qx), torch.maximum(mx(Dinv * q), mx(Dinv * Atyh))
        ) * cinv
        eps_dua = eps_abs + eps_rel * max_norm
        eps_dua_in = row(_EPSA_IN) + row(_EPSR_IN) * max_norm
        solved = (pri_norm < eps_pri) & (dua_norm < eps_dua) & ~done

        # infeasibility certificates (termination.c:136-240)
        dy = yh - y
        eps_p = s.eps_prim_inf * mx(Ev * dy)
        At_dy = Dinv * (Atyh - aty)
        oob = sm(torch.where(has_ub, bmax * torch.clamp(dy, min=0.0), zero)
                 + torch.where(has_lb, bmin * torch.clamp(dy, max=0.0), zero))
        pinf = (eps_p > 0) & (mx(At_dy) <= eps_p) & (oob <= -eps_p) \
            & ~done & ~solved
        dx = x - xprev
        Ddx = Dv * dx
        eps_d = s.eps_dual_inf * mx(Ddx)
        dxdx = sm(Ddx * Ddx)
        A_dx = Einv * tad
        viol = (torch.where(has_ub & (A_dx >= eps_d), one, zero)
                + torch.where(has_lb & (A_dx <= -eps_d), one, zero)
                ).amax(1, keepdim=True) > 0.5
        dxQdx = sm(dx * tqd)
        qdx = sm(q * dx)
        curv = (dxQdx <= -cs * e2 * dxdx) | (
            (dxQdx <= cs * e2 * dxdx) & (qdx <= -cs * eps_d))
        dinf = (eps_d > 0) & ~viol & curv & ~done & ~solved & ~pinf
        do_term = solved | pinf | dinf
        certy = torch.where(pinf, Ev * (cinv * dy), certy)
        certx = torch.where(dinf, Dv * dx, certx)

        outer_trigger = (dua2_norm <= eps_dua_in) | (row(_NO_CHANGE) >= 3)
        exhausted = row(_ITER) == row(_PREV_ITER) + s.inner_max_iter
        live = ~done & ~do_term & (row(_ITER) < s.max_iter)
        b_outer = live & outer_trigger
        b_exh = live & ~outer_trigger & exhausted
        b_inner = live & ~outer_trigger & ~exhausted
        b_sig = b_outer | b_exh

        # sigma update (iteration.c:86-145) on outer/exhausted trips
        pn_uns = mx(pri_res)
        sig_enabled = b_sig & (row(_ITER_OUT) > 0) & (pri_norm > eps_pri)
        cond_k = sig_enabled & (pri_res.abs() > s.theta * prin.abs()) \
            & (actold > 0.5)
        mult = torch.clamp(s.delta * pri_res.abs() / (pn_uns + 1e-6),
                           min=1.0)
        sig_new = torch.where(
            cond_k, torch.clamp(mult * sig, max=s.sigma_max), sig)

        # outer update (qpalm.c:515-644)
        y_new = torch.where(b_outer, yh, y)
        epsa_new = torch.where(
            b_outer, torch.clamp(s.rho * row(_EPSA_IN), min=eps_abs),
            row(_EPSA_IN))
        epsr_new = torch.where(
            b_outer, torch.clamp(s.rho * row(_EPSR_IN), min=eps_rel),
            row(_EPSR_IN))

        # dual-objective termination on outer trips (fused.py:683-710): a
        # Q that is not PD gives NaN, and a NaN dobj never terminates
        dual_term = torch.zeros_like(b_outer)
        if s.enable_dual_termination and bool(b_outer.any()):
            g = Atyh + q
            v = _solve_kernel_order(cholesky_upper_plain(Q), g)
            g_v = sm(g * v)
            contrib = sm(torch.where(yh > 0, yh * bmax, yh * bmin))
            dobj = (-0.5 * g_v - contrib) * cinv + row(_COBJ)
            dual_term = b_outer & torch.isfinite(dobj) & (dobj > dual_limit)

        gamma_new = gamma
        Qx_g = Qx
        nbch_new = row(_NB_CHANGED)
        gmaxed_new = row(_GAMMA_MAXED)
        gmax_l = row(_GAMMA_MAX)
        epsk_abs, epsk_rel = row(_EPSK_ABS), row(_EPSK_REL)
        x0_new = x0
        if nonconvex:
            # gamma pinned per problem: no boost; the proximal centre moves
            # on the eps_k ladder (qpalm.c:586-609), and exhausted trips
            # step gamma toward its cap (fused.py:721-747)
            eps_k = epsk_abs + epsk_rel * axz_max
            move = b_outer & (pri_norm < eps_k)
            epsk_abs = torch.where(
                move, torch.clamp(s.rho * epsk_abs, min=eps_abs), epsk_abs)
            epsk_rel = torch.where(
                move, torch.clamp(s.rho * epsk_rel, min=eps_rel), epsk_rel)
            x0_new = torch.where(move, x, x0)
            stepped = torch.where(
                gamma < gmax_l,
                torch.minimum(gamma * s.gamma_upd, gmax_l), gamma)
            gamma_new = torch.where(b_exh, stepped, gamma)
            diff = 1.0 / gamma_new - 1.0 / gamma
            Qx_g = torch.where(b_exh & (gamma_new != gamma), Qx + diff * x,
                               Qx)
        elif prox:
            # boost when the active set has settled (qpalm.c:612-630)
            check = b_outer & (gmaxed_new < 0.5) & (row(_ITER_OUT) > 0) \
                & (row(_NB_CHANGED) < 0.5) & (pri_norm < eps_pri)
            Axys2 = Ax + y_new * (1.0 / sig_new)
            act2 = ((Axys2 <= bmin) | (Axys2 >= bmax)).to(Q.dtype)
            nb2 = sm((act2 - actold).abs())
            nact2 = sm(act2)
            boost = check & (nb2 < 0.5)
            boosted = torch.where(
                nact2 > 0.5,
                torch.maximum(gmax_l,
                              1e14 / torch.clamp(row(_GERSH), min=1e-30)),
                torch.full_like(gamma, 1e12))
            stepped = torch.where(
                gamma < gmax_l,
                torch.minimum(gamma * s.gamma_upd, gmax_l), gamma)
            g_out = torch.where(boost, boosted, stepped)
            gamma_new = torch.where(
                b_outer, g_out, torch.where(b_exh, stepped, gamma))
            diff = 1.0 / gamma_new - 1.0 / gamma
            Qx_g = torch.where(b_sig & (gamma_new != gamma), Qx + diff * x,
                               Qx)
            gmaxed_new = torch.where(boost & (nact2 > 0.5), one, gmaxed_new)
            nbch_new = torch.where(check, torch.clamp(nb2, max=1.0),
                                   nbch_new)
            x0_new = torch.where(b_sig, x, x0)

        prin_new = torch.where(b_sig, pri_res, prin)
        iter_out_new = row(_ITER_OUT) + b_sig.to(Q.dtype)
        prev_iter_new = torch.where(b_sig, row(_ITER), row(_PREV_ITER))
        no_change_after = torch.where(b_sig, zero, row(_NO_CHANGE))

        # inner newton step (qpalm.c:662-678)
        active = ((Axys <= bmin) | (Axys >= bmax)).to(Q.dtype)
        nb_inner = sm((active - actold).abs())
        no_change_new = torch.where(
            b_inner,
            torch.where(nbch_new > 0.5, zero, no_change_after + 1.0),
            no_change_after)
        actold_new = torch.where(b_inner, active, actold)
        nbch_final = torch.where(b_inner, torch.clamp(nb_inner, max=1.0),
                                 nbch_new)

        # Newton direction for every lane, applied under the b_inner mask
        w = active * sig_new
        # on chip M = Q + A'WA and Gershgorin reads M - Q; streaming
        # (fused.py:390-425) M = A'WA, Gershgorin reads the symmetric
        # completion of its upper triangle (the kernel forms no other),
        # then M += Q
        M = torch.zeros_like(Q) if stream else Q
        for i in range(A.shape[1]):
            M = M + (w[:, i, None] * A[:, i])[:, :, None] * A[:, i, None, :]
        if stream:
            gersh = gershgorin_completion(M)
            M = M + Q
        else:
            gersh = _lane_sum((M - Q).abs()).amax(1, keepdim=True)
        if prox:
            M = M + eye * (1.0 / gamma_new)[:, :, None]
        d = _solve_kernel_order(cholesky_upper_plain(M), -dphi)
        gersh_new = torch.where(b_inner, gersh, row(_GERSH))
        Qd_pure = _lane_sum(Q * d[:, None, :])
        Qd = Qd_pure + d / gamma_new if prox else Qd_pure
        Ad = _lane_sum(A * d[:, None, :])
        eta = _warp_rows_sum(d * Qd)
        beta = _warp_rows_sum(d * df)
        tau = _linesearch_plain(eta, beta, torch.sqrt(sig_new), Ad, Ax,
                                y_new, sig_new, bmin, bmax)

        # torch.where, not arithmetic masking: a masked-off lane's Newton
        # step may be NaN, and 0 * NaN would poison the state
        nst = torch.stack([
            torch.where(b_inner, x + tau * d, x),
            x0_new,
            torch.where(b_inner, Qx_g + tau * Qd, Qx_g),
            torch.where(b_outer, Atyh, aty),
            torch.where(b_inner, x, xprev),
            torch.where(b_inner, tau * Qd_pure, tqd),
            torch.where(b_inner, tau * d, td),
            certx,
        ], dim=1)
        mst = torch.stack([
            y_new,
            torch.where(b_inner, Ax + tau * Ad, Ax),
            torch.where(b_sig, sig_new, sig),
            prin_new,
            actold_new,
            torch.where(b_inner, tau * Ad, tad),
            certy,
        ], dim=1)

        # scalar state; the terminating trip is not counted (fused.py:880),
        # and a finished problem keeps the norms of its last trip, as the
        # kernel's block does when it leaves its loop
        status_new = torch.where(
            solved, float(C.QPALM_SOLVED),
            torch.where(pinf, float(C.QPALM_PRIMAL_INFEASIBLE),
                        torch.where(dinf, float(C.QPALM_DUAL_INFEASIBLE),
                                    torch.where(
                                        dual_term,
                                        float(C.QPALM_DUAL_TERMINATED),
                                        row(_STATUS)))))
        sc = sc.clone()
        for k, v in (
            (_GAMMA, gamma_new), (_EPSA_IN, epsa_new), (_EPSR_IN, epsr_new),
            (_DONE, (done | do_term | dual_term).to(Q.dtype)),
            (_ITER, row(_ITER) + (live & ~dual_term).to(Q.dtype)),
            (_PREV_ITER, prev_iter_new), (_NO_CHANGE, no_change_new),
            (_GAMMA_MAXED, gmaxed_new), (_ITER_OUT, iter_out_new),
            (_GERSH, gersh_new), (_NB_CHANGED, nbch_final),
            (_PRI_NORM, torch.where(done, row(_PRI_NORM), pri_norm)),
            (_DUA_NORM, torch.where(done, row(_DUA_NORM), dua_norm)),
            (_STATUS, status_new), (_EPSK_ABS, epsk_abs),
            (_EPSK_REL, epsk_rel),
        ):
            sc[:, k] = v[:, 0]
    return FusedState(nst, mst, sc)


def _check_cuda_f32(tensors):
    """Refuse any input of the kernel that is not a CUDA float32 tensor."""
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError("fused_palm: every input must be a CUDA "
                             f"float32 tensor, got {t.dtype} on {t.device}")


def fused_palm(data: QPData, scal: ScalingInfo, st: FusedState, T: int,
               s: Settings, qa_panel: int = -2) -> FusedState:
    """Run T P-ALM iterations on scaled f32 data: the plain twin for CPU
    tensors, the CUDA kernel (one launch) for CUDA tensors, in the memory
    tier `qa_panel` selects (-2 from the shape, 0 on chip, > 0 streaming).
    `fused_palm.launches` counts launches of either tier,
    `fused_palm.stream_launches` those of the streaming tier, as does the
    counter "k1.stream_launches" (trace.py).  While
    `fused_palm.events` is a list, each launch appends to it the CUDA
    events recorded just before and just after it.  While
    `fused_palm.profile` is a list, each launch appends an int64 tensor of
    each block's clock cycles by section, then in the whole loop:
    (B, 6) streaming (`PROFILE_SECTIONS`), (B, 7) on chip
    (`SMEM_PROFILE_SECTIONS`); a profiled on-chip launch runs a build of
    the kernel with the counters (the same arithmetic, and up to 60 bytes
    of shared memory more than `fused_smem_bytes`)."""
    B, n, _ = data.Q.shape
    m = data.A.shape[1]
    stream = _tier(qa_panel, n, m) == "stream"
    if data.Q.device.type == "cpu":
        return fused_palm_plain(data, scal, st, T, s, stream)
    tensors = (*data[:5], scal.Dinv, scal.Einv, scal.cinv, *st)
    _check_cuda_f32(tensors)
    shapes = [(B, n, n), (B, m, n), (B, n), (B, m), (B, m), (B, n), (B, m),
              (B,), (B, _N_ROWS, n), (B, _M_ROWS, m), (B, _SC_ROWS)]
    if [tuple(t.shape) for t in tensors] != shapes:
        raise ValueError("fused_palm: shapes "
                         f"{[tuple(t.shape) for t in tensors]}, need {shapes}")
    if n % 4:
        raise ValueError(f"fused_palm: n={n} must be a multiple of 4 "
                         "(stack_problems pads to 8)")
    need = fused_smem_bytes(n, m, stream)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"fused_palm: the {'streaming' if stream else 'on-chip'} tier "
            f"at n={n}, m={m} needs {need} bytes of shared memory, over "
            f"{SMEM_LIMIT}")
    # Q, A and the streaming tier's scratch M are read as float4: 16-byte
    # aligned, contiguous copies (torch.empty allocations are aligned)
    ins = [t.contiguous() for t in tensors[:8]]
    ins = [t if t.data_ptr() % 16 == 0 else t.clone() for t in ins]
    out = FusedState(*(t.clone(memory_format=torch.contiguous_format)
                       for t in st))
    scratch = torch.empty((B, n, n), dtype=torch.float32,
                          device=data.Q.device) if stream else None
    prof = None
    if fused_palm.profile is not None:
        names = PROFILE_SECTIONS if stream else SMEM_PROFILE_SECTIONS
        prof = torch.zeros((B, len(names) + 1), dtype=torch.int64,
                           device=data.Q.device)
        fused_palm.profile.append(prof)
    fset = _float_settings(s)
    events = fused_palm.events
    with torch.cuda.device(data.Q.device):
        if events is not None:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        rc = kernels().qp_fused_palm(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in out),
            scratch.data_ptr() if stream else None,
            None if prof is None else prof.data_ptr(), fset.ctypes.data, B, n,
            m, int(T), int(s.inner_max_iter), int(s.max_iter),
            int(bool(s.scaling)), int(bool(s.proximal)),
            int(bool(s.nonconvex)), int(bool(s.enable_dual_termination)),
            int(stream), torch.cuda.current_stream().cuda_stream)
        if events is not None:
            events[-1][1].record()
    check_launch("qp_fused_palm", rc)
    fused_palm.launches += 1
    if stream:
        _count_stream_launch()
    return out


def _count_stream_launch():
    """One launch of the streaming tier, in `fused_palm.stream_launches`
    and in the counter "k1.stream_launches" (trace.py)."""
    fused_palm.stream_launches += 1
    trace.count("k1.stream_launches")


fused_palm.launches = 0
fused_palm.stream_launches = 0
fused_palm.events = None
fused_palm.profile = None
# the cycle counters before the whole loop's: the streaming kernel's, and
# the on-chip kernel's (the dual check's Cholesky and solves included)
PROFILE_SECTIONS = ("assembly", "gershgorin_q", "cholesky_panels",
                    "cholesky_trailing", "solves")
SMEM_PROFILE_SECTIONS = ("assembly", "gershgorin", "cholesky", "solves",
                         "qd_ad", "linesearch")


def profile_split(prof: torch.Tensor, ms: float) -> dict:
    """The milliseconds `ms` of a profiled launch of either tier split by
    the summed cycle counters of its blocks (`fused_palm.profile`), the
    cycles outside the sections as "rest"."""
    names = PROFILE_SECTIONS if prof.shape[1] == len(PROFILE_SECTIONS) + 1 \
        else SMEM_PROFILE_SECTIONS
    tot = prof.double().sum(0).cpu()
    split = {k: float(ms * tot[i] / tot[-1]) for i, k in enumerate(names)}
    split["rest"] = ms - sum(split.values())
    return split


def _tensor(a, like: torch.Tensor) -> torch.Tensor:
    """A tensor or array-like as a tensor of `like`'s dtype and device (an
    array is copied: it may be a read-only view of another framework's)."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=like.dtype, device=like.device)
    return torch.tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def _init_fused(data: QPData, s: Settings, x_ws=None, y_ws=None,
                gamma_init=None, gamma_max=None) -> FusedState:
    """Cold or warm start (qpalm.c:322-399 and the sigma heuristic
    iteration.c:50-84, as fused.py:1075-1138).  `gamma_init`/`gamma_max`
    are optional per-problem (B,) values: the nonconvex gamma pins."""
    Q, A, q, bmin, bmax = data.Q, data.A, data.q, data.bmin, data.bmax
    B, n = q.shape
    m = bmin.shape[1]
    kw = dict(dtype=q.dtype, device=q.device)
    g0 = torch.full((B,), s.gamma_init, **kw) if gamma_init is None \
        else _tensor(gamma_init, q)
    gmax = torch.full((B,), s.gamma_max, **kw) if gamma_max is None \
        else _tensor(gamma_max, q)
    if x_ws is not None:
        x = x_ws
        Qx = torch.einsum("bij,bj->bi", Q, x)
        if s.proximal:
            Qx = Qx + x / g0[:, None]
        Ax = torch.einsum("bmn,bn->bm", A, x)
    else:
        x = torch.zeros((B, n), **kw)
        Qx = torch.zeros((B, n), **kw)
        Ax = torch.zeros((B, m), **kw)
    y = y_ws if y_ws is not None else torch.zeros((B, m), **kw)

    f = 0.5 * (x * Qx).sum(1) + (q * x).sum(1)
    dist = Ax - torch.minimum(torch.maximum(Ax, bmin), bmax)
    dist2 = (dist * dist).sum(1)
    sig0 = torch.clamp(
        s.sigma_init * torch.clamp(f.abs(), min=1.0)
        / torch.clamp(0.5 * dist2, min=1.0), 1e-4, 1e4)
    sigma = sig0[:, None].expand(B, m)

    sc = torch.zeros((B, _SC_ROWS), **kw)
    sc[:, _GAMMA] = g0
    sc[:, _GAMMA_MAX] = gmax
    sc[:, _EPSA_IN] = s.eps_abs_in
    sc[:, _EPSR_IN] = s.eps_rel_in
    sc[:, _EPSK_ABS] = s.eps_abs_in
    sc[:, _EPSK_REL] = s.eps_rel_in
    sc[:, _STATUS] = float(C.QPALM_UNSOLVED)
    sc[:, _COBJ] = data.c
    zn = torch.zeros((B, n), **kw)
    zm = torch.zeros((B, m), **kw)
    nst = torch.stack([x, x, Qx, zn, x, zn, zn, zn], dim=1)
    mst = torch.stack([y, Ax, sigma, zm, zm, zm, zm], dim=1)
    return FusedState(nst, mst, sc)


def _prepare(data: QPData, s: Settings, x_ws=None, y_ws=None,
             gamma_init=None, gamma_max=None):
    """Cast to f32, scale, and build the initial state (fused.py:1141)."""
    d32 = QPData(*(t.to(torch.float32) for t in data))
    B, n = d32.q.shape
    m = d32.bmin.shape[1]
    if s.scaling:
        sdata, scal = scale_data(d32, s.scaling)
    else:
        sdata = d32
        scal = identity_scaling(B, n, m, torch.float32, d32.q.device)
    xw = None if x_ws is None else _tensor(x_ws, d32.q) * scal.Dinv
    yw = None if y_ws is None else \
        _tensor(y_ws, d32.q) * scal.Einv * scal.c[:, None]
    return sdata, scal, _init_fused(sdata, s, xw, yw, gamma_init, gamma_max)


def _finish(sdata: QPData, scal: ScalingInfo, st: FusedState):
    """Unscale and form the final multipliers (termination.c:242-252)."""
    sig = st.mst[:, _SIG]
    y = st.mst[:, _Y]
    Ax = st.mst[:, _AX]
    Axys = Ax + y * (1.0 / sig)
    z = torch.minimum(torch.maximum(Axys, sdata.bmin), sdata.bmax)
    yh = y + sig * (Ax - z)
    x_sol = scal.D * st.nst[:, _X]
    y_sol = scal.E * (scal.cinv[:, None] * yh)
    status = torch.where(
        st.sc[:, _DONE] > 0.5, st.sc[:, _STATUS].to(torch.int32),
        torch.full_like(st.sc[:, _STATUS], C.QPALM_MAX_ITER_REACHED,
                        dtype=torch.int32))
    return (x_sol, y_sol, status, st.sc[:, _ITER].to(torch.int32),
            st.sc[:, _PRI_NORM], st.sc[:, _DUA_NORM], st.mst[:, _CERTY],
            st.nst[:, _CERTX])


def solve_batch_fused(data: QPData, settings: Settings, x_ws=None,
                      y_ws=None, chunk: int = 0, gamma_init=None,
                      gamma_max=None, qa_panel: int = -2):
    """Solve a stacked batch (leading batch axis, as from stack_problems)
    with kernel K1 on the batch's device (fused.py:1282).  Returns
    (x (B,n), y (B,m), status (B,), iterations (B,), pri_norm (B,),
    dua_norm (B,), delta_y (B,m), delta_x (B,n)), unscaled; certificates
    are meaningful only where the status reports the infeasibility.

    `chunk` 0 runs max_iter iterations in one launch; a positive chunk runs
    launches of `chunk` iterations with a host early-exit check between
    them.  For `settings.nonconvex` pass the per-problem pins of
    `nonconvex.batch_gamma_pins` as `gamma_init`/`gamma_max`.  `qa_panel`
    selects K1's memory tier as in `fused_palm`."""
    if chunk < 0:
        raise ValueError(f"chunk must be >= 0, got {chunk}")
    if settings.nonconvex:
        settings = settings.replace(proximal=True)
    full_f32_matmul()
    sdata, scal, st = _prepare(data, settings, x_ws, y_ws, gamma_init,
                               gamma_max)
    max_iter = int(settings.max_iter)
    if not chunk:
        st = fused_palm(sdata, scal, st, max_iter, settings, qa_panel)
        return _finish(sdata, scal, st)
    done_iters = 0
    while done_iters < max_iter:
        step = min(int(chunk), max_iter - done_iters)
        st = fused_palm(sdata, scal, st, step, settings, qa_panel)
        done_iters += step
        if done_iters < max_iter and bool((st.sc[:, _DONE] > 0.5).all()):
            break
    return _finish(sdata, scal, st)
