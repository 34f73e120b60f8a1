"""On-device active-set polish (counterpart of qpalm_tpu/polish_device.py).

Certifies the f32 fused-kernel solutions at 1e-6 on the unscaled problem
without leaving the card:

  * active-set detection from the f32 iterates (`_detect`);
  * a float32 preconditioner P = Q + A_act' A_act / delta_hat, factored by
    kernel K2 (`linalg.chol.cholesky_upper`), and its explicit inverse from
    the K2 solve with identity right-hand sides, as the reference forms it
    (polish_device.py:292-308);
  * iterative refinement against the true polish KKT system
    (regularization 1e-9), residuals in float64;
  * the full unscaled KKT check (`_check`).

The reference evaluates the residuals in f32 by default on the TPU, where
f64 is emulated (polish_device.py:21-32).  The H100 has native f64, so here
`residual32=False` is the default and `residual32=True` stays an option.
The reference leaves bmin/bmax in the dtype they arrive in
(polish_device.py:170); this port casts them to f64 (ROADMAP.md, section 3).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import constants as C
from . import trace
from .linalg.chol import cholesky_solve, cholesky_upper
from .precision import full_f32_matmul
from .types import QPData

_DELTA_REG = 1e-9  # the true system's regularization (matches polish.py)


class DevicePolishResult(NamedTuple):
    x: torch.Tensor          # (B, n) f64 polished primal
    y: torch.Tensor          # (B, m) f64 polished dual
    ok: torch.Tensor         # (B,) bool: full KKT check passed
    pri_res: torch.Tensor    # (B,) unscaled primal residual inf-norm
    dua_res: torch.Tensor    # (B,) unscaled dual residual inf-norm
    objective: torch.Tensor  # (B,)


def _mv(M, v):
    return torch.einsum("bij,bj->bi", M, v)


def _mtv(M, v):
    return torch.einsum("bmi,bm->bi", M, v)


def _detect(A, bmin, bmax, x, y, act_tol, eps_abs):
    """Active-set rules of polish._polish_one.detect, batched."""
    has_lb = bmin > -C.QPALM_INFTY
    has_ub = bmax < C.QPALM_INFTY
    Ax = _mv(A, x)
    act_lo = has_lb & ((y < -act_tol) | ((Ax - bmin < act_tol)
                                         & (y <= eps_abs)))
    act_hi = has_ub & ((y > act_tol) | ((bmax - Ax < act_tol)
                                        & (y >= -eps_abs)))
    eq = has_lb & has_ub & (
        bmax - bmin <= 1e-12 * torch.clamp(bmax.abs(), min=1.0))
    act_lo = act_lo | eq
    act_hi = act_hi & ~act_lo
    return act_lo, act_hi


def _check(Q, A, q, bmin, bmax, c, x, y, eps_abs, eps_rel):
    """Full unscaled KKT check, batched (twin of polish.check)."""
    Ax = _mv(A, x)
    z = torch.minimum(torch.maximum(Ax, torch.clamp(bmin, min=-C.QPALM_INFTY)),
                      torch.clamp(bmax, max=C.QPALM_INFTY))
    pri_norm = (Ax - z).abs().amax(1)
    Qx = _mv(Q, x)
    Aty = _mtv(A, y)
    dua_norm = (Qx + q + Aty).abs().amax(1)
    eps_pri = eps_abs + eps_rel * torch.maximum(Ax.abs().amax(1),
                                                z.abs().amax(1))
    eps_dua = eps_abs + eps_rel * torch.maximum(
        Qx.abs().amax(1),
        torch.maximum(q.abs().amax(1), Aty.abs().amax(1)))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    comp_viol = (torch.where(y > eps_abs, (Ax - bmax).abs(), zero)
                 + torch.where(y < -eps_abs, (Ax - bmin).abs(), zero)
                 ).amax(1)
    viol = torch.maximum(
        torch.maximum(pri_norm / eps_pri, dua_norm / eps_dua),
        comp_viol / (eps_pri + eps_abs))
    obj = ((0.5 * Qx + q) * x).sum(1) + c
    return viol, pri_norm, dua_norm, obj


def _polish_core(Q, A, q, bmin, bmax, c, x0, y0, eps_abs, eps_rel, act_tol,
                 delta_hat, refine_iters, fallback_to_seed=False,
                 residual32=False):
    """One detect -> f32 factor -> refinement -> check round
    (polish_device.py:243-387)."""
    f32 = torch.float32
    if residual32:
        act_lo, act_hi = _detect(A.to(f32), bmin, bmax, x0.to(f32), y0,
                                 act_tol, eps_abs)
    else:
        act_lo, act_hi = _detect(A, bmin, bmax, x0, y0, act_tol, eps_abs)
    act = act_lo | act_hi
    w = act.to(torch.float64)
    Aw = A * w[:, :, None]
    b_side = torch.where(act_lo, bmin, bmax)
    rhs_x = -q
    zero = torch.zeros((), dtype=torch.float64, device=q.device)
    rhs_nu = torch.where(act, b_side, zero)

    # f32 preconditioner P = Q + Aw'Aw/delta_hat (a plain product, as the
    # reference leaves it to XLA), its factor and explicit inverse by K2
    Aw32 = Aw.to(f32)
    P32 = Q.to(f32) + torch.einsum("bmi,bmj->bij", Aw32, Aw32) / delta_hat
    R32 = cholesky_upper(P32)
    n = P32.shape[-1]
    eye_b = torch.eye(n, dtype=f32, device=P32.device).expand_as(P32)
    Pinv32 = cholesky_solve(R32, eye_b.contiguous())
    wf = w.to(f32)

    def solve_M(r_x64, r_nu64):
        """Apply M^-1 in f32, return f64 corrections."""
        r_x = r_x64.to(f32)
        r_nu = r_nu64.to(f32)
        t = r_x + _mtv(Aw32, r_nu) / delta_hat
        dx = _mv(Pinv32, t)
        awx = _mv(Aw32, dx)
        dnu = wf * (awx - r_nu) / delta_hat + (1.0 - wf) * r_nu
        return dx.to(torch.float64), dnu.to(torch.float64)

    if residual32:
        Q32, q32, rhs_nu32 = Q.to(f32), q.to(f32), rhs_nu.to(f32)

        def residual(x, nu):
            x32, nu32 = x.to(f32), nu.to(f32)
            r_x = -q32 - (_mv(Q32, x32) + _mtv(Aw32, nu32))
            Kx_nu = _mv(Aw32, x32) + wf * (-_DELTA_REG) * nu32 \
                + (1.0 - wf) * nu32
            return r_x, rhs_nu32 - Kx_nu
    else:
        def residual(x, nu):
            r_x = rhs_x - (_mv(Q, x) + _mtv(Aw, nu))
            Kx_nu = _mv(Aw, x) + torch.where(act, -_DELTA_REG * nu, nu)
            return r_x, rhs_nu - Kx_nu

    x, nu = x0, y0
    first_n = last_n = torch.zeros(x0.shape[0], dtype=torch.float64,
                                   device=x0.device)
    for i in range(refine_iters):
        dx, dnu = solve_M(*residual(x, nu))
        last_n = dx.abs().amax(1)
        if i == 0:
            first_n = last_n
        x, nu = x + dx, nu + dnu
    y = torch.where(act, nu, zero)
    if fallback_to_seed:
        # divergence: the final correction is no smaller than the first
        diverged = ~(last_n < first_n) | ~torch.isfinite(last_n)
        x = torch.where(diverged[:, None], x0, x)
        y = torch.where(diverged[:, None], y0, y)
    if residual32:
        viol, pri, dua, obj = _check(
            Q.to(f32), A.to(f32), q.to(f32), bmin.to(f32), bmax.to(f32),
            c, x.to(f32), y.to(f32), eps_abs, eps_rel)
    else:
        viol, pri, dua, obj = _check(Q, A, q, bmin, bmax, c, x, y, eps_abs,
                                     eps_rel)
    return x, y, viol, pri, dua, obj


def polish_batch(data: QPData, x32, y32, eps_abs: float = 1e-6,
                 eps_rel: float = 1e-6, act_tol: float = 1e-4,
                 delta_hat: float = 1e-2, refine_iters: int = 4,
                 seed_guard=True, second_round_k: int = 0,
                 residual32: bool = False, accept_viol: float = 1.0
                 ) -> DevicePolishResult:
    """Polish a stacked batch on its device (polish_batch_tpu,
    polish_device.py:133-240).

    `data` is the unscaled problem; every field is cast to f64.  `x32`,
    `y32` are the f32 pass's solutions.  `seed_guard`: True keeps the better
    of polished point and seed by a second check; "norm" falls back to the
    seed only where the refinement diverged; False reports the polished
    point as is.  `second_round_k > 0` re-polishes the worst-K lanes from
    the round-1 point with delta_hat >= 0.1 and 10 sweeps, twice.  Spans
    (trace.py): "polish.round1", "polish.second_round" (their launches).
    """
    full_f32_matmul()
    f64 = torch.float64
    Q, A, q, bmin, bmax, c = (t.to(f64) for t in data)
    x0 = torch.as_tensor(x32, device=Q.device).to(f64)
    y0 = torch.as_tensor(y32, device=Q.device).to(f64)

    with trace.span("polish.round1"):
        x, y, viol, pri, dua, obj = _polish_core(
            Q, A, q, bmin, bmax, c, x0, y0, eps_abs, eps_rel, act_tol,
            delta_hat, refine_iters, fallback_to_seed=(seed_guard == "norm"),
            residual32=residual32)

        if seed_guard is True:
            viol0, pri0, dua0, obj0 = _check(Q, A, q, bmin, bmax, c, x0, y0,
                                             eps_abs, eps_rel)
            better = viol <= viol0
            x = torch.where(better[:, None], x, x0)
            y = torch.where(better[:, None], y, y0)
            viol = torch.where(better, viol, viol0)
            pri = torch.where(better, pri, pri0)
            dua = torch.where(better, dua, dua0)
            obj = torch.where(better, obj, obj0)

    if second_round_k:
        with trace.span("polish.second_round"):
            k2 = min(int(second_round_k), x.shape[0])
            idx = torch.topk(viol, k2).indices
            dh2 = max(delta_hat, 1e-1)
            x2, y2 = x[idx], y[idx]
            for _ in range(2):
                x2, y2, viol2, pri2, dua2, obj2 = _polish_core(
                    Q[idx], A[idx], q[idx], bmin[idx], bmax[idx], c[idx],
                    x2, y2, eps_abs, eps_rel, act_tol, dh2, 10,
                    fallback_to_seed=bool(seed_guard), residual32=residual32)
            imp = viol2 < viol[idx]
            x, y, viol, pri, dua, obj = (
                a.index_copy(0, idx, torch.where(
                    imp[:, None] if a.dim() == 2 else imp, a2, a[idx]))
                for a, a2 in ((x, x2), (y, y2), (viol, viol2), (pri, pri2),
                              (dua, dua2), (obj, obj2)))

    return DevicePolishResult(x=x, y=y, ok=viol <= accept_viol, pri_res=pri,
                              dua_res=dua, objective=obj)
