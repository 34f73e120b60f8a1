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
  * the full unscaled KKT check (`_check`);
  * at large shapes, the correction of the lanes the polish rejects
    (`correct_rejected`).

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
# polish_batch corrects its rejected lanes on the card from m n^2 on: the
# host rescue of a lane costs ~m n^2 (0.3 s at n = 256, m = 2560; 8-9 ms
# at n = m = 104, where it overlaps the next batch's work for free).
CORRECT_MIN_MN2 = 1 << 24


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
    Ax = _mv(A, x)
    return _active_sets(
        bmin, bmax, (y < -act_tol) | ((Ax - bmin < act_tol) & (y <= eps_abs)),
        (y > act_tol) | ((bmax - Ax < act_tol) & (y >= -eps_abs)))


def _detect_pd(A, bmin, bmax, x, y, act_tol, eps_abs):
    """The primal-dual active-set rule: a row is active at the bound that
    y + Ax lies on or past, with no margin (`act_tol`, `eps_abs` unused)."""
    v = y + _mv(A, x)
    return _active_sets(bmin, bmax, v <= bmin, v >= bmax)


def _active_sets(bmin, bmax, lo, hi):
    """The rows active low and high: `lo`, `hi` where that bound is finite;
    equality rows are active low."""
    has_lb = bmin > -C.QPALM_INFTY
    has_ub = bmax < C.QPALM_INFTY
    eq = has_lb & has_ub & (
        bmax - bmin <= 1e-12 * torch.clamp(bmax.abs(), min=1.0))
    act_lo = (has_lb & lo) | eq
    return act_lo, has_ub & hi & ~act_lo


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
                 residual32=False, detect=_detect):
    """One detect -> f32 factor -> refinement -> check round
    (polish_device.py:243-387); `detect` is the active-set rule."""
    f32 = torch.float32
    if residual32:
        act_lo, act_hi = detect(A.to(f32), bmin, bmax, x0.to(f32), y0,
                                act_tol, eps_abs)
    else:
        act_lo, act_hi = detect(A, bmin, bmax, x0, y0, act_tol, eps_abs)
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
    return (x, y) + _check_as(Q, A, q, bmin, bmax, c, x, y, eps_abs,
                              eps_rel, residual32)


def _check_as(Q, A, q, bmin, bmax, c, x, y, eps_abs, eps_rel, residual32):
    """`_check` in f32 where the residuals are (`residual32`), else f64."""
    if residual32:
        f32 = torch.float32
        return _check(Q.to(f32), A.to(f32), q.to(f32), bmin.to(f32),
                      bmax.to(f32), c, x.to(f32), y.to(f32), eps_abs,
                      eps_rel)
    return _check(Q, A, q, bmin, bmax, c, x, y, eps_abs, eps_rel)


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
    the round-1 point with delta_hat >= 0.1 and 10 sweeps, twice, and
    where m n^2 >= CORRECT_MIN_MN2 (the padded shapes) ends with
    `correct_rejected`.  Spans (trace.py): "polish.round1",
    "polish.second_round", "polish.correct" (their launches).
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

    state = (x, y, viol, pri, dua, obj)
    if second_round_k:
        with trace.span("polish.second_round"):
            idx, sub = _worst_k_rounds(
                (Q, A, q, bmin, bmax, c), viol, second_round_k, x, y,
                eps_abs, eps_rel, act_tol, delta_hat, seed_guard, residual32,
                _detect)
            state = _merge(state, idx, sub, sub[2] < viol[idx])

    x, y, viol, pri, dua, obj = state
    pol = DevicePolishResult(x=x, y=y, ok=viol <= accept_viol, pri_res=pri,
                             dua_res=dua, objective=obj)
    if second_round_k and A.shape[1] * Q.shape[-1] ** 2 >= CORRECT_MIN_MN2:
        pol = correct_rejected(
            QPData(Q, A, q, bmin, bmax, c), x0, y0, pol, eps_abs=eps_abs,
            eps_rel=eps_rel, delta_hat=delta_hat,
            second_round_k=second_round_k, seed_guard=seed_guard,
            residual32=residual32, accept_viol=accept_viol, viol=viol)
    return pol


def _worst_k_rounds(data64, viol, k, x_start, y_start, eps_abs, eps_rel,
                    act_tol, delta_hat, seed_guard, residual32, detect):
    """The worst min(k, B) lanes by `viol` polished twice from `x_start`,
    `y_start` with 10 sweeps at delta_hat >= 0.1 and the active-set rule
    `detect`.  Returns their indices and their (x, y, viol, pri, dua,
    obj)."""
    idx = torch.topk(viol, min(int(k), viol.shape[0])).indices
    sub = tuple(t[idx] for t in data64)
    dh2 = max(delta_hat, 1e-1)
    x2, y2 = x_start[idx], y_start[idx]
    for _ in range(2):
        out = _polish_core(*sub, x2, y2, eps_abs, eps_rel, act_tol, dh2, 10,
                           fallback_to_seed=bool(seed_guard),
                           residual32=residual32, detect=detect)
        x2, y2 = out[:2]
    return idx, out


def _merge(state, idx, sub, take):
    """`state`'s tensors with the lanes `idx` replaced by `sub`'s where
    `take`."""
    return tuple(
        a.index_copy(0, idx, torch.where(
            take[:, None] if a.dim() == 2 else take, a2, a[idx]))
        for a, a2 in zip(state, sub))


def correct_rejected(data: QPData, x32, y32, pol: DevicePolishResult,
                     eps_abs: float = 1e-6, eps_rel: float = 1e-6,
                     delta_hat: float = 1e-2, second_round_k: int = 64,
                     seed_guard=True, residual32: bool = False,
                     accept_viol: float = 1.0, viol=None
                     ) -> DevicePolishResult:
    """Polish again on the device the lanes that `pol`, `polish_batch`'s
    result on `data` from the f32 pass's `x32`, `y32` with the same
    settings, rejected.

    `polish_batch`'s margin `act_tol` can take a row that sits just inside
    its bounds as active; the polish then gives it a wrong-signed
    multiplier, and its second round moves the row to its other bound.
    Here the worst min(second_round_k, B) lanes by the polish's violation
    start again from `x32`, `y32` and run two rounds of 10 sweeps at
    delta_hat >= 0.1, detecting the active set by the primal-dual rule
    (`_detect_pd`).  A lane is replaced only where `pol` rejected it and
    the correction's violation is lower: every lane `pol` certified comes
    back bit for bit, and a lane it cannot fix stays rejected.  `viol`:
    the polish's violation where the caller has it, else checked again.

    Span "polish.correct"; counters, while tracing is on only:
    "polish.correct.lanes" (the rejected lanes it polished again) and
    "polish.correct.certified" (those of them it certified).
    """
    with trace.span("polish.correct"):
        full_f32_matmul()
        f64 = torch.float64
        data64 = tuple(t.to(f64) for t in data)
        x0 = torch.as_tensor(x32, device=data64[0].device).to(f64)
        y0 = torch.as_tensor(y32, device=data64[0].device).to(f64)
        if viol is None:
            viol = _check_as(*data64, pol.x, pol.y, eps_abs, eps_rel,
                             residual32)[0]
        idx, sub = _worst_k_rounds(
            data64, viol, second_round_k, x0, y0, eps_abs, eps_rel, 0.0,
            delta_hat, seed_guard, residual32, _detect_pd)
        rejected = ~(viol[idx] <= accept_viol)
        fixed = rejected & ~(sub[2] >= viol[idx]) & ~torch.isnan(sub[2])
        x, y, viol, pri, dua, obj = _merge(
            (pol.x, pol.y, viol, pol.pri_res, pol.dua_res, pol.objective),
            idx, sub, fixed)
        if trace.is_on():
            trace.count("polish.correct.lanes", int(rejected.sum()))
            trace.count("polish.correct.certified",
                        int((fixed & (sub[2] <= accept_viol)).sum()))
    return DevicePolishResult(x=x, y=y, ok=viol <= accept_viol, pri_res=pri,
                              dua_res=dua, objective=obj)
