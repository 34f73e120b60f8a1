"""Differentiable QP solves: gradients through the optimizer (counterpart of
qpalm_tpu/diff.py).

`solve_diff` returns x*(Q, A, q, bmin, bmax) as a `torch.autograd.Function`
whose backward pass differentiates the solution map by the implicit
function theorem on the active-set KKT conditions (the OptNet
construction, for two-sided constraints and fixed shapes):

    Q x* + q + A' y* = 0
    A_act x*         = b_act        (rows active at the solution)

The forward pass is the port's general loop (solver/core.py) on the
unscaled problem; the backward pass solves one masked KKT system, the
solver's own quasi-definite form with a hard penalty standing in for the
equality rows, by kernel K2 (`cholesky_upper`, then `cholesky_solve`) on
the card and by its plain twins on the CPU.  A leading batch dimension is
accepted (the counterpart of the reference's vmapped use): each problem
is solved and differentiated on its own.
"""

from __future__ import annotations

import torch

from .linalg.chol import cholesky_solve, cholesky_upper
from .scaling import identity_scaling
from .solver.core import init_state, solve_from_state
from .types import QPData, Settings

# active-set detection margins and the equality-row penalty of the backward
# KKT solve (qpalm_tpu/diff.py:36-49): the slack margin is relative to the
# constraint scale and wider for float32 forward solves; rows with a
# clearly nonzero multiplier are active regardless of slack.  The penalty
# stays within the working precision's headroom: 1e10 at f64, 1e5 at f32.
_ACT_TOL_F64 = 1e-7
_ACT_TOL_F32 = 3e-4
_Y_TOL_REL = 1e-6
_HARD_SIGMA_F64 = 1e10
_HARD_SIGMA_F32 = 1e5


def _solve_primal(Q, A, q, bmin, bmax, settings: Settings):
    """(x, y) of a batch, unscaled loop (qpalm_tpu/diff.py:52-58)."""
    B, n = q.shape
    data = QPData(Q=Q, A=A, q=q, bmin=bmin, bmax=bmax,
                  c=torch.zeros((B,), dtype=Q.dtype, device=Q.device))
    scal = identity_scaling(B, n, A.shape[1], Q.dtype, Q.device)
    st = init_state(data, scal, settings)
    final = solve_from_state(st, data, scal, settings)
    return final.x, final.yh


def _amax(v):
    return v.abs().amax(-1, keepdim=True)


def active_rows(A, bmin, bmax, x, y, eps_abs: float):
    """(active, at_upper) masks (B, m) of the rows the backward pass holds
    as equalities at the solution (x, y) (qpalm_tpu/diff.py:79-93)."""
    Ax = torch.matmul(A, x[..., None])[..., 0]
    base = _ACT_TOL_F32 if A.dtype == torch.float32 else _ACT_TOL_F64
    tol = base * torch.clamp(_amax(Ax), min=1.0)
    # a multiplier marks a row active only when it clearly exceeds the
    # solver's own dual tolerance
    y_tol = torch.clamp(_Y_TOL_REL * torch.clamp(_amax(y), min=1.0),
                        min=10.0 * float(eps_abs))
    at_upper = (Ax >= bmax - tol) | (y > y_tol)
    active = (Ax <= bmin + tol) | at_upper | (y < -y_tol)
    return active, at_upper


class _SolveDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Q, A, q, bmin, bmax, settings):
        x, y = _solve_primal(Q, A, q, bmin, bmax, settings)
        ctx.save_for_backward(Q, A, bmin, bmax, x, y)
        ctx.settings = settings
        return x

    @staticmethod
    def backward(ctx, gx):
        """qpalm_tpu/diff.py:76-121, a batch at a time."""
        Q, A, bmin, bmax, x, y = ctx.saved_tensors
        dtype = Q.dtype
        f32 = dtype == torch.float32
        active, at_upper = active_rows(A, bmin, bmax, x, y,
                                       ctx.settings.eps_abs)

        # masked KKT solve: K = Q + A_act' sigma A_act with sigma -> inf
        # emulates the equality rows; lam solves K lam = -gx
        hard = _HARD_SIGMA_F32 if f32 else _HARD_SIGMA_F64
        zero = torch.zeros((), dtype=dtype, device=Q.device)
        sig = torch.where(active, torch.full((), hard, dtype=dtype,
                                             device=Q.device), zero)
        Bm = A * torch.sqrt(sig)[..., None]
        n = Q.shape[-1]
        K = Q + torch.bmm(Bm.transpose(1, 2), Bm) \
            + 1e-12 * torch.eye(n, dtype=dtype, device=Q.device)
        lam = cholesky_solve(cholesky_upper(K), (-gx).contiguous())
        # the adjoint's dual part: nu = sigma (A lam) on active rows
        nu = sig * torch.matmul(A, lam[..., None])[..., 0]

        # the OptNet formulas (two-sided bounds: the active side receives
        # the equality gradient)
        dq = lam
        dQ = 0.5 * (lam[:, :, None] * x[:, None, :]
                    + x[:, :, None] * lam[:, None, :])
        y_act = torch.where(active, y, zero)
        dA = y_act[:, :, None] * lam[:, None, :] \
            + nu[:, :, None] * x[:, None, :]
        db = -nu
        dbmax = torch.where(active & at_upper, db, zero)
        dbmin = torch.where(active & ~at_upper, db, zero)
        return dQ, dA, dq, dbmin, dbmax, None


def solve_diff(Q, A, q, bmin, bmax, settings: Settings):
    """Solve the QP and return x*, differentiable with respect to all of
    (Q, A, q, bmin, bmax): the OptNet contract.  Q (n, n), A (m, n),
    q (n,), bmin and bmax (m,), or each with a leading batch dimension B.

    Scaling is disabled internally (the gradient formulas live in the
    original variables).  The gradient is exact where the active set is
    locally stable; at degenerate points it is a subgradient choice.  It
    runs where the tensors live."""
    if Q.dim() == 2:
        return _SolveDiff.apply(Q[None], A[None], q[None], bmin[None],
                                bmax[None], settings)[0]
    return _SolveDiff.apply(Q, A, q, bmin, bmax, settings)
