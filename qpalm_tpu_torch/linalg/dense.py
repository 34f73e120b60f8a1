"""Dense helpers (counterpart of qpalm_tpu/linalg/dense.py:29-53): the
norms that LOBPCG (solver/nonconvex.py) and the general loop
(solver/core.py) take, the three-way clamp and the Gershgorin bound.
Each reduces over the last axes, so a batch (B, n) gives B values.
`newton_solve_kkt` is the FACTORIZE_KKT Newton step (dense.py:188-225):
the quasi-definite (2,2) block eliminated, then kernel K2 on the rest.
"""

from __future__ import annotations

import torch


def norm_inf(v: torch.Tensor) -> torch.Tensor:
    """Infinity norm over the last axis (reference: src/lin_alg.c:126-163);
    0 for an empty axis."""
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    return v.abs().amax(-1)


def norm_two(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis."""
    return torch.sqrt((v * v).sum(-1))


def vec_mid(v: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Three-way clamp min(max(v, lo), hi) (reference: lin_alg.c:189-195
    vec_ew_mid_vec)."""
    return torch.minimum(torch.maximum(v, lo), hi)


def gershgorin_max(M: torch.Tensor) -> torch.Tensor:
    """Upper bound of the largest eigenvalue of each symmetric M (B, n, n)
    by Gershgorin circles (reference: src/nonconvex.c:185-210): (B,)."""
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    radius = M.abs().sum(-1) - diag.abs()
    return (diag + radius).amax(-1)


def newton_solve_kkt(Q: torch.Tensor, A: torch.Tensor, sigma: torch.Tensor,
                     active: torch.Tensor, gamma: torch.Tensor,
                     neg_dphi: torch.Tensor, proximal: bool) -> torch.Tensor:
    """The primal part d of the quasi-definite KKT system of each problem

        [ Q + I/gamma   Aact'     ] [d]   [-dphi]
        [ Aact         -Sact^-1   ] [v] = [  0  ]

    with inactive rows replaced by a unit diagonal (the reference's
    fixed-sparsity trick, solver_interface.c:145-174), by elimination of
    the diagonal (2,2) block: S = Q + I/gamma + Aact' diag(sigma) Aact,
    factored by K2a and solved by K2b.  Batched: Q (B, n, n), A (B, m, n),
    sigma and active (B, m), gamma (B,), neg_dphi (B, n)."""
    from .chol import cholesky_solve, cholesky_upper

    n = Q.shape[-1]
    Am = A * active.to(Q.dtype)[:, :, None]
    # the (2,2) block is -D, D = 1/sigma on active rows and 1 on inactive
    d_inv = torch.where(active, sigma, torch.ones_like(sigma))
    P = Q
    if proximal:
        eye = torch.eye(n, dtype=Q.dtype, device=Q.device)
        P = Q + (1.0 / gamma)[:, None, None] * eye
    S = P + torch.bmm(Am.transpose(1, 2) * d_inv[:, None, :], Am)
    return cholesky_solve(cholesky_upper(S), neg_dphi)
