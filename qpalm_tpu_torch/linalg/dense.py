"""Dense helpers (counterpart of qpalm_tpu/linalg/dense.py): the norms
that LOBPCG (solver/nonconvex.py) and the general loop (solver/core.py)
take, the three-way clamp and the Gershgorin bound (dense.py:29-53).
Each reduces over the last axes, so a batch (B, n) gives B values.
`newton_solve_kkt` is the FACTORIZE_KKT Newton step (dense.py:188-225):
the quasi-definite (2,2) block eliminated, then kernel K2 on the rest.

The Schur Newton step of dense.py:54-186 with its parts:
`cholesky_shifted` (K2a's factor, returned lower as the reference's
`jnp.linalg.cholesky`), `cho_solve` (K2b), `schur_matrix` (one matrix
product), `newton_solve_schur` (with the reference's refinement loop and
its `reuse` select) and the host cost model `select_factorization_method`.
Each takes the reference's one unbatched problem, or a leading batch
dimension: K2 runs on a batch, so one problem is a batch of one.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C


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


def cholesky_shifted(M: torch.Tensor, shift) -> torch.Tensor:
    """Lower factor L (L L' = M + shift I) of SPD M (n, n) or (B, n, n)
    (reference: dense.py:54-58, the ldlchol beta-shift of
    solver_interface.c:319-370): K2a's upper factor R, returned as R'."""
    from .chol import cholesky_upper

    one = M.dim() == 2
    Mb = M[None] if one else M
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    shift = torch.as_tensor(shift, dtype=M.dtype, device=M.device)
    L = cholesky_upper((Mb + shift.reshape(-1, 1, 1) * eye).contiguous()).mT
    return L[0] if one else L


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L L' x = b for lower L (n, n) and b (n,) or (n, k), or a
    batch of them (reference: dense.py:61-64): K2b on R = L'."""
    from .chol import cholesky_solve

    one = L.dim() == 2
    Lb, bb = (L[None], b[None]) if one else (L, b)
    x = cholesky_solve(Lb.mT.contiguous(), bb.contiguous())
    return x[0] if one else x


def schur_matrix(Q: torch.Tensor, A: torch.Tensor, sqrt_sigma: torch.Tensor,
                 active: torch.Tensor, gamma_inv, proximal: bool):
    """M = Q [+ I/gamma] + A' diag(sigma active) A, for one problem or a
    batch (reference: dense.py:67-86, ldlcholQAtsigmaA of
    solver_interface.c:372-405): one matrix product, as the reference
    leaves it to XLA."""
    w = torch.where(active, sqrt_sigma, torch.zeros_like(sqrt_sigma))
    Bm = A * w[..., :, None]
    M = Q + Bm.mT @ Bm
    if proximal:
        eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
        gi = torch.as_tensor(gamma_inv, dtype=Q.dtype, device=Q.device)
        M = M + gi[..., None, None] * eye
    return M


def _refine(M, L, b, x, max_refine: int):
    """Iterative refinement of M x = b on the factor L (reference:
    dense.py:89-111, newton.c:57-90): each problem takes steps while
    fewer than max_refine were taken and its residual's infinity norm is
    over max(1e-10 max(|b|_inf, 1), 1e-12); every problem runs every step
    and a finished one keeps its x.  Batched: M (B, n, n), b and x (B,
    n)."""
    def residual(v):
        return b - (M @ v[..., None])[..., 0]

    tol = torch.clamp(C.RELATIVE_REFINEMENT_TOLERANCE
                      * torch.clamp(norm_inf(b), min=1.0),
                      min=C.ABSOLUTE_REFINEMENT_TOLERANCE)
    res = norm_inf(residual(x))
    for _ in range(max_refine):
        go = res > tol
        x = torch.where(go[:, None], x + cho_solve(L, residual(x)), x)
        res = torch.where(go, norm_inf(residual(x)), res)
    return x


def newton_solve_schur(Q: torch.Tensor, A: torch.Tensor,
                       sqrt_sigma: torch.Tensor, active: torch.Tensor,
                       gamma, neg_dphi: torch.Tensor, proximal: bool,
                       max_refine: int = 0, L: torch.Tensor | None = None,
                       reuse=None):
    """(d, L): M d = -dphi with M the Schur matrix, and M's lower factor
    (reference: dense.py:114-141).  Where `reuse` is true the cached
    factor L is used unchanged (the reference skipping the
    refactorization when the active set did not change, newton.c:96-113).
    One problem (Q (n, n), gamma a scalar) or a batch (Q (B, n, n), gamma
    and reuse (B,))."""
    from .chol import cholesky_upper

    one = Q.dim() == 2
    dev, dtype = Q.device, Q.dtype
    gamma = torch.as_tensor(gamma, dtype=dtype, device=dev).reshape(-1)
    if one:
        Q, A, sqrt_sigma, active, neg_dphi = (
            t[None] for t in (Q, A, sqrt_sigma, active, neg_dphi))
        L = None if L is None else L[None]
    gamma_inv = 1.0 / gamma if proximal else torch.zeros_like(gamma)
    M = schur_matrix(Q, A, sqrt_sigma, active, gamma_inv, proximal)
    L_new = cholesky_upper(M.contiguous()).mT
    if L is not None and reuse is not None:
        reuse = torch.as_tensor(reuse, device=dev).reshape(-1, 1, 1)
        L_new = torch.where(reuse, L, L_new)
    d = cho_solve(L_new, neg_dphi)
    if max_refine > 0:
        d = _refine(M, L_new, neg_dphi, d, max_refine)
    return (d[0], L_new[0]) if one else (d, L_new)


def select_factorization_method(Q, A, threshold: float = 2.0) -> int:
    """The reference's KKT-or-Schur cost model (reference: dense.py:144-
    185, qpalm_set_factorization_method of solver_interface.c:20-75), on
    the host: KKT iff (nnz_kkt / nnz_schur_est)^2 n / (n + m) <
    threshold, nnz_schur_est over-estimating the fill of Q + A'A column by
    column.  Q and A dense (numpy) or scipy sparse."""
    if hasattr(Q, "tocsc"):
        Qnnz, n = Q.tocsc().nnz, Q.shape[0]
    else:
        Q = np.asarray(Q)
        Qnnz, n = int(np.count_nonzero(Q)), Q.shape[0]
    if hasattr(A, "tocsc"):
        As = A.tocsc()
        m, Annz, col_counts = As.shape[0], As.nnz, np.diff(As.indptr)
    else:
        As = np.asarray(A)
        m, Annz = As.shape[0], int(np.count_nonzero(As))
        col_counts = np.count_nonzero(As, axis=0)
    nnz_kkt = Qnnz + Annz + m + n  # KKT = [Q + g I, A'; A, -S^-1]
    nnz_schur = Qnnz + int(np.sum(np.minimum(col_counts * Annz / max(m, 1),
                                             n)))
    ratio = (nnz_kkt / max(nnz_schur, 1)) ** 2 * n / max(n + m, 1)
    return C.FACTORIZE_KKT if ratio < threshold else C.FACTORIZE_SCHUR


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
