"""Batched dense Ruiz equilibration (counterpart of qpalm_tpu/scaling.py:33-86,
reference src/scaling.c:34-113).

The reference scales one problem and is vmapped over the batch
(qpalm_tpu/solver/fused.py:1151-1154); here the batch is the leading
dimension of every tensor.  It runs in the data's dtype: the fused solve
casts to float32 before scaling (fused.py:1150), and so does the port.
Sparse Q and A (linalg.sparse.SparseMatrix, a batch of one) are scaled
entry by entry with the same semantics (qpalm_tpu/scaling.py:33-86).
"""

from __future__ import annotations

import torch

from .constants import MIN_SCALING
from .linalg import sparse as S
from .types import QPData, ScalingInfo


def _limit_scaling(v: torch.Tensor) -> torch.Tensor:
    """Clamp tiny norms to 1 (reference: scaling.c:26-32)."""
    return torch.where(v < MIN_SCALING, torch.ones_like(v), v)


def identity_scaling(B: int, n: int, m: int, dtype, device) -> ScalingInfo:
    one_n = torch.ones((B, n), dtype=dtype, device=device)
    one_m = torch.ones((B, m), dtype=dtype, device=device)
    one = torch.ones((B,), dtype=dtype, device=device)
    return ScalingInfo(D=one_n, Dinv=one_n, E=one_m, Einv=one_m, c=one,
                       cinv=one)


def scale_data(data: QPData, iters: int):
    """Scale a stacked batch (reference: src/scaling.c:34-113).

    Returns (scaled QPData, ScalingInfo).  The cost-scaling norm reads
    Qx = 0, the reference's value at setup (scaling.c:84-89)."""
    Q, A, q, bmin, bmax = data.Q, data.A, data.q, data.bmin, data.bmax
    sparse = S.is_sparse(A)
    D = torch.ones_like(q)
    E = torch.ones_like(bmin)
    for _ in range(iters):
        if sparse:
            col_norms = S.col_inf_norms(A)[None]
            row_norms = S.row_inf_norms(A)[None]
        else:
            col_norms = A.abs().amax(dim=1)
            row_norms = A.abs().amax(dim=2)
        Dt = 1.0 / torch.sqrt(_limit_scaling(col_norms))
        Et = 1.0 / torch.sqrt(_limit_scaling(row_norms))
        if sparse:
            A = S.scale_rows_cols(A, Et[0], Dt[0])
        else:
            A = Et[:, :, None] * A * Dt[:, None, :]
        D = D * Dt
        E = E * Et

    q = D * q
    c = 1.0 / torch.clamp(q.abs().amax(dim=1), min=1.0)
    q = c[:, None] * q
    if sparse:
        Q = S.scale_scalar(S.scale_rows_cols(Q, D[0], D[0]), c[0])
    else:
        Q = c[:, None, None] * (D[:, :, None] * Q * D[:, None, :])
    bmin = E * bmin
    bmax = E * bmax

    scal = ScalingInfo(D=D, Dinv=1.0 / D, E=E, Einv=1.0 / E, c=c,
                       cinv=1.0 / c)
    return QPData(Q=Q, A=A, q=q, bmin=bmin, bmax=bmax, c=data.c), scal
