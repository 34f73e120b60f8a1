"""Dense helpers (counterpart of qpalm_tpu/linalg/dense.py:29-53): the
norms that LOBPCG (solver/nonconvex.py) and the general loop
(solver/core.py) take, the three-way clamp and the Gershgorin bound.
Each reduces over the last axes, so a batch (B, n) gives B values.  The
KKT elimination and refinement of that module wait for ROADMAP.md
section 1 item 6.
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
