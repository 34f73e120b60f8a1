"""Dense vector norms (counterpart of qpalm_tpu/linalg/dense.py:29-37).

Only the two norms that LOBPCG (solver/nonconvex.py) needs are ported so
far; the KKT elimination and refinement of that module wait for
ROADMAP.md section 1 item 9.  Both reduce over the last axis, so a batch of
vectors (B, n) gives B norms.
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
