"""Preconditioned conjugate gradients for the semismooth-Newton system
(counterpart of qpalm_tpu/linalg/cg.py:23-72), over a batch.

The large-sparse analogue of the reference's LDL' solve (reference:
newton.c:22-113): instead of factorizing M = Q + (1/gamma) I +
A' diag(sigma * active) A, solve M d = -dphi with preconditioned CG using
only matvecs -- O(nnz) an iteration, no fill, no n x n memory.

The reference runs one `lax.while_loop` a problem; vmapped, the loop runs
until every lane is done and a finished lane keeps its values.  Here the
batch is the leading dimension: every lane takes each step, and a lane
whose residual met its threshold, or that reached `max_iter`, is frozen by
`torch.where` on x, r, z, p, rz and k.  A frozen lane does not change, so
the host reads "is any lane still running" only every `SYNC_STRIDE`
iterations: x and k are those of a check at every step, at one
device-to-host read per SYNC_STRIDE CG steps.

`pcg.calls` and `pcg.steps` count the calls and the steps taken (host
integers), `pcg.iterations` the lanes' iterations (a tensor on the
device, so that counting reads nothing back); set them to 0 to start a
count.
"""

from __future__ import annotations

from typing import Callable

import torch

# CG steps between two reads of the running flags by the host (the
# general loop's stride, solver/core.py)
SYNC_STRIDE = 8


def _dot(a, b):
    return (a * b).sum(-1)


def pcg(matvec: Callable, b: torch.Tensor, precond, tol: torch.Tensor,
        max_iter: int = 250):
    """Solve M x = b for each lane of b (B, n), M SPD, to ||r||_2 <= tol *
    max(||b||_2, 1e-30) (tol (B,)).

    `precond` is either the diagonal of M (B, n) (Jacobi) or a callable
    z = precond(r) applying an SPD preconditioner to (B, n) (the
    block-Jacobi factors of linalg.sparse.block_jacobi_apply).

    Returns (x, final residual norm, iterations), each per lane."""
    if callable(precond):
        apply_p = precond
    else:
        Minv = 1.0 / torch.clamp(precond, min=1e-30)
        apply_p = lambda r: Minv * r  # noqa: E731
    x = torch.zeros_like(b)
    r = b
    z = apply_p(r)
    p = z
    rz = _dot(r, z)
    bnorm = torch.sqrt(_dot(b, b))
    thresh = tol * torch.clamp(bnorm, min=1e-30)
    k = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    step = 0
    while True:
        run = (torch.sqrt(_dot(r, r)) > thresh) & (k < max_iter)
        if step % SYNC_STRIDE == 0 and not bool(run.any()):
            break
        Mp = matvec(p)
        alpha = rz / _dot(p, Mp)
        x_new = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * Mp
        z_new = apply_p(r_new)
        rz_new = _dot(r_new, z_new)
        beta = rz_new / rz
        p_new = z_new + beta[:, None] * p
        keep = run[:, None]
        x = torch.where(keep, x_new, x)
        r = torch.where(keep, r_new, r)
        z = torch.where(keep, z_new, z)
        p = torch.where(keep, p_new, p)
        rz = torch.where(run, rz_new, rz)
        k = k + run.to(torch.int32)
        step += 1
    pcg.calls += 1
    pcg.steps += step
    pcg.iterations = pcg.iterations + k.sum()
    return x, torch.sqrt(_dot(r, r)), k


pcg.calls = pcg.steps = pcg.iterations = 0
