"""Padding and stacking of problem batches (counterpart of
qpalm_tpu/api.py:30-65 and qpalm_tpu/batch.py:206-244).

The padding runs in numpy exactly as in the reference; only the stacked
result becomes torch tensors, on `device`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .types import QPData


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# Padding conventions (neutral w.r.t. the solve — see pad_problem):
_PAD_BOUND = 1e21  # beyond QPALM_INFTY so padded rows count as unconstrained


def _densify(M) -> np.ndarray:
    if hasattr(M, "toarray"):  # scipy sparse
        return np.asarray(M.toarray())
    return np.asarray(M)


def pad_problem(Q, A, q, bmin, bmax, n_pad: int, m_pad: int, dtype):
    """Embed the QP in padded fixed shapes without changing its solution.

    Padded variables get a unit Hessian diagonal and zero gradient (they stay
    exactly 0); padded constraints get zero rows and +-1e21 bounds (beyond
    QPALM_INFTY, so they are inactive and excluded from every infeasibility
    test, reference: termination.c:160-177).
    """
    n, m = Q.shape[0], A.shape[0]
    Qp = np.zeros((n_pad, n_pad), dtype)
    Qp[:n, :n] = Q
    if n_pad > n:
        Qp[range(n, n_pad), range(n, n_pad)] = 1.0
    Ap = np.zeros((m_pad, n_pad), dtype)
    Ap[:m, :n] = A
    qp = np.zeros((n_pad,), dtype)
    qp[:n] = q
    bl = np.full((m_pad,), -_PAD_BOUND, dtype)
    bl[:m] = bmin
    bu = np.full((m_pad,), _PAD_BOUND, dtype)
    bu[:m] = bmax
    return Qp, Ap, qp, bl, bu


def stack_problems(
    problems: Sequence[tuple],
    dtype,
    pad_multiple: int = 8,
    n_pad: Optional[int] = None,
    m_pad: Optional[int] = None,
    device="cpu",
) -> QPData:
    """Pad each (Q, A, q, bmin, bmax[, c]) tuple to a common shape and stack
    into one batched QPData of `dtype` tensors on `device`."""
    sizes = [(_densify(p[0]).shape[0], _densify(p[1]).shape[0])
             for p in problems]
    if n_pad is None:
        n_pad = _round_up(max(s[0] for s in sizes), pad_multiple)
    if m_pad is None:
        m_pad = _round_up(max(max(s[1] for s in sizes), 1), pad_multiple)
    Qs, As, qs, bls, bus, cs = [], [], [], [], [], []
    for p in problems:
        Q, A, q, bmin, bmax = p[:5]
        c = p[5] if len(p) > 5 else 0.0
        Qp, Ap, qp, bl, bu = pad_problem(
            _densify(Q), _densify(A),
            np.asarray(q, float).ravel(),
            np.asarray(bmin, float).ravel(),
            np.asarray(bmax, float).ravel(),
            n_pad, m_pad, dtype,
        )
        Qs.append(Qp)
        As.append(Ap)
        qs.append(qp)
        bls.append(np.maximum(bl, -_PAD_BOUND))
        bus.append(np.minimum(bu, _PAD_BOUND))
        cs.append(c)
    arrays = (np.stack(Qs), np.stack(As), np.stack(qs), np.stack(bls),
              np.stack(bus), np.asarray(cs, dtype))
    return QPData(*(torch.from_numpy(a).to(device) for a in arrays))
