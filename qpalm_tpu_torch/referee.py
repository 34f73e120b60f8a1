"""Host float64 KKT check of certified lanes (counterpart of the `check`
in qpalm_tpu/polish.py:464-491).

This is the untimed referee: it re-checks, in numpy float64 on the host,
every lane the device polish certified, with the same formulas as the
device check (reference termination.c:44-129 with identity scaling).
"""

from __future__ import annotations

import numpy as np

from . import constants as C


def check(Q, A, q, bmin, bmax, c, x, y, eps_abs=1e-6, eps_rel=1e-6):
    """Unscaled KKT check of stacked float64 numpy arrays.

    Returns (viol, pri_norm, dua_norm, objective), each (B,); a lane is
    certified when viol <= 1."""
    Ax = np.einsum("bmn,bn->bm", A, x)
    z = np.clip(Ax, np.maximum(bmin, -C.QPALM_INFTY),
                np.minimum(bmax, C.QPALM_INFTY))
    pri_norm = np.max(np.abs(Ax - z), axis=1)
    Qx = np.einsum("bij,bj->bi", Q, x)
    Aty = np.einsum("bmn,bm->bn", A, y)
    dua_norm = np.max(np.abs(Qx + q + Aty), axis=1)
    eps_pri = eps_abs + eps_rel * np.maximum(
        np.max(np.abs(Ax), axis=1), np.max(np.abs(z), axis=1)
    )
    eps_dua = eps_abs + eps_rel * np.maximum(
        np.max(np.abs(Qx), axis=1),
        np.maximum(np.max(np.abs(q), axis=1), np.max(np.abs(Aty), axis=1)),
    )
    comp_viol = np.max(
        np.where(y > eps_abs, np.abs(Ax - bmax), 0.0)
        + np.where(y < -eps_abs, np.abs(Ax - bmin), 0.0), axis=1,
    )
    viol = np.maximum(
        np.maximum(pri_norm / eps_pri, dua_norm / eps_dua),
        comp_viol / (eps_pri + eps_abs),
    )
    obj = np.sum((0.5 * Qx + q) * x, axis=1) + c
    return viol, pri_norm, dua_norm, obj


def referee(data, x, y, eps_abs=1e-6, eps_rel=1e-6) -> np.ndarray:
    """ok flags (B,) of the host f64 check for a QPData (any device) and
    solutions x (B, n), y (B, m)."""
    arrs = [np.asarray(t.detach().cpu().double()) for t in data]
    viol = check(*arrs, np.asarray(x.detach().cpu().double()),
                 np.asarray(y.detach().cpu().double()), eps_abs, eps_rel)[0]
    return viol <= 1.0
