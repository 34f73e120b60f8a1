"""The plain check that decides `correct`: the KKT conditions of each
answer on its own problem, in numpy float64, judged at the tolerance the
configuration states.  It reads the program's answers only to judge them
and works out everything else from the inputs the benchmark made."""

from __future__ import annotations

import numpy as np

INFTY = 1e20  # bounds at or past this are infinite


def kkt_ratio(Q, A, q, bmin, bmax, x, y, eps_abs, eps_rel):
    """The worst of the primal, dual and complementarity residuals of each
    answer over its tolerance, for stacked problems Q (B, n, n), A (B, m,
    n), q (B, n), bmin, bmax (B, m) and answers x (B, n), y (B, m); an
    answer meets the tolerance where the ratio is at most 1.

    primal:  |Ax - clip(Ax, bmin, bmax)|_inf
             <= eps_abs + eps_rel max(|Ax|_inf, |clip(Ax)|_inf)
    dual:    |Qx + q + A'y|_inf
             <= eps_abs + eps_rel max(|Qx|_inf, |q|_inf, |A'y|_inf)
    complementarity: where y_i > eps_abs, Ax_i lies at bmax_i, and where
             y_i < -eps_abs at bmin_i, within the primal tolerance plus
             eps_abs.
    """
    Q, A, q, bmin, bmax, x, y = (np.asarray(a, np.float64)
                                 for a in (Q, A, q, bmin, bmax, x, y))
    Ax = np.einsum("bmn,bn->bm", A, x)
    lo, hi = np.maximum(bmin, -INFTY), np.minimum(bmax, INFTY)
    z = np.clip(Ax, lo, hi)
    Qx = np.einsum("bij,bj->bi", Q, x)
    Aty = np.einsum("bmn,bm->bn", A, y)
    inf = lambda v: np.max(np.abs(v), axis=1)  # noqa: E731
    eps_pri = eps_abs + eps_rel * np.maximum(inf(Ax), inf(z))
    eps_dua = eps_abs + eps_rel * np.maximum(inf(Qx),
                                             np.maximum(inf(q), inf(Aty)))
    pri = inf(Ax - z) / eps_pri
    dua = inf(Qx + q + Aty) / eps_dua
    comp = np.max(np.where(y > eps_abs, np.abs(Ax - hi), 0.0)
                  + np.where(y < -eps_abs, np.abs(Ax - lo), 0.0),
                  axis=1) / (eps_pri + eps_abs)
    ratio = np.maximum(np.maximum(pri, dua), comp)
    # an answer with a NaN or an infinity meets nothing
    return np.where(np.isfinite(ratio), ratio, np.inf)
