"""Nonconvex handling: minimum-eigenvalue estimation and gamma pinning
(counterpart of qpalm_tpu/solver/nonconvex.py).

The reference (src/nonconvex.c) runs LOBPCG (block size 1) on Q, with
LAPACK dsyev/dsygv for the 2x2 and 3x3 compressed eigenproblems.  The JAX
package vmaps one problem's `lax.while_loop`; here the batch is the
leading axis and the loop runs on tensors until every problem has
converged.  A converged problem is frozen, as the batched while_loop
freezes a lane whose condition is false, and the step is still computed
for it, as vmap's `cond` computes both branches; its small eigenproblems
are replaced by the identity first, so that a frozen lane's degenerate
3x3 block cannot stop `torch.linalg` for the whole batch.  The loop costs
one host synchronisation per trip, to know when to stop.

Two deliberate differences, both for f32, where the reference's bound was
made for the C solver's f64:

- the 3x3 Gram matrix C of [x, w, p] can lose definiteness (p nearly in
  the span of x and w).  The JAX package's Cholesky then returns NaN, the
  eigenvalue estimate becomes NaN and an indefinite problem goes unpinned.
  Here that lane restarts instead, as the iteration starts: from its
  current x, normalized, with a 2x2 Rayleigh-Ritz step on [x, w];
- the exit bound lambda - (sqrt(2) ||w|| + 1e-6) reads a residual built
  from the recurrence for Ax, which drifts from Q x in f32, and its 1e-6
  margin is below f32's resolution of Q's spectrum.  On an H100 it gave a
  BOXQP-d problem (n=64) a pin with lambda_min + 1/gamma = -5.7e-7, and
  K1's Newton Cholesky then returned NaN.  Here the bound is taken from a
  fresh Q x, and batch_gamma_pins lowers it further by n eps ||Q|| (eps
  of the dtype, ||Q|| the Gershgorin bound), about the error of a
  Cholesky of Q + I/gamma in that precision; in f64 that term is below
  1e-12.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import LOBPCG_MAX_ITER, LOBPCG_TOL
from ..linalg.dense import norm_inf, norm_two
from ..linalg.sparse import is_sparse
from ..precision import full_f32_matmul
from ..scaling import scale_data


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _matvec(Q, v: torch.Tensor) -> torch.Tensor:
    """Q v for a dense batch Q (B, n, n), or a SparseMatrix Q and v (1, n)
    (the sparse problem's pin, qpalm_tpu/api.py:190-224)."""
    if is_sparse(Q):
        return Q.mv(v[0])[None]
    return torch.matmul(Q, v[..., None])[..., 0]


def _sym(rows) -> torch.Tensor:
    """A (B, k, k) matrix from k rows of k (B,) tensors."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _solvable(M: torch.Tensor, run: torch.Tensor) -> torch.Tensor:
    """Lanes that run and whose small matrix is finite."""
    return run & torch.isfinite(M).all(-1).all(-1)


def _start(Q, x, Ax, run):
    """The first LOBPCG iteration from a unit x (nonconvex.c:84-101): the
    Rayleigh quotient, then the 2x2 Rayleigh-Ritz step on [x, w] with w the
    residual made orthonormal to x.  Returns (x, Ax, p, Ap, lambda)."""
    lam = _dot(x, Ax)
    w = Ax - lam[:, None] * x
    w = w - _dot(x, w)[:, None] * x
    w = w / norm_two(w)[:, None]
    Aw = _matvec(Q, w)
    xAw = _dot(Aw, x)
    lam, y = _eigh_min(_sym([[lam, xAw], [xAw, _dot(Aw, w)]]), run)
    p = y[:, 1:2] * w
    Ap = y[:, 1:2] * Aw
    return y[:, 0:1] * x + p, y[:, 0:1] * Ax + Ap, p, Ap, lam


def _eigh_min(Bm: torch.Tensor, run: torch.Tensor):
    """Smallest eigenpair of each symmetric (B, 2, 2) block; NaN where a
    running lane's block is not finite, as eigh gives in the reference."""
    ok = _solvable(Bm, run)
    eye = torch.eye(Bm.shape[-1], dtype=Bm.dtype, device=Bm.device)
    w, V = torch.linalg.eigh(torch.where(ok[:, None, None], Bm, eye))
    nan = torch.full_like(w[:, 0], float("nan"))
    return (torch.where(ok, w[:, 0], nan),
            torch.where(ok[:, None], V[..., 0], nan[:, None]))


def _eigh_gen_min(Bm: torch.Tensor, Cm: torch.Tensor, run: torch.Tensor):
    """Smallest eigenpair of each generalized problem B y = lambda C y
    (reference: LAPACKE_dsygv, nonconvex.c:149-153), by the Cholesky
    reduction C = L L', G = L^-1 B L^-T.  Returns (lambda, y, ok); `ok` is
    false where a lane does not run, or its B or C is not finite, or its C
    is not positive definite, and there lambda and y are meaningless."""
    ok = _solvable(Bm, run) & _solvable(Cm, run)
    eye = torch.eye(Bm.shape[-1], dtype=Bm.dtype, device=Bm.device)
    L, info = torch.linalg.cholesky_ex(torch.where(ok[:, None, None], Cm, eye))
    ok = ok & (info == 0)
    L = torch.where(ok[:, None, None], L, eye)
    Bs = torch.where(ok[:, None, None], Bm, eye)
    G = torch.linalg.solve_triangular(L, Bs, upper=False)
    G = torch.linalg.solve_triangular(L, G.mT, upper=False).mT
    w, V = torch.linalg.eigh(G)
    y = torch.linalg.solve_triangular(L.mT, V[..., :1], upper=True)[..., 0]
    return w[:, 0], y, ok


def lobpcg_min_eig(Q: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Estimate the minimum eigenvalue of each symmetric Q (B, n, n).

    Mirrors reference nonconvex.c:29-168: a 3-vector LOBPCG ([x, w, p]
    subspace) with the reference's exit adjustment lambda -= sqrt(2)*||w||_2
    + 1e-6 as a safe lower bound.  `x0` (B, n) holds the normalized initial
    eigenvector guesses.  Q may be a SparseMatrix with x0 (1, n).  Returns
    (B,) in Q's dtype."""
    full_f32_matmul()
    n = Q.shape[-1]
    everyone = torch.ones(x0.shape[0], dtype=torch.bool, device=x0.device)
    x, Ax, p, Ap, lam = _start(Q, x0, _matvec(Q, x0), everyone)

    converged = torch.zeros_like(everyone)
    one = torch.ones_like(lam)
    zero = torch.zeros_like(lam)
    for _ in range(LOBPCG_MAX_ITER):
        active = ~converged
        if not bool(active.any()):
            break
        w = Ax - lam[:, None] * x
        now = norm_inf(w) < LOBPCG_TOL
        take = active & ~now

        w = w - _dot(x, w)[:, None] * x
        w = w / norm_two(w)[:, None]
        Aw = _matvec(Q, w)
        p_norm_inv = 1.0 / norm_two(p)
        pn = p * p_norm_inv[:, None]
        Apn = Ap * p_norm_inv[:, None]
        xAw, wAw = _dot(Ax, w), _dot(w, Aw)
        xAp, wAp, pAp = _dot(Ax, pn), _dot(Aw, pn), _dot(Apn, pn)
        xp, wp = _dot(x, pn), _dot(w, pn)
        Bm = _sym([[lam, xAw, xAp], [xAw, wAw, wAp], [xAp, wAp, pAp]])
        Cm = _sym([[one, zero, xp], [zero, one, wp], [xp, wp, one]])
        lam_new, y, ok = _eigh_gen_min(Bm, Cm, take)
        p_new = y[:, 2:3] * pn + y[:, 1:2] * w
        Ap_new = y[:, 2:3] * Apn + y[:, 1:2] * Aw
        new = (x * y[:, 0:1] + p_new, Ax * y[:, 0:1] + Ap_new, p_new,
               Ap_new, lam_new)
        # a running lane whose C is not definite restarts from its x
        restart = take & ~ok
        if bool(restart.any()):
            norm = norm_two(x)[:, None]
            again = _start(Q, x / norm, Ax / norm, restart)
            new = tuple(torch.where(restart if a.dim() == 1
                                    else restart[:, None], a, b)
                        for a, b in zip(again, new))
        x, Ax, p, Ap, lam = (
            torch.where(take if a.dim() == 1 else take[:, None], a, b)
            for a, b in zip(new, (x, Ax, p, Ap, lam)))
        converged = torch.where(active, now, converged)

    # theoretical bound on exit (nonconvex.c:117-121), converged or not,
    # from a fresh residual, with room for the working precision
    x = x / norm_two(x)[:, None]
    Ax = _matvec(Q, x)
    lam = _dot(x, Ax)
    w = Ax - lam[:, None] * x
    lam_out = lam - (math.sqrt(2.0) * norm_two(w) + 1e-6)
    if n <= 3:
        lam_out = lam_out - 1e-6
    return lam_out


def batch_gamma_pins(data, settings):
    """Per-problem nonconvex gamma pins for a stacked batch (reference:
    nonconvex.c:171-183 applied per problem).

    LOBPCG runs on each problem's *scaled* Q (the reference pins gamma
    after scaling, qpalm.c:294-296), from the start vectors the JAX package
    draws: numpy's default_rng(0), cast to the data's dtype and normalized
    in numpy.  Returns (gamma_init (B,), gamma_max (B,)) on the data's
    device: problems with lambda_min < 0 get gamma_init = gamma_max =
    1/|lambda_min| (every subproblem convex); convex ones keep the settings'
    defaults."""
    B, n_pad = data.q.shape
    dtype = data.q.dtype
    sQ = scale_data(data, settings.scaling)[0].Q if settings.scaling \
        else data.Q
    v0 = np.random.default_rng(0).random((B, n_pad)).astype(
        {torch.float32: np.float32, torch.float64: np.float64}[dtype])
    v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    lams = lobpcg_min_eig(sQ, torch.from_numpy(v0).to(data.q.device))
    # room for the working precision: Q + I/gamma must stay factorable
    lams = lams - n_pad * torch.finfo(dtype).eps * sQ.abs().sum(-1).amax(-1)
    neg = lams < 0
    pins = 1.0 / lams.abs()
    gamma_init = torch.where(neg, pins, settings.gamma_init).to(dtype)
    gamma_max = torch.where(neg, pins, settings.gamma_max).to(dtype)
    return gamma_init, gamma_max


def min_eig_settings(lam: float, settings):
    """Adjust settings for a nonconvex QP (reference: nonconvex.c:171-183).

    If lambda_min < 0 the proximal penalty is pinned to 1/|lambda_min| so
    every subproblem is convex; otherwise the problem is treated as convex.
    Host-side: returns a new Settings.
    """
    if lam < 0:
        return settings.replace(
            proximal=True,
            gamma_init=1.0 / abs(lam),
            gamma_max=1.0 / abs(lam),
        )
    return settings.replace(nonconvex=False)


def lobpcg_min_eig_np(matvec, n: int, seed: int = 0) -> float:
    """Matrix-free numpy LOBPCG for the host sparse path (reference
    nonconvex.c:29-168 run on scipy matrices), as the JAX package has it.

    `matvec` maps a (n,) vector to Q @ v.  Returns the reference's safe
    lower bound lambda - (sqrt(2) ||w||_2 + 1e-6) on the minimum
    eigenvalue, so Q + (1/|lambda|) I stays strictly PD when pinned.
    """
    import scipy.linalg as sla

    rng = np.random.default_rng(seed)
    if n <= 3:
        # LOBPCG's 3-vector subspace degenerates at n <= 3 (the reference
        # special-cases these too); the dense eigensolve is trivial here
        cols = [matvec(np.eye(n)[:, j]) for j in range(n)]
        return float(np.linalg.eigvalsh(np.column_stack(cols))[0]) - 1e-6

    x = rng.random(n)
    x /= np.linalg.norm(x)
    Ax = matvec(x)
    lam = float(x @ Ax)

    # first iteration: 2x2 standard eigenproblem (nonconvex.c:84-101)
    w = Ax - lam * x
    w = w - (x @ w) * x
    nw = np.linalg.norm(w)
    if nw == 0.0:
        return lam - 1e-6
    w /= nw
    Aw = matvec(w)
    B2 = np.array([[lam, Aw @ x], [Aw @ x, Aw @ w]])
    w2, V2 = np.linalg.eigh(B2)
    lam = float(w2[0])
    y = V2[:, 0]
    p = y[1] * w
    Ap = y[1] * Aw
    x = y[0] * x + p
    Ax = y[0] * Ax + Ap

    for _ in range(LOBPCG_MAX_ITER):
        w = Ax - lam * x
        if np.abs(w).max() < LOBPCG_TOL:
            break
        w = w - (x @ w) * x
        nw = np.linalg.norm(w)
        if nw == 0.0:
            break
        w /= nw
        Aw = matvec(w)
        pn = np.linalg.norm(p)
        if pn == 0.0:
            break
        p = p / pn
        Ap = Ap / pn
        B = np.array([
            [lam, Ax @ w, Ax @ p],
            [Ax @ w, w @ Aw, Aw @ p],
            [Ax @ p, Aw @ p, Ap @ p],
        ])
        Cm = np.eye(3)
        Cm[0, 2] = Cm[2, 0] = x @ p
        Cm[1, 2] = Cm[2, 1] = w @ p
        try:
            ww, VV = sla.eigh(B, Cm)
        except (np.linalg.LinAlgError, ValueError):
            # Cm ill-conditioned: restart the p direction
            p = np.zeros(n)
            Ap = np.zeros(n)
            continue
        lam = float(ww[0])
        y = VV[:, 0]
        p = y[2] * p + y[1] * w
        Ap = y[2] * Ap + y[1] * Aw
        x = y[0] * x + p
        Ax = y[0] * Ax + Ap

    w = Ax - lam * x
    return lam - (float(np.sqrt(2.0) * np.linalg.norm(w)) + 1e-6)
