"""Input validation (reference: src/validate.c:18-221), a copy of
qpalm_tpu/validate.py: it reads shapes and settings only, on the host."""

from __future__ import annotations

import numpy as np

from . import constants as C


class ValidationError(ValueError):
    pass


def validate_data(Q, A, q, bmin, bmax):
    """reference: validate.c:18-40 plus basic shape checks the C API gets for
    free from its struct layout.  Accepts dense arrays or scipy sparse
    matrices (only shapes are inspected on the matrices)."""
    if not hasattr(Q, "tocoo"):
        Q = np.asarray(Q)
    if not hasattr(A, "tocoo"):
        A = np.asarray(A)
    q = np.asarray(q)
    bmin = np.asarray(bmin)
    bmax = np.asarray(bmax)
    if Q.ndim != 2 or Q.shape[0] != Q.shape[1]:
        raise ValidationError("Q must be square")
    n = Q.shape[0]
    if A.ndim != 2 or A.shape[1] != n:
        raise ValidationError("A must be m x n")
    m = A.shape[0]
    if q.shape != (n,):
        raise ValidationError("q must have length n")
    if bmin.shape != (m,) or bmax.shape != (m,):
        raise ValidationError("bmin/bmax must have length m")
    if np.any(bmin > bmax):
        j = int(np.argmax(bmin > bmax))
        raise ValidationError(
            f"Lower bound at index {j} is greater than upper bound: "
            f"{bmin[j]:.4e} > {bmax[j]:.4e}"
        )
    return n, m


def validate_settings(s):
    """reference: validate.c:43-221 — every range check, same bounds."""
    def chk(cond, msg):
        if not cond:
            raise ValidationError(msg)

    chk(s.max_iter > 0, "max_iter must be positive")
    chk(s.inner_max_iter > 0, "inner_max_iter must be positive")
    chk(s.eps_abs >= 0, "eps_abs must be nonnegative")
    chk(s.eps_rel >= 0, "eps_rel must be nonnegative")
    chk(s.eps_abs + s.eps_rel > 0, "eps_abs and eps_rel cannot both be zero")
    chk(s.eps_abs_in >= 0, "eps_abs_in must be nonnegative")
    chk(s.eps_rel_in >= 0, "eps_rel_in must be nonnegative")
    chk(s.eps_abs_in + s.eps_rel_in > 0,
        "eps_abs_in and eps_rel_in cannot both be zero")
    chk(0 < s.rho < 1, "rho must be in (0,1)")
    chk(s.eps_prim_inf >= 0, "eps_prim_inf must be nonnegative")
    chk(s.eps_dual_inf >= 0, "eps_dual_inf must be nonnegative")
    chk(0 <= s.theta <= 1, "theta must be in [0,1]")
    chk(s.delta > 1, "delta must be greater than 1")
    chk(s.sigma_max > 0, "sigma_max must be positive")
    chk(s.sigma_init > 0, "sigma_init must be positive")
    chk(s.proximal in (True, False, 0, 1), "proximal must be boolean")
    chk(s.gamma_init > 0, "gamma_init must be positive")
    chk(s.gamma_upd >= 1, "gamma_upd must be >= 1")
    chk(s.gamma_max >= s.gamma_init, "gamma_max must be >= gamma_init")
    chk(s.scaling >= 0, "scaling must be nonnegative")
    chk(s.nonconvex in (True, False, 0, 1), "nonconvex must be boolean")
    chk(s.warm_start in (True, False, 0, 1), "warm_start must be boolean")
    chk(s.verbose in (True, False, 0, 1), "verbose must be boolean")
    chk(s.print_iter > 0, "print_iter must be positive")
    chk(s.reset_newton_iter > 0, "reset_newton_iter must be positive")
    chk(s.enable_dual_termination in (True, False, 0, 1),
        "enable_dual_termination must be boolean")
    chk(s.time_limit > 0, "time_limit must be positive")
    chk(s.max_rank_update > 0, "max_rank_update must be positive")
    chk(0 <= s.max_rank_update_fraction <= 1,
        "max_rank_update_fraction must be in [0,1]")
    chk(s.linesearch in ("auto", "sort", "bisect"),
        "linesearch must be 'auto', 'sort' or 'bisect'")
    chk(s.factorization_method in (
        C.FACTORIZE_KKT, C.FACTORIZE_SCHUR, C.FACTORIZE_KKT_OR_SCHUR,
        C.FACTORIZE_CG, C.FACTORIZE_STAGE,
    ), "invalid factorization_method")
    if s.factorization_method == C.FACTORIZE_STAGE:
        chk(s.stage_block > 0,
            "FACTORIZE_STAGE requires stage_block = nx + nu > 0")
    chk(s.dtype in ("float64", "float32"), "dtype must be float64 or float32")
    chk(s.cg_tol > 0, "cg_tol must be positive")
    chk(s.cg_max_iter > 0, "cg_max_iter must be positive")
    chk(s.unroll >= 1, "unroll must be >= 1")
    return True
