"""Dense linear algebra of the port: kernel K2 (batched Cholesky,
linalg/chol.py) and the helpers of linalg/dense.py, exported under the
reference's names (qpalm_tpu/linalg/__init__.py)."""

from .dense import (cho_solve, cholesky_shifted, gershgorin_max,
                    newton_solve_kkt, newton_solve_schur, norm_inf, norm_two,
                    vec_mid)

__all__ = [
    "norm_inf",
    "norm_two",
    "vec_mid",
    "gershgorin_max",
    "cholesky_shifted",
    "cho_solve",
    "newton_solve_schur",
    "newton_solve_kkt",
]
