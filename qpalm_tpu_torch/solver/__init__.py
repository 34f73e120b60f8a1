"""Solver loops of the port: kernel K1 (the fused P-ALM iteration,
solver/fused.py), the general loop (solver/core.py), its linesearch and
the nonconvex gamma pins (LOBPCG), exported under the reference's names
(qpalm_tpu/solver/__init__.py)."""

from .core import (compute_dual_objective, compute_objective,
                   compute_residuals, init_state, solve_from_state)
from .linesearch import exact_linesearch
from .nonconvex import lobpcg_min_eig, min_eig_settings

__all__ = [
    "init_state",
    "solve_from_state",
    "compute_residuals",
    "compute_objective",
    "compute_dual_objective",
    "exact_linesearch",
    "lobpcg_min_eig",
    "min_eig_settings",
]
