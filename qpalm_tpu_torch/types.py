"""Core data types of the PyTorch port (counterpart of qpalm_tpu/types.py).

`Settings` keeps the reference package's fields and defaults, so a settings
object moves between the two packages field by field (`settings_from`).
`QPData`, `ScalingInfo` and `SolverState` hold batch-first torch tensors:
every field has the batch as its leading dimension.  `Info`, `Solution`
and `SolveResult` are the results of one solve (api.QPALM), on the host
but for the final state.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import constants as C


@dataclasses.dataclass(frozen=True)
class Settings:
    """Solver settings (reference: include/types.h:119-150, defaults
    constants.h:65-110), field for field those of qpalm_tpu.Settings."""

    max_iter: int = C.MAX_ITER
    inner_max_iter: int = C.INNER_MAX_ITER
    eps_abs: float = C.EPS_ABS
    eps_rel: float = C.EPS_REL
    eps_abs_in: float = C.EPS_ABS_IN
    eps_rel_in: float = C.EPS_REL_IN
    rho: float = C.RHO
    eps_prim_inf: float = C.EPS_PRIM_INF
    eps_dual_inf: float = C.EPS_DUAL_INF
    theta: float = C.THETA
    delta: float = C.DELTA
    sigma_max: float = C.SIGMA_MAX
    sigma_init: float = C.SIGMA_INIT
    proximal: bool = C.PROXIMAL
    gamma_init: float = C.GAMMA_INIT
    gamma_upd: float = C.GAMMA_UPD
    gamma_max: float = C.GAMMA_MAX
    scaling: int = C.SCALING
    nonconvex: bool = C.NONCONVEX
    warm_start: bool = C.WARM_START
    verbose: bool = C.VERBOSE
    print_iter: int = C.PRINT_ITER
    reset_newton_iter: int = C.RESET_NEWTON_ITER
    enable_dual_termination: bool = C.ENABLE_DUAL_TERMINATION
    dual_objective_limit: float = C.DUAL_OBJECTIVE_LIMIT
    time_limit: float = C.TIME_LIMIT
    ordering: int = 0
    factorization_method: int = C.FACTORIZATION_METHOD
    max_rank_update: int = C.MAX_RANK_UPDATE
    max_rank_update_fraction: float = C.MAX_RANK_UPDATE_FRACTION
    max_refine: int = C.MAX_REFINEMENT_ITERATIONS
    dtype: str = "float64"
    refine_fp64: bool = False
    linesearch: str = "auto"
    cg_tol: float = C.CG_TOL
    cg_max_iter: int = C.CG_MAX_ITER
    cg_precond: str = "jacobi"
    cg_block: int = 64
    stage_block: int = 0
    use_fused: str = "auto"
    unroll: int = 1
    residuals_fp64: bool = False

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)


def settings_from(obj) -> Settings:
    """The port's Settings built from any object carrying the same fields
    (for example a qpalm_tpu.Settings)."""
    return Settings(**{f.name: getattr(obj, f.name)
                       for f in dataclasses.fields(Settings)})


class QPData(NamedTuple):
    """Stacked problem data, batch first.

    minimize 0.5 x'Qx + q'x + c   s.t.  bmin <= A x <= bmax
    """

    Q: torch.Tensor     # (B, n, n) symmetric
    A: torch.Tensor     # (B, m, n)
    q: torch.Tensor     # (B, n)
    bmin: torch.Tensor  # (B, m)
    bmax: torch.Tensor  # (B, m)
    c: torch.Tensor     # (B,)

    @property
    def n(self) -> int:
        return self.Q.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]


class ScalingInfo(NamedTuple):
    """Ruiz equilibration output, batch first."""

    D: torch.Tensor     # (B, n) primal scaling
    Dinv: torch.Tensor
    E: torch.Tensor     # (B, m) dual scaling
    Einv: torch.Tensor
    c: torch.Tensor     # (B,) cost scaling
    cinv: torch.Tensor


def qpdata_from_numpy(Q, A, q, bmin, bmax, c, device) -> QPData:
    """Turn stacked numpy arrays (for example the fields of the JAX
    package's QPData after np.asarray) into the port's QPData on `device`,
    keeping their dtype."""
    return QPData(*(torch.as_tensor(np.array(a), device=device)
                    for a in (Q, A, q, bmin, bmax, c)))


class SolverState(NamedTuple):
    """State of the general solver loop (solver/core.py), field for field
    the reference's SolverState (qpalm_tpu/types.py:145-215, the functional
    QPALMWorkspace, reference include/types.h:197-314), batch first: each
    (n,) or (m,) vector of the reference is (B, n) or (B, m) here, each
    scalar (B,), the cached factor L (B, n, n)."""

    x: torch.Tensor  # scaled primal iterate
    y: torch.Tensor  # scaled dual iterate
    x0: torch.Tensor  # proximal center
    x_prev: torch.Tensor
    Qx: torch.Tensor  # Q x (+ x/gamma when proximal)
    Ax: torch.Tensor
    Aty: torch.Tensor
    Axys: torch.Tensor  # Ax + y/sigma
    z: torch.Tensor  # clamp(Axys, bmin, bmax)
    pri_res: torch.Tensor  # Ax - z
    pri_res_in: torch.Tensor  # pri_res at the last outer update
    yh: torch.Tensor  # candidate dual y + sigma * pri_res
    Atyh: torch.Tensor
    df: torch.Tensor  # gradient of f
    dphi: torch.Tensor  # gradient of phi
    dphi_prev: torch.Tensor
    d: torch.Tensor  # Newton direction
    Qd: torch.Tensor  # after the update: tau (Qd [+ d/gamma])
    Ad: torch.Tensor  # after the update: tau Ad
    tau: torch.Tensor  # step
    active: torch.Tensor  # bool
    active_old: torch.Tensor  # bool
    nb_enter: torch.Tensor  # int32
    nb_leave: torch.Tensor  # int32
    L: torch.Tensor  # cached upper Cholesky factor of the Schur matrix
    factor_valid: torch.Tensor  # bool: L matches (active, sigma, gamma)
    gersh: torch.Tensor  # Gershgorin bound of A' diag(sigma active) A
    sigma: torch.Tensor
    sigma_inv: torch.Tensor
    sqrt_sigma: torch.Tensor
    gamma: torch.Tensor
    gamma_maxed: torch.Tensor  # bool
    gamma_max: torch.Tensor  # per problem: the nonconvex pins
    eps_abs_in: torch.Tensor
    eps_rel_in: torch.Tensor
    eps_k_abs: torch.Tensor  # nonconvex proximal-center tolerances
    eps_k_rel: torch.Tensor
    pri_res_norm: torch.Tensor
    dua_res_norm: torch.Tensor
    dua2_res_norm: torch.Tensor
    eps_pri: torch.Tensor
    eps_dua: torch.Tensor
    eps_dua_in: torch.Tensor
    delta_y: torch.Tensor  # infeasibility certificates
    delta_x: torch.Tensor
    iter: torch.Tensor  # int32
    iter_out: torch.Tensor
    prev_iter: torch.Tensor
    no_change: torch.Tensor  # iterations without an active-set change
    done: torch.Tensor  # bool
    status: torch.Tensor  # int32
    dual_objective: torch.Tensor


def solverstate_from_numpy(state, device) -> SolverState:
    """The port's SolverState from a batched reference SolverState (any
    object with its fields as arrays, for example the JAX package's state
    after np.asarray of each field), on `device`, keeping every dtype."""
    return SolverState(*(torch.as_tensor(np.array(getattr(state, f)),
                                         device=device)
                         for f in SolverState._fields))


class Info(NamedTuple):
    """Result info of one solve (reference: include/types.h:76-95
    QPALMInfo), host numbers read off the device in one copy."""

    iter: int
    iter_out: int
    status_val: int
    pri_res_norm: float
    dua_res_norm: float
    dua2_res_norm: float
    objective: float
    dual_objective: float
    setup_time: float = 0.0
    solve_time: float = 0.0
    run_time: float = 0.0

    @property
    def status(self) -> str:
        try:
            return C.STATUS_STRINGS[int(self.status_val)]
        except (TypeError, KeyError):
            return "unknown"


class Solution(NamedTuple):
    """Unscaled solution (reference: include/types.h QPALMSolution), host
    float64 numpy arrays."""

    x: np.ndarray
    y: np.ndarray


class SolveResult(NamedTuple):
    solution: Solution
    info: Info
    # infeasibility certificates (unscaled), host float64 numpy arrays
    delta_x: np.ndarray
    delta_y: np.ndarray
    # the final internal state (scaled), a batch of one left on the device
    state: Optional[SolverState] = None
