"""The general P-ALM solve loop (counterpart of qpalm_tpu/solver/core.py,
reference src/qpalm.c:401-736 with src/iteration.c, newton.c and
termination.c), as one batched PyTorch loop at float32 and float64.

The reference writes the loop for one problem and vmaps it: its
`lax.switch` over the four branches of an iteration and its `lax.cond`s
lower under vmap to selects, where every branch runs.  Here the batch is
the leading dimension of every tensor, each branch runs on the whole
batch, and per-problem `torch.where` masks pick each field of the state.
A branch that leaves a field as it was returns the same tensor, and the
select skips it.  A finished problem (done, or at the iteration limit) is
frozen: every field keeps its exact value, as the vmapped while_loop
keeps a stopped lane's.  So the host reads the `done` flags only every
`SYNC_STRIDE` iterations; the iterations past the last problem's end
change nothing.

The SCHUR path of the Newton step: M = Q + A' diag(sigma active) A +
I/gamma is assembled with `torch.bmm` at full float32
(`precision.full_f32_matmul`), factored by kernel K2a and solved by K2b
(linalg/chol.py: on the card the CUDA kernels, on the CPU their twins).
M is factored for every problem and then selected by the per-problem
`reuse` flag, as the vmapped reference does.  FACTORIZE_KKT eliminates
the quasi-definite block (`linalg.dense.newton_solve_kkt`, K2 on the
result) on every iteration, without refinement, as the reference does.
FACTORIZE_CG solves the Newton system matrix-free with preconditioned CG
(linalg/cg.py), Jacobi or block-Jacobi (the blocks factored and solved by
K2), on dense batches and on the sparse problem of `api.QPALM(sparse=
True)` (linalg.sparse.SparseMatrix Q and A, a batch of one; `_mv` and
`_mtv` are the one place that tells the two apart).  FACTORIZE_STAGE
assembles M as SCHUR does and solves it by block Thomas on its stage
blocks (parallel/block_tridiag.py, K2 a stage), refactored every
iteration and never refined, as the reference does.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..linalg import sparse as S
from ..linalg.cg import pcg
from ..linalg.chol import cholesky_solve, cholesky_upper
from ..linalg.dense import gershgorin_max, newton_solve_kkt, norm_inf, \
    vec_mid
from ..precision import full_f32_matmul
from ..scaling import identity_scaling, scale_data
from ..types import QPData, ScalingInfo, Settings, SolverState
from .linesearch import exact_linesearch

# iterations between two reads of the done flags by the host
SYNC_STRIDE = 8

_I32 = torch.int32


def _one(v):
    if v.shape[0] != 1:
        raise ValueError(f"sparse data holds one problem, got a batch of "
                         f"{v.shape[0]}")
    return v[0]


def _mv(M, v):
    """Batched matrix-vector product M v: (B, r, c) x (B, c) -> (B, r), or
    a SparseMatrix (r, c) times (1, c)."""
    if S.is_sparse(M):
        return M.mv(_one(v))[None]
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _mtv(M, v):
    """Batched M' v: (B, r, c) x (B, r) -> (B, c), or a SparseMatrix's
    transpose times (1, r)."""
    if S.is_sparse(M):
        return M.tmv(_one(v))[None]
    return torch.matmul(M.transpose(-1, -2), v.unsqueeze(-1)).squeeze(-1)


def _dot(a, b):
    return (a * b).sum(-1)


def _bc(mask, t):
    """A (B,) mask shaped to broadcast against t."""
    return mask.view(mask.shape + (1,) * (t.dim() - 1))


def _sel(mask, a, b):
    """Per problem: a where mask, else b (b unchanged if a is b)."""
    if a is b:
        return a
    return torch.where(_bc(mask, a), a, b)


def _select_state(mask, a: SolverState, b: SolverState) -> SolverState:
    return SolverState(*(_sel(mask, x, y) for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# state construction / warm start (core.py:40-160)
# ---------------------------------------------------------------------------

def init_state(data: QPData, scal: ScalingInfo, settings: Settings,
               x_ws=None, y_ws=None, gamma_init=None,
               gamma_max=None) -> SolverState:
    """Initial state (qpalm_warm_start, reference qpalm.c:322-399).
    `x_ws`/`y_ws` are unscaled (B, n) / (B, m) warm starts or None;
    `gamma_init`/`gamma_max` optional per-problem (B,) overrides of the
    settings (the nonconvex pins)."""
    Q, A = data.Q, data.A
    B, n = data.q.shape
    stage = settings.factorization_method == C.FACTORIZE_STAGE
    if stage and n % settings.stage_block:
        raise ValueError(f"FACTORIZE_STAGE: n = {n} is not a multiple of "
                         f"stage_block = {settings.stage_block}")
    m = data.bmin.shape[1]
    dtype, dev = Q.dtype, Q.device
    kw = dict(dtype=dtype, device=dev)

    def per_lane(v, default):
        if v is None:
            return torch.full((B,), default, **kw)
        return torch.as_tensor(v).to(**kw).reshape(B)

    gamma = per_lane(gamma_init, settings.gamma_init)
    gmax = per_lane(gamma_max, settings.gamma_max)
    fn = lambda k: torch.zeros((B, k), **kw)  # noqa: E731
    if x_ws is not None:
        x = torch.as_tensor(x_ws).to(**kw) * scal.Dinv
        Qx = _mv(Q, x)
        if settings.proximal:
            Qx = Qx + x / gamma[:, None]
        Ax = _mv(A, x)
    else:
        x, Qx, Ax = fn(n), fn(n), fn(m)
    if y_ws is not None:
        y = torch.as_tensor(y_ws).to(**kw) * scal.Einv * scal.c[:, None]
    else:
        y = fn(m)

    # initialize_sigma (iteration.c:50-84): f reads the workspace Qx, which
    # holds the x/gamma term when proximal
    f = 0.5 * _dot(x, Qx) + _dot(data.q, x)
    dist = Ax - vec_mid(Ax, data.bmin, data.bmax)
    dist2 = _dot(dist, dist)
    sig0 = torch.clamp(settings.sigma_init * torch.clamp(f.abs(), min=1.0)
                       / torch.clamp(0.5 * dist2, min=1.0), 1e-4, 1e4)
    sigma = torch.ones((B, m), **kw) * sig0[:, None]

    s0 = torch.zeros((B,), **kw)
    i0 = torch.zeros((B,), dtype=_I32, device=dev)
    f0 = torch.zeros((B,), dtype=torch.bool, device=dev)
    full = lambda v: torch.full((B,), v, **kw)  # noqa: E731
    return SolverState(
        x=x, y=y, x0=x, x_prev=x, Qx=Qx, Ax=Ax, Aty=fn(n), Axys=fn(m),
        z=fn(m), pri_res=fn(m), pri_res_in=fn(m), yh=fn(m), Atyh=fn(n),
        df=fn(n), dphi=fn(n), dphi_prev=fn(n), d=fn(n), Qd=fn(n), Ad=fn(m),
        tau=s0,
        active=torch.zeros((B, m), dtype=torch.bool, device=dev),
        active_old=torch.zeros((B, m), dtype=torch.bool, device=dev),
        nb_enter=i0, nb_leave=i0,
        # CG and STAGE never cache a factor: a dummy 1 x 1 keeps the state
        # O(n) (a large sparse problem must not allocate n x n;
        # core.py:125-132)
        L=torch.zeros((B, 1, 1) if stage or settings.factorization_method
                      == C.FACTORIZE_CG else (B, n, n), **kw),
        factor_valid=f0, gersh=s0,
        sigma=sigma, sigma_inv=1.0 / sigma, sqrt_sigma=torch.sqrt(sigma),
        gamma=gamma,
        gamma_maxed=torch.full((B,), bool(settings.nonconvex),
                               dtype=torch.bool, device=dev),
        gamma_max=gmax,
        eps_abs_in=full(settings.eps_abs_in),
        eps_rel_in=full(settings.eps_rel_in),
        eps_k_abs=full(settings.eps_abs_in),
        eps_k_rel=full(settings.eps_rel_in),
        pri_res_norm=s0, dua_res_norm=s0, dua2_res_norm=s0, eps_pri=s0,
        eps_dua=s0, eps_dua_in=s0,
        delta_y=fn(m), delta_x=fn(n),
        iter=i0, iter_out=i0, prev_iter=i0, no_change=i0, done=f0,
        status=torch.full((B,), C.QPALM_UNSOLVED, dtype=_I32, device=dev),
        dual_objective=s0,
    )


# ---------------------------------------------------------------------------
# per-iteration math (core.py:163-314)
# ---------------------------------------------------------------------------

class _Wide:
    """Float64 copies of the data for `residuals_fp64` / `refine_fp64`
    (made once a solve: the reference casts the same values each
    iteration)."""

    def __init__(self, data: QPData):
        self.Q, self.A, self.q, self.bmin, self.bmax = (
            t.double() for t in data[:5])


def compute_residuals(st: SolverState, data: QPData, settings: Settings,
                      wide: _Wide = None) -> SolverState:
    """iteration.c:24-48 (core.py:167-208).  With `residuals_fp64` at
    float32 every quantity is evaluated in float64 from fresh matvecs and
    stored back in float32."""
    dtype = st.x.dtype
    hp = settings.residuals_fp64 and dtype == torch.float32
    if hp:
        wide = wide or _Wide(data)
        x = st.x.double()
        Qx = _mv(wide.Q, x)
        if settings.proximal:
            Qx = Qx + x / st.gamma.double()[:, None]
        Ax = _mv(wide.A, x)
        st = st._replace(Qx=Qx.to(dtype), Ax=Ax.to(dtype))
        q, bmin, bmax, A = wide.q, wide.bmin, wide.bmax, wide.A
        cast = lambda t: t.double()  # noqa: E731
    else:
        Qx, Ax = st.Qx, st.Ax
        q, bmin, bmax, A = data.q, data.bmin, data.bmax, data.A
        cast = lambda t: t  # noqa: E731
    y = cast(st.y)
    Axys = Ax + y * cast(st.sigma_inv)
    z = vec_mid(Axys, bmin, bmax)
    pri_res = Ax - z
    yh = y + pri_res * cast(st.sigma)
    df = Qx + q
    if settings.proximal:
        df = df - cast(st.x0) / cast(st.gamma)[:, None]
    Atyh = _mtv(A, yh)
    dphi = df + Atyh
    return st._replace(Axys=Axys.to(dtype), z=z.to(dtype),
                       pri_res=pri_res.to(dtype), yh=yh.to(dtype),
                       df=df.to(dtype), Atyh=Atyh.to(dtype),
                       dphi=dphi.to(dtype))


def update_sigma(st: SolverState, settings: Settings, enabled):
    """Per-constraint penalty boosts (iteration.c:86-145); a change
    invalidates the cached factor."""
    pri_norm = norm_inf(st.pri_res)
    cond = (enabled[:, None]
            & (st.pri_res.abs() > settings.theta * st.pri_res_in.abs())
            & st.active)
    mult = torch.clamp(settings.delta * st.pri_res.abs()
                       / (pri_norm[:, None] + 1e-6), min=1.0)
    sig_tmp = torch.clamp(mult * st.sigma, max=settings.sigma_max)
    new_sigma = torch.where(cond, sig_tmp, st.sigma)
    changed = (new_sigma != st.sigma).any(-1)
    return st._replace(sigma=new_sigma, sigma_inv=1.0 / new_sigma,
                       sqrt_sigma=torch.sqrt(new_sigma),
                       factor_valid=st.factor_valid & ~changed)


def _apply_gamma_change(st: SolverState, new_gamma) -> SolverState:
    """Qx/Qd fixups when gamma changes (iteration.c:153,206-210)."""
    changed = new_gamma != st.gamma
    diff = (1.0 / new_gamma - 1.0 / st.gamma)[:, None]
    Qx = torch.where(changed[:, None], st.Qx + diff * st.x, st.Qx)
    Qd = torch.where(changed[:, None], st.Qd + st.tau[:, None] * diff * st.d,
                     st.Qd)
    return st._replace(gamma=new_gamma, Qx=Qx, Qd=Qd,
                       factor_valid=st.factor_valid & ~changed)


def _stepped_gamma(st: SolverState, settings: Settings):
    upd = st.gamma < st.gamma_max
    return upd, torch.where(
        upd, torch.minimum(st.gamma * settings.gamma_upd, st.gamma_max),
        st.gamma)


def update_gamma(st: SolverState, settings: Settings) -> SolverState:
    """iteration.c:147-156: fixes Qx, not Qd, as the reference does."""
    upd, new_gamma = _stepped_gamma(st, settings)
    diff = (1.0 / new_gamma - 1.0 / st.gamma)[:, None]
    Qx = torch.where(upd[:, None], st.Qx + diff * st.x, st.Qx)
    return st._replace(gamma=new_gamma, Qx=Qx,
                       factor_valid=st.factor_valid & ~upd)


def _boost_gamma_values(st: SolverState, active2, settings: Settings):
    """gamma after a boost (iteration.c:158-205): on the Schur path from
    the Gershgorin bound cached at the last factorization, on the KKT path
    a flat 1e10 (the reference disables its estimate there,
    iteration.c:174-182)."""
    nb_active = active2.sum(-1)
    if settings.factorization_method == C.FACTORIZE_KKT:
        boosted = torch.full_like(st.gamma, 1e10)
    else:
        boosted = torch.maximum(st.gamma_max,
                                1e14 / torch.clamp(st.gersh, min=1e-30))
    return torch.where(nb_active > 0, boosted,
                       torch.full_like(boosted, 1e12))


def compute_objective(st: SolverState, data: QPData, scal: ScalingInfo,
                      settings: Settings):
    """iteration.c:231-270: (B,)."""
    Qx_pure = st.Qx - st.x / st.gamma[:, None] if settings.proximal \
        else st.Qx
    obj = _dot(0.5 * Qx_pure + data.q, st.x)
    if settings.scaling:
        obj = obj * scal.cinv
    return obj + data.c


def compute_dual_objective(st: SolverState, data: QPData, scal: ScalingInfo,
                           settings: Settings, LQ):
    """iteration.c:272-299, with R_Q from K2a (Q assumed PD; a singular Q
    gives NaN, which the caller's guard reads as no termination)."""
    g = st.Aty + data.q
    v = cholesky_solve(LQ, g)
    dual_obj = -0.5 * _dot(g, v)
    contrib = torch.where(st.y > 0, st.y * data.bmax, st.y * data.bmin)
    dual_obj = dual_obj - contrib.sum(-1)
    if settings.scaling:
        dual_obj = dual_obj * scal.cinv
    return dual_obj + data.c


# ---------------------------------------------------------------------------
# termination (core.py:321-411)
# ---------------------------------------------------------------------------

def calculate_residuals_and_tolerances(st: SolverState, data: QPData,
                                       scal: ScalingInfo,
                                       settings: Settings) -> SolverState:
    """termination.c:44-129."""
    pri_res_norm = norm_inf(scal.Einv * st.pri_res)
    if settings.proximal:
        xx0 = st.x - st.x0
        dua_res_norm = norm_inf(scal.Dinv * (st.dphi
                                             - xx0 / st.gamma[:, None]))
        dua2_res_norm = norm_inf(scal.Dinv * st.dphi)
    else:
        dua_res_norm = norm_inf(scal.Dinv * st.dphi)
        dua2_res_norm = dua_res_norm
    dua_res_norm = dua_res_norm * scal.cinv
    dua2_res_norm = dua2_res_norm * scal.cinv
    eps_pri = settings.eps_abs + settings.eps_rel * torch.maximum(
        norm_inf(scal.Einv * st.Ax), norm_inf(scal.Einv * st.z))
    max_norm = torch.maximum(
        norm_inf(scal.Dinv * st.Qx),
        torch.maximum(norm_inf(scal.Dinv * data.q),
                      norm_inf(scal.Dinv * st.Atyh))) * scal.cinv
    eps_dua = settings.eps_abs + settings.eps_rel * max_norm
    eps_dua_in = st.eps_abs_in + st.eps_rel_in * max_norm
    return st._replace(pri_res_norm=pri_res_norm, dua_res_norm=dua_res_norm,
                       dua2_res_norm=dua2_res_norm, eps_pri=eps_pri,
                       eps_dua=eps_dua, eps_dua_in=eps_dua_in)


def _bounds(data: QPData, scal: ScalingInfo):
    has_ub = data.bmax < scal.E * C.QPALM_INFTY
    has_lb = data.bmin > -scal.E * C.QPALM_INFTY
    return has_ub, has_lb


def is_primal_infeasible(st: SolverState, data: QPData, scal: ScalingInfo,
                         settings: Settings):
    """termination.c:136-182: (flag (B,), unscaled delta_y certificate)."""
    delta_y = st.yh - st.y
    eps_norm = settings.eps_prim_inf * norm_inf(scal.E * delta_y)
    At_dy = scal.Dinv * (st.Atyh - st.Aty)
    has_ub, has_lb = _bounds(data, scal)
    zero = torch.zeros((), dtype=delta_y.dtype, device=delta_y.device)
    out_of_bounds = (
        torch.where(has_ub, data.bmax * torch.clamp(delta_y, min=0.0), zero)
        + torch.where(has_lb, data.bmin * torch.clamp(delta_y, max=0.0),
                      zero)).sum(-1)
    flag = ((eps_norm > 0) & (norm_inf(At_dy) <= eps_norm)
            & (out_of_bounds <= -eps_norm))
    cert = scal.E * (scal.cinv[:, None] * delta_y)
    return flag, cert


def is_dual_infeasible(st: SolverState, data: QPData, scal: ScalingInfo,
                       settings: Settings):
    """termination.c:184-240: (flag (B,), unscaled delta_x certificate);
    st.Qd / st.Ad hold tau Qd / tau Ad of the last inner step."""
    delta_x = st.x - st.x_prev
    Ddx = scal.D * delta_x
    eps_norm = settings.eps_dual_inf * norm_inf(Ddx)
    dxdx = _dot(Ddx, Ddx)
    A_dx = scal.Einv * st.Ad
    has_ub, has_lb = _bounds(data, scal)
    en = eps_norm[:, None]
    bound_violation = ((has_ub & (A_dx >= en))
                       | (has_lb & (A_dx <= -en))).any(-1)
    if settings.proximal:
        Qdx = st.Qd - (st.tau / st.gamma)[:, None] * st.d
    else:
        Qdx = st.Qd
    dxQdx = _dot(delta_x, Qdx)
    e2 = settings.eps_dual_inf * settings.eps_dual_inf
    cs = scal.c if settings.scaling else torch.ones_like(scal.c)
    curvature_ok = (dxQdx <= -cs * e2 * dxdx) | (
        (dxQdx <= cs * e2 * dxdx)
        & (_dot(data.q, delta_x) <= -cs * eps_norm))
    flag = (eps_norm > 0) & ~bound_violation & curvature_ok
    return flag, scal.D * delta_x


# ---------------------------------------------------------------------------
# Newton step + primal update (core.py:418-631), the SCHUR, KKT, CG and
# STAGE paths
# ---------------------------------------------------------------------------

def _assemble(st: SolverState, data: QPData, settings: Settings, active):
    """M = Q + A' diag(sigma active) A (+ I/gamma) at full precision, and
    the Gershgorin bound of A' diag(sigma active) A."""
    Q, A = data.Q, data.A
    w = torch.where(active, st.sqrt_sigma, torch.zeros_like(st.sqrt_sigma))
    Bw = A * w[:, :, None]
    AtsA = torch.bmm(Bw.transpose(1, 2), Bw)
    g = gershgorin_max(AtsA)
    M = Q + AtsA
    if settings.proximal:
        eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
        M = M + (1.0 / st.gamma)[:, None, None] * eye
    return M, g


def _newton_stage(st: SolverState, data: QPData, settings: Settings, active,
                  neg_dphi):
    """The stage-structured Newton direction (core.py:497-517): M of a
    stage-ordered problem is block-tridiagonal in blocks of stage_block,
    so block Thomas solves it in O(S nb^3).  Returns (d, gersh)."""
    from ..parallel.block_tridiag import extract_block_tridiag, thomas_solve

    M, gersh = _assemble(st, data, settings, active)
    nb = settings.stage_block
    B, n = neg_dphi.shape
    Db, Eb = extract_block_tridiag(M, nb)
    d = thomas_solve(Db, Eb[:, :-1], neg_dphi.reshape(B, n // nb, nb))
    return d.reshape(B, n), gersh


def _newton_cg(st: SolverState, data: QPData, settings: Settings, active,
               neg_dphi):
    """The matrix-free Newton direction (core.py:430-496): preconditioned
    CG on M = Q + A' diag(sigma active) A + I/gamma, with the inexact-Newton
    forcing term.  Returns (d, gersh), gersh the Gershgorin-style bound on
    A' diag(sigma active) A that the gamma boost reads."""
    Q, A = data.Q, data.A
    sparse = S.is_sparse(A)
    sig_act = torch.where(active, st.sigma, torch.zeros_like(st.sigma))
    gamma_inv = 1.0 / st.gamma if settings.proximal \
        else torch.zeros_like(st.gamma)

    def matvec(v):
        r = _mv(Q, v) + _mtv(A, sig_act * _mv(A, v))
        if settings.proximal:
            r = r + v * gamma_inv[:, None]
        return r

    if sparse:
        diagM = (S.sym_diag(Q) + gamma_inv + S.ata_diag(A, sig_act[0]))[None]
        gersh = S.ata_gershgorin_upper(A, sig_act[0])[None]
    else:
        diagM = (torch.diagonal(Q, dim1=-2, dim2=-1) + gamma_inv[:, None]
                 + torch.einsum("bmn,bm->bn", A * A, sig_act))
        # the matrix-free |A|' diag(sig) |A| 1 row-sum bound: assembling
        # the n x n product every inner iteration for this scalar would
        # defeat the CG mode (a conservative bound only picks a smaller
        # boosted gamma)
        absA = A.abs()
        gersh = _mtv(absA, sig_act * _mv(absA, torch.ones_like(st.x))) \
            .amax(-1)
    if settings.cg_precond == "block_jacobi":
        # factored block diagonals of M (kernel K2): the middle ground
        # between diag(M) and the reference's full sparse LDL'
        if sparse:
            blocks = S.block_diagonals(Q, A, sig_act[0], gamma_inv[0],
                                       settings.cg_block)
        else:
            blocks = S.block_diagonals_dense(Q, A, sig_act, gamma_inv,
                                             settings.cg_block)
        R = cholesky_upper(blocks)
        precond = lambda r: S.block_jacobi_apply(R, r)  # noqa: E731
    else:
        precond = diagM
    # inexact-Newton forcing: the CG tolerance loosens to a fraction of
    # eps_dua_in relative to ||dphi|| and tightens to cg_tol near the end
    dphi_norm = torch.sqrt(_dot(neg_dphi, neg_dphi))
    forcing = torch.clamp(
        0.01 * st.eps_dua_in / torch.clamp(dphi_norm, min=1e-30),
        min=settings.cg_tol, max=1e-2)
    d, _, _ = pcg(matvec, neg_dphi, precond, tol=forcing,
                  max_iter=settings.cg_max_iter)
    return d, gersh


def _newton_and_linesearch(st: SolverState, data: QPData,
                           settings: Settings,
                           wide: _Wide = None) -> SolverState:
    """update_primal_iterate (iteration.c:213-229)."""
    dtype = st.x.dtype
    Q, A = data.Q, data.A
    active = (st.Axys <= data.bmin) | (st.Axys >= data.bmax)
    nb_enter = (active & ~st.active_old).sum(-1, dtype=_I32)
    nb_leave = (~active & st.active_old).sum(-1, dtype=_I32)
    reuse = st.factor_valid & (nb_enter == 0) & (nb_leave == 0)
    neg_dphi = -st.dphi

    if settings.factorization_method in (C.FACTORIZE_CG, C.FACTORIZE_STAGE):
        newton = _newton_cg if settings.factorization_method == \
            C.FACTORIZE_CG else _newton_stage
        d, gersh = newton(st, data, settings, active, neg_dphi)
        st = st._replace(d=d, gersh=gersh, active=active, active_old=active,
                         nb_enter=nb_enter, nb_leave=nb_leave,
                         factor_valid=torch.ones_like(st.factor_valid))
        return _linesearch_step(st, data, settings)

    if settings.factorization_method == C.FACTORIZE_KKT:
        # refactored every iteration, never refined (core.py:520-525)
        d = newton_solve_kkt(Q, A, st.sigma, active, st.gamma, neg_dphi,
                             settings.proximal)
        st = st._replace(d=d, active=active, active_old=active,
                         nb_enter=nb_enter, nb_leave=nb_leave,
                         factor_valid=torch.ones_like(st.factor_valid))
        return _linesearch_step(st, data, settings)

    # factor M = Q + A' diag(sigma active) A + I/gamma for every problem
    M, g = _assemble(st, data, settings, active)
    L = torch.where(reuse[:, None, None], st.L, cholesky_upper(M))
    gersh = torch.where(reuse, st.gersh, g)
    d = cholesky_solve(L, neg_dphi)

    if settings.max_refine > 0:
        # iterative refinement (newton.c:57-90), the residual in float64
        # under refine_fp64; every problem refines, `need` selects
        hp = settings.refine_fp64 and dtype != torch.float64
        if hp:
            wide = wide or _Wide(data)
            Qr, Ar = wide.Q, wide.A
            rdt = torch.float64
        else:
            Qr, Ar, rdt = Q, A, dtype
        sig_r = torch.where(active, st.sigma, torch.zeros_like(st.sigma)) \
            .to(rdt)
        g_r = st.gamma.to(rdt)[:, None]

        def matvec(v):
            r = _mv(Qr, v) + _mtv(Ar, sig_r * _mv(Ar, v))
            if settings.proximal:
                r = r + v / g_r
            return r

        b_r = neg_dphi.to(rdt)
        dd = d.to(rdt)
        res0 = norm_inf(b_r - matvec(dd))
        ref_norm = torch.clamp(norm_inf(b_r), min=1.0)
        need = res0 > torch.clamp(C.RELATIVE_REFINEMENT_TOLERANCE * ref_norm,
                                  min=C.ABSOLUTE_REFINEMENT_TOLERANCE)
        for _ in range(settings.max_refine):
            r = b_r - matvec(dd)
            dd = dd + cholesky_solve(L, r.to(dtype)).to(rdt)
        d = torch.where(need[:, None], dd.to(dtype), d)

    st = st._replace(d=d, L=L, gersh=gersh, active=active, active_old=active,
                     nb_enter=nb_enter, nb_leave=nb_leave,
                     factor_valid=torch.ones_like(st.factor_valid))
    return _linesearch_step(st, data, settings)


def _linesearch_step(st: SolverState, data: QPData,
                     settings: Settings) -> SolverState:
    """The exact linesearch along st.d (linesearch.c:14-120) and the
    primal update."""
    dtype, d, Q, A = st.x.dtype, st.d, data.Q, data.A
    Qd = _mv(Q, d)
    if settings.proximal:
        Qd = Qd + d / st.gamma[:, None]
    Ad = _mv(A, d)
    mode = settings.linesearch
    if mode == "auto":
        mode = "bisect" if dtype == torch.float32 else "sort"
    tau = exact_linesearch(d, Qd, Ad, st.df, st.Ax, st.y, st.sigma,
                           st.sqrt_sigma, data.bmin, data.bmax, mode=mode)
    t = tau[:, None]
    Qd_t = t * Qd
    Ad_t = t * Ad
    return st._replace(x_prev=st.x, dphi_prev=st.dphi, x=st.x + t * d,
                       tau=tau, Qd=Qd_t, Ad=Ad_t, Qx=st.Qx + Qd_t,
                       Ax=st.Ax + Ad_t)


# ---------------------------------------------------------------------------
# the fused outer/inner loop (core.py:638-829)
# ---------------------------------------------------------------------------

def make_iteration(data: QPData, scal: ScalingInfo, settings: Settings,
                   LQ=None):
    """The loop body: fn(state) -> state, one reference iteration (one trip
    through the for-loop at qpalm.c:484) on every problem of the batch.
    The caller freezes finished problems (`solve_from_state`)."""
    wide = _Wide(data) if (settings.residuals_fp64 or settings.refine_fp64) \
        and data.Q.dtype == torch.float32 else None
    i32 = lambda v, like: torch.full_like(like, v)  # noqa: E731

    def outer_update(st: SolverState) -> SolverState:
        """qpalm.c:515-644."""
        st = st._replace(no_change=torch.zeros_like(st.no_change))
        do_sigma = (st.iter_out > 0) & (st.pri_res_norm > st.eps_pri)
        st = update_sigma(st, settings, do_sigma)
        st = st._replace(y=st.yh, Aty=st.Atyh)
        if settings.enable_dual_termination:
            dual_obj = compute_dual_objective(st, data, scal, settings, LQ)
            # a PSD-singular Q NaNs the Q-Cholesky solve: no termination
            terminated = torch.isfinite(dual_obj) & (
                dual_obj > settings.dual_objective_limit)
            st = st._replace(
                dual_objective=dual_obj, done=st.done | terminated,
                status=torch.where(
                    terminated, i32(C.QPALM_DUAL_TERMINATED, st.status),
                    st.status))
        st = st._replace(
            eps_abs_in=torch.clamp(settings.rho * st.eps_abs_in,
                                   min=settings.eps_abs),
            eps_rel_in=torch.clamp(settings.rho * st.eps_rel_in,
                                   min=settings.eps_rel))
        if settings.nonconvex:
            # move the proximal center only when pri_res has caught up
            # (qpalm.c:586-609)
            eps_k = st.eps_k_abs + st.eps_k_rel * torch.maximum(
                norm_inf(scal.Einv * st.Ax), norm_inf(scal.Einv * st.z))
            move = st.pri_res_norm < eps_k
            st = st._replace(
                x0=torch.where(move[:, None], st.x, st.x0),
                eps_k_abs=torch.where(
                    move, torch.clamp(settings.rho * st.eps_k_abs,
                                      min=settings.eps_abs), st.eps_k_abs),
                eps_k_rel=torch.where(
                    move, torch.clamp(settings.rho * st.eps_k_rel,
                                      min=settings.eps_rel), st.eps_k_rel))
        elif settings.proximal:
            # gamma boost once the active set has settled (qpalm.c:612-630)
            check = (~st.gamma_maxed & (st.iter_out > 0)
                     & (st.nb_enter == 0) & (st.nb_leave == 0)
                     & (st.pri_res_norm < st.eps_pri))
            Axys2 = st.Ax + st.y * st.sigma_inv  # y == yh here
            active2 = (Axys2 <= data.bmin) | (Axys2 >= data.bmax)
            nb_enter2 = (active2 & ~st.active_old).sum(-1, dtype=_I32)
            nb_leave2 = (~active2 & st.active_old).sum(-1, dtype=_I32)
            boost = check & (nb_enter2 == 0) & (nb_leave2 == 0)
            boosted_gamma = _boost_gamma_values(st, active2, settings)
            stepped_gamma = _stepped_gamma(st, settings)[1]
            st = _apply_gamma_change(
                st, torch.where(boost, boosted_gamma, stepped_gamma))
            # gamma_maxed latches only when constraints were active at the
            # boost (iteration.c:195); the check overwrites the active-set
            # diff (qpalm.c:617-618)
            nb_active2 = active2.sum(-1)
            st = st._replace(
                gamma_maxed=st.gamma_maxed | (boost & (nb_active2 > 0)),
                active=torch.where(check[:, None], active2, st.active),
                nb_enter=torch.where(check, nb_enter2, st.nb_enter),
                nb_leave=torch.where(check, nb_leave2, st.nb_leave),
                x0=st.x)
        return st._replace(pri_res_in=st.pri_res, iter_out=st.iter_out + 1,
                           prev_iter=st.iter)

    def inner_exhausted(st: SolverState) -> SolverState:
        """inner_max_iter hit (qpalm.c:647-660)."""
        st = st._replace(no_change=torch.zeros_like(st.no_change))
        do_sigma = (st.iter_out > 0) & (st.pri_res_norm > st.eps_pri)
        st = update_sigma(st, settings, do_sigma)
        if settings.proximal:
            st = update_gamma(st, settings)
            if not settings.nonconvex:
                st = st._replace(x0=st.x)
        return st._replace(pri_res_in=st.pri_res, iter_out=st.iter_out + 1,
                           prev_iter=st.iter)

    def inner_step(st: SolverState) -> SolverState:
        """One semismooth Newton inner iteration (qpalm.c:662-678)."""
        st = st._replace(no_change=torch.where(
            st.nb_enter + st.nb_leave > 0, torch.zeros_like(st.no_change),
            st.no_change + 1))
        reset = (st.iter % settings.reset_newton_iter) == 0
        st = st._replace(factor_valid=st.factor_valid & ~reset)
        return _newton_and_linesearch(st, data, settings, wide)

    def iteration(st: SolverState) -> SolverState:
        st = compute_residuals(st, data, settings, wide)
        st = calculate_residuals_and_tolerances(st, data, scal, settings)
        solved = (st.pri_res_norm < st.eps_pri) & \
            (st.dua_res_norm < st.eps_dua)
        pinf, cert_dy = is_primal_infeasible(st, data, scal, settings)
        dinf, cert_dx = is_dual_infeasible(st, data, scal, settings)
        terminate = solved | pinf | dinf
        outer_trigger = (st.dua2_res_norm <= st.eps_dua_in) | \
            (st.no_change == 3)
        exhausted = st.iter == st.prev_iter + settings.inner_max_iter

        status = torch.where(
            solved, i32(C.QPALM_SOLVED, st.status),
            torch.where(pinf, i32(C.QPALM_PRIMAL_INFEASIBLE, st.status),
                        i32(C.QPALM_DUAL_INFEASIBLE, st.status)))
        st_term = st._replace(
            done=torch.ones_like(st.done), status=status,
            delta_y=torch.where((pinf & ~solved)[:, None], cert_dy,
                                st.delta_y),
            delta_x=torch.where((dinf & ~solved & ~pinf)[:, None], cert_dx,
                                st.delta_x))
        # every branch runs on every problem, as under vmap; the masks
        # pick each problem's (lax.switch, core.py:818-825)
        b_outer = ~terminate & outer_trigger
        b_exh = ~terminate & ~outer_trigger & exhausted
        nxt = inner_step(st)
        nxt = _select_state(b_exh, inner_exhausted(st), nxt)
        nxt = _select_state(b_outer, outer_update(st), nxt)
        nxt = _select_state(terminate, st_term, nxt)
        # the reference's for-loop advances iter except on the terminating
        # trip
        return nxt._replace(iter=torch.where(nxt.done, nxt.iter,
                                             nxt.iter + 1))

    return iteration


def solve_from_state(st: SolverState, data: QPData, scal: ScalingInfo,
                     settings: Settings, max_iter=None) -> SolverState:
    """Run the loop until every problem terminates or reaches `max_iter`
    (default settings.max_iter; the host's chunk limit of a time-limited
    solve), then mark the problems not done at settings.max_iter
    (qpalm.c:712-716).  A problem that stops is frozen; the host checks
    for the end every SYNC_STRIDE iterations.  `settings.unroll` changes
    nothing here (core.py:855-869 guards its sub-steps the same way)."""
    full_f32_matmul()
    LQ = cholesky_upper(data.Q) if settings.enable_dual_termination \
        else None
    iteration = make_iteration(data, scal, settings, LQ)
    limit = settings.max_iter if max_iter is None else int(max_iter)
    k = 0
    while True:
        live = ~st.done & (st.iter < limit)
        if k % SYNC_STRIDE == 0 and not bool(live.any()):
            break
        st = _select_state(live, iteration(st), st)
        k += 1
    hit_max = ~st.done & (st.iter >= settings.max_iter)
    return st._replace(status=torch.where(
        hit_max, torch.full_like(st.status, C.QPALM_MAX_ITER_REACHED),
        st.status))


def setup(data: QPData, settings: Settings, x_ws=None, y_ws=None,
          gamma_init=None, gamma_max=None):
    """Scale (or not) and build the initial state: (state, scaled data,
    scaling) (qpalm_tpu/api.py:74-87, _setup_and_init)."""
    if settings.scaling:
        sdata, scal = scale_data(data, settings.scaling)
    else:
        B, n = data.q.shape
        sdata = data
        scal = identity_scaling(B, n, data.bmin.shape[1], data.Q.dtype,
                                data.Q.device)
    st = init_state(sdata, scal, settings, x_ws, y_ws, gamma_init,
                    gamma_max)
    return st, sdata, scal


def finalize(st: SolverState, sdata: QPData, scal: ScalingInfo,
             settings: Settings):
    """(x, y, objective) unscaled (core.py:913-916)."""
    x_sol = scal.D * st.x
    y_sol = scal.E * (scal.cinv[:, None] * st.yh)
    return x_sol, y_sol, compute_objective(st, sdata, scal, settings)


def full_solve(data: QPData, settings: Settings, x_ws=None, y_ws=None,
               gamma_init=None, gamma_max=None):
    """Scale, initialise and solve a stacked batch (core.py:882-916, vmapped
    by qpalm_tpu/batch.py:60-100).  Returns (final state, x (B, n) and
    y (B, m) unscaled, objective (B,))."""
    st, sdata, scal = setup(data, settings, x_ws, y_ws, gamma_init,
                            gamma_max)
    final = solve_from_state(st, sdata, scal, settings)
    return (final,) + finalize(final, sdata, scal, settings)
