"""The P-ALM loop with the horizon of a stage-structured MPC QP split over
a mesh (counterpart of qpalm_tpu/parallel/mpc_loop.py).

Stage variables z_k = [x_{k+1}; u_k]; dynamics couple adjacent stages and
the box rows are diagonal, so:

  * A and A' matvecs are stage-local plus one halo shift of a shard's
    first or last stage (`mesh.ppermute`),
  * the Schur matrix is assembled block by block (exactly
    block-tridiagonal in this ordering) and every Newton system is solved
    by SPIKE (`block_tridiag.spike_solve_local`: block Thomas on K2 a
    shard, the interface reduced over the mesh),
  * the linesearch's breakpoints are built on each shard and gathered
    shard-major for the replicated sort and scan,
  * every norm and counter rides one fused `psum` or `pmax` of a stack of
    per-shard values (an all-gather and a sum in shard order, mesh.py).

Proximal with the gamma schedule and its settled-active-set boost
(qpalm.c:612-630, the Gershgorin bound from the block assembly), Ruiz
scaling, warm starts and both infeasibility certificates, as the
reference.  The reference's `lax.while_loop` is a host loop here that
reads `done` every `core.SYNC_STRIDE` iterations; the iterations past
`done` keep every field as it was, so the count equals the reference's.

Shard-local tensors are (L, S_loc, ...) (mesh.py); the loop's replicated
scalars are (L,), equal on every row and every rank.  The scaling runs on
the full stage data on every rank, then each rank takes its stages, so
that every rank's scaling is bit-identical to a LocalMesh's.  Stage data
comes in as numpy (`MPCStageData`, `stage_data_from`); results come out
as tensors on the mesh's device: global (S, ...) on a LocalMesh, the
rank's (S_loc, ...) on a DistMesh.  Nonconvex problems are out of scope,
as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C
from ..constants import MIN_SCALING
from ..solver.core import SYNC_STRIDE, _bc, _sel
from ..solver.linesearch import linesearch_from_breakpoints
from ..types import Settings
from .block_tridiag import spike_solve_local

__all__ = ["MPCStageData", "StageScaled", "StageScaling", "MPCResult",
           "from_mpc_chain", "mpc_chain_stage_data", "stage_data_from",
           "scale_stage_data", "identity_stage_scaling",
           "solve_mpc_stage_sharded"]

class MPCStageData(NamedTuple):
    """Stage-structured MPC QP data, numpy, leading axis the stage
    (mpc_loop.py:48-66).  The dynamics row of stage k is G z_k - Aprev
    z_{k-1} = beq_k with G = [I  -Bd], Aprev = [Ad  0] (no z_{-1} term at
    k = 0: the initial state is folded into beq_0), then nb box rows
    lo_k <= z_k <= hi_k."""

    H: np.ndarray    # (S, nb, nb) stage Hessian blocks
    q: np.ndarray    # (S, nb)
    beq: np.ndarray  # (S, nx)
    lo: np.ndarray   # (S, nb)
    hi: np.ndarray   # (S, nb)
    Ad: np.ndarray   # (nx, nx) shared dynamics
    Bd: np.ndarray   # (nx, nu)


class StageScaled(NamedTuple):
    """Scaled stage data with per-stage constraint blocks (tensors)."""

    H: torch.Tensor    # (S, nb, nb)
    q: torch.Tensor    # (S, nb)
    beq: torch.Tensor  # (S, nx)
    lo: torch.Tensor   # (S, nb)
    hi: torch.Tensor   # (S, nb)
    G: torch.Tensor    # (S, nx, nb) scaled dynamics block (own stage)
    Ap: torch.Tensor   # (S, nx, nb) scaled coupling to the previous stage
    W: torch.Tensor    # (S, nb) scaled box-row diagonal


class StageScaling(NamedTuple):
    D: torch.Tensor     # (S, nb) column scaling
    Eeq: torch.Tensor   # (S, nx) equality row scaling
    Ebox: torch.Tensor  # (S, nb) box row scaling
    c: torch.Tensor     # () cost scaling


class MPCResult(NamedTuple):
    z: torch.Tensor             # (S, nb) primal solution (unscaled)
    y_eq: torch.Tensor          # (S, nx) equality multipliers (unscaled)
    y_box: torch.Tensor         # (S, nb) box multipliers (unscaled)
    status: torch.Tensor        # () int32
    iterations: torch.Tensor    # () int32
    pri_res_norm: torch.Tensor  # ()
    dua_res_norm: torch.Tensor  # ()
    delta_y_eq: torch.Tensor    # (S, nx) primal-infeasibility certificate
    delta_y_box: torch.Tensor   # (S, nb)
    delta_z: torch.Tensor       # (S, nb) dual-infeasibility certificate


def stage_data_from(arrays) -> MPCStageData:
    """MPCStageData of numpy copies of any seven arrays in its field order
    (the JAX package's MPCStageData, say)."""
    return MPCStageData(*(np.asarray(a) for a in arrays))


def from_mpc_chain(H, A, q, bmin, bmax, meta) -> MPCStageData:
    """A `workloads.mpc_chain` problem (z = [x_1..x_N | u_0..]) as
    stage-interleaved MPCStageData (mpc_loop.py:104-126)."""
    from ..workloads import mpc_stage_permutation

    nx, nu, N = meta["nx"], meta["nu"], meta["N"]
    nb = nx + nu
    perm = mpc_stage_permutation(nx, nu, N)
    Hp = np.asarray(H)[np.ix_(perm, perm)]
    qp = np.asarray(q)[perm]
    H_blocks = np.stack([Hp[k * nb:(k + 1) * nb, k * nb:(k + 1) * nb]
                         for k in range(N)])
    m_eq = meta["m_eq"]
    return MPCStageData(
        H=H_blocks, q=qp.reshape(N, nb),
        beq=np.asarray(bmin)[:m_eq].reshape(N, nx),
        # mpc_chain's box rows are eye(nz) in the original ordering
        lo=np.asarray(bmin)[m_eq:][perm].reshape(N, nb),
        hi=np.asarray(bmax)[m_eq:][perm].reshape(N, nb),
        Ad=np.asarray(meta["Ad"]), Bd=np.asarray(meta["Bd"]))


def mpc_chain_stage_data(n_masses: int = 6, horizon: int = 10, x0=None,
                         seed: int = 0) -> MPCStageData:
    """The chain MPC's MPCStageData built in stage-block form, O(S nb^2)
    memory (mpc_loop.py:129-166): bit-identical to
    `from_mpc_chain(*workloads.mpc_chain(...))`, whose dense route needs
    O((S nb)^2) and cannot build long horizons."""
    from ..workloads import _chain_dynamics

    rng = np.random.default_rng(seed)
    Ad, Bd = _chain_dynamics(n_masses)
    nx, nu = Bd.shape
    nb = nx + nu
    N = horizon
    if x0 is None:
        x0 = 0.5 * rng.standard_normal(nx)
    x0 = np.asarray(x0, float)
    Hb = np.eye(nb)
    Hb[nx:, nx:] *= 0.1  # blockdiag(Qw = I, Rw = 0.1 I), every stage
    beq = np.zeros((N, nx))
    beq[0] = Ad @ x0
    lohi = np.concatenate([4.0 * np.ones(nx), 0.5 * np.ones(nu)])
    return MPCStageData(
        H=np.broadcast_to(Hb, (N, nb, nb)).copy(), q=np.zeros((N, nb)),
        beq=beq, lo=np.broadcast_to(-lohi, (N, nb)).copy(),
        hi=np.broadcast_to(lohi, (N, nb)).copy(), Ad=Ad, Bd=Bd)


def _tensors(data: MPCStageData, device) -> MPCStageData:
    return MPCStageData(*(torch.from_numpy(np.array(a, np.float64)).to(
        device) for a in data))


def _limit(v):
    return torch.where(v < MIN_SCALING, torch.ones_like(v), v)


def _dynamics(data: MPCStageData):
    """(G, Ap) of the unscaled data: G = [I  -Bd] every stage, Ap =
    [Ad  0] from stage 1 (stage 0 has no z_{-1} coupling)."""
    S, nb = data.q.shape
    nx = data.beq.shape[-1]
    kw = dict(dtype=data.H.dtype, device=data.H.device)
    G0 = torch.cat([torch.eye(nx, **kw), -data.Bd], 1)
    Ap0 = torch.cat([data.Ad, torch.zeros((nx, nb - nx), **kw)], 1)
    Ap = torch.cat([torch.zeros((1, nx, nb), **kw),
                    Ap0.expand(S - 1, nx, nb)], 0)
    return G0.expand(S, nx, nb), Ap


def scale_stage_data(data: MPCStageData, iters: int):
    """Ruiz equilibration of the stage-structured constraint matrix,
    symmetric H scaling and cost scaling on the full stage data (tensors;
    mpc_loop.py:173-239, reference scaling.c:34-113).  Returns
    (StageScaled, StageScaling)."""
    S, nb = data.q.shape
    nx = data.beq.shape[-1]
    kw = dict(dtype=data.H.dtype, device=data.H.device)
    G, Ap = _dynamics(data)
    W = torch.ones((S, nb), **kw)
    D = torch.ones((S, nb), **kw)
    Eeq = torch.ones((S, nx), **kw)
    Ebox = torch.ones((S, nb), **kw)
    for _ in range(iters):
        # column inf-norms of stage k's variables: G_k's columns, the next
        # stage's coupling Ap_{k+1}, the box weight
        ap_next = torch.cat([Ap[1:].abs().amax(1),
                             torch.zeros((1, nb), **kw)], 0)
        col = torch.maximum(G.abs().amax(1), torch.maximum(ap_next, W.abs()))
        row_eq = torch.maximum(G.abs().amax(2), Ap.abs().amax(2))
        Dt = 1.0 / torch.sqrt(_limit(col))
        Et_eq = 1.0 / torch.sqrt(_limit(row_eq))
        Et_box = 1.0 / torch.sqrt(_limit(W.abs()))
        Dt_prev = torch.cat([torch.ones((1, nb), **kw), Dt[:-1]], 0)
        G = Et_eq[:, :, None] * G * Dt[:, None, :]
        Ap = Et_eq[:, :, None] * Ap * Dt_prev[:, None, :]
        W = Et_box * W * Dt
        D = D * Dt
        Eeq = Eeq * Et_eq
        Ebox = Ebox * Et_box
    q = D * data.q
    c = 1.0 / torch.clamp(q.abs().amax(), min=1.0)
    q = c * q
    H = c * (D[:, :, None] * data.H * D[:, None, :])
    beq = Eeq * data.beq
    lo = torch.where(data.lo > -C.QPALM_INFTY, Ebox * data.lo, data.lo)
    hi = torch.where(data.hi < C.QPALM_INFTY, Ebox * data.hi, data.hi)
    return (StageScaled(H=H, q=q, beq=beq, lo=lo, hi=hi, G=G, Ap=Ap, W=W),
            StageScaling(D=D, Eeq=Eeq, Ebox=Ebox, c=c))


def identity_stage_scaling(data: MPCStageData):
    """(StageScaled, StageScaling) of the unscaled data (mpc_loop.py:
    242-264)."""
    S, nb = data.q.shape
    nx = data.beq.shape[-1]
    kw = dict(dtype=data.H.dtype, device=data.H.device)
    G, Ap = _dynamics(data)
    return (StageScaled(H=data.H, q=data.q, beq=data.beq, lo=data.lo,
                        hi=data.hi, G=G, Ap=Ap, W=torch.ones((S, nb), **kw)),
            StageScaling(D=torch.ones((S, nb), **kw),
                         Eeq=torch.ones((S, nx), **kw),
                         Ebox=torch.ones((S, nb), **kw),
                         c=torch.ones((), **kw)))


class _State(NamedTuple):
    """The loop's carry (mpc_loop.py:753-783): (L, S_loc, ...) per shard,
    (L,) replicated."""

    z: torch.Tensor
    z0: torch.Tensor
    z_prev: torch.Tensor
    y_eq: torch.Tensor
    y_box: torch.Tensor
    sig_eq: torch.Tensor
    sig_box: torch.Tensor
    pri_in_eq: torch.Tensor
    pri_in_box: torch.Tensor
    eps_abs_in: torch.Tensor
    eps_rel_in: torch.Tensor
    active_old: torch.Tensor
    gamma: torch.Tensor
    gamma_maxed: torch.Tensor
    gersh: torch.Tensor
    nb_changed: torch.Tensor
    no_change: torch.Tensor
    it: torch.Tensor
    it_out: torch.Tensor
    prev_it: torch.Tensor
    done: torch.Tensor
    status: torch.Tensor
    Hd_t: torch.Tensor
    Ad_eq_t: torch.Tensor
    Ad_box_t: torch.Tensor
    dy_eq_cert: torch.Tensor
    dy_box_cert: torch.Tensor
    dz_cert: torch.Tensor
    pri_norm: torch.Tensor
    dua_norm: torch.Tensor


def _lsum(v):
    """Each shard's sum of its entries: (L, ...) -> (L,)."""
    return v.reshape(v.shape[0], -1).sum(-1)


def _lmax(v):
    return v.reshape(v.shape[0], -1).amax(-1)


def _mv(M, v):
    """Stage by stage M v: (L, S, r, c), (L, S, c) -> (L, S, r)."""
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    """Stage by stage M' v: (L, S, r, c), (L, S, r) -> (L, S, c)."""
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


class _Ops:
    """The shard-local operators of the stage data over the mesh
    (mpc_loop.py:279-367)."""

    def __init__(self, mesh, d: StageScaled):
        self.mesh, self.d = mesh, d
        self.is_first = mesh.index == 0
        self.is_last = mesh.index == mesh.size - 1
        # the A' coupling's halo, the same every iteration
        self.Ap_next = self.next_stage(d.Ap)

    def halo_left(self, v_last):
        """Each shard's left neighbour's last stage (zero on shard 0)."""
        got = self.mesh.ppermute(v_last, 1)
        return _sel(self.is_first, torch.zeros_like(got), got)

    def halo_right(self, v_first):
        got = self.mesh.ppermute(v_first, -1)
        return _sel(self.is_last, torch.zeros_like(got), got)

    def next_stage(self, v):
        """v of stage k + 1 at stage k (zero past the last stage)."""
        return torch.cat([v[:, 1:], self.halo_right(v[:, 0])[:, None]], 1)

    def a(self, z):
        """(eq (L, S, nx), box (L, S, nb)) rows of A z."""
        d = self.d
        z_prev = torch.cat([self.halo_left(z[:, -1])[:, None], z[:, :-1]], 1)
        return _mv(d.G, z) - _mv(d.Ap, z_prev), d.W * z

    def at(self, w_eq, w_box):
        d = self.d
        return (_mtv(d.G, w_eq) - _mtv(self.Ap_next, self.next_stage(w_eq))
                + d.W * w_box)

    def h(self, z):
        return _mv(self.d.H, z)

    def blocks(self, sig_eq, sig_box_act, gamma, prox):
        """(D, E) of M = H + A' Sigma_act A (+ I/gamma), block-tridiagonal,
        E[s] at block (s + 1, s), and the Gershgorin bound of A' Sigma_act A
        (mpc_loop.py:338-367)."""
        d = self.d
        nb = d.H.shape[-1]
        GS = d.G * sig_eq[..., None]
        ApS = self.Ap_next * self.next_stage(sig_eq)[..., None]
        ats_D = GS.transpose(-1, -2) @ d.G \
            + ApS.transpose(-1, -2) @ self.Ap_next \
            + torch.diag_embed(sig_box_act * d.W * d.W)
        t_loc = -(GS.transpose(-1, -2) @ d.Ap)
        E = self.next_stage(t_loc)
        rowsum = ats_D.abs().sum(-1) + t_loc.abs().sum(-1) + E.abs().sum(-2)
        gersh = self.mesh.pmax(_lmax(rowsum))
        Dblk = d.H + ats_D
        if prox:
            eye = torch.eye(nb, dtype=Dblk.dtype, device=Dblk.device)
            Dblk = Dblk + eye / gamma[:, None, None, None]
        return Dblk, E, gersh


def _loop_body(mesh, d: StageScaled, scal: StageScaling,
               settings: Settings):
    """One reference iteration on every shard (mpc_loop.py:267-674)."""
    ops = _Ops(mesh, d)
    dtype = d.H.dtype
    prox = settings.proximal
    cfac = scal.c if settings.scaling else torch.ones((), dtype=dtype,
                                                      device=d.H.device)
    s = settings
    i32 = torch.int32

    def pvec(fn, vals):
        return fn(torch.stack(vals, -1)).unbind(-1)

    def iteration(st: _State) -> _State:
        b = lambda v, like: _bc(v, like)  # noqa: E731
        # ---- residuals (iteration.c:24-48) -------------------------------
        Aeq, Abox = ops.a(st.z)
        Axys_box = Abox + st.y_box / st.sig_box
        zcl_eq = d.beq
        zcl_box = torch.clamp(Axys_box, d.lo, d.hi)
        pri_eq = Aeq - zcl_eq
        pri_box = Abox - zcl_box
        yh_eq = st.y_eq + st.sig_eq * pri_eq
        yh_box = st.y_box + st.sig_box * pri_box
        Hz = ops.h(st.z)
        df = Hz + d.q
        if prox:
            df = df + (st.z - st.z0) / b(st.gamma, st.z)
        Atyh = ops.at(yh_eq, yh_box)
        dphi = df + Atyh

        # ---- termination (termination.c:44-129), scaled norms ------------
        Eeqi, Eboxi, Di = 1.0 / scal.Eeq, 1.0 / scal.Ebox, 1.0 / scal.D
        cinv = 1.0 / cfac
        dd_full = dphi - (st.z - st.z0) / b(st.gamma, st.z) if prox \
            else dphi
        Hz_prox = Hz + st.z / b(st.gamma, st.z) if prox else Hz
        dy_eq = yh_eq - st.y_eq
        dy_box = yh_box - st.y_box
        At_dy = Di * ops.at(dy_eq, dy_box)
        has_lb = d.lo > -C.QPALM_INFTY
        has_ub = d.hi < C.QPALM_INFTY
        dz = st.z - st.z_prev
        Ddz = scal.D * dz
        active_box = (Axys_box <= d.lo) | (Axys_box >= d.hi)
        ninf = torch.full_like(Abox, float("-inf"))
        mx = pvec(mesh.pmax, [
            _lmax((Eeqi * pri_eq).abs()),             # 0
            _lmax((Eboxi * pri_box).abs()),           # 1
            _lmax((Di * dd_full).abs()),              # 2
            _lmax((Di * dphi).abs()),                 # 3
            _lmax((Eeqi * Aeq).abs()),                # 4
            _lmax((Eboxi * Abox).abs()),              # 5
            _lmax((Eeqi * zcl_eq).abs()),             # 6
            _lmax((Eboxi * zcl_box).abs()),           # 7
            _lmax((Di * Hz_prox).abs()),              # 8
            _lmax((Di * d.q).abs()),                  # 9
            _lmax((Di * Atyh).abs()),                 # 10
            _lmax((scal.Eeq * dy_eq).abs()),          # 11
            _lmax((scal.Ebox * dy_box).abs()),        # 12
            _lmax(At_dy.abs()),                       # 13
            _lmax(Ddz.abs()),                         # 14
            _lmax(pri_eq.abs()),                      # 15 (unscaled)
            _lmax(pri_box.abs()),                     # 16
            _lmax((Eeqi * st.Ad_eq_t).abs()),         # 17
            _lmax(torch.where(has_ub, Eboxi * st.Ad_box_t, ninf)),     # 18
            _lmax(torch.where(has_lb, -(Eboxi * st.Ad_box_t), ninf)),  # 19
        ])
        zero = torch.zeros_like(dy_box)
        sm = pvec(mesh.psum, [
            _lsum(d.beq * dy_eq) + _lsum(
                torch.where(has_ub, d.hi * torch.clamp(dy_box, min=0.0),
                            zero)
                + torch.where(has_lb, d.lo * torch.clamp(dy_box, max=0.0),
                              zero)),                  # 0: out of bounds
            _lsum(Ddz * Ddz),                          # 1
            _lsum(dz * st.Hd_t),                       # 2
            _lsum(d.q * dz),                           # 3
            _lsum((active_box != st.active_old).to(dtype)),  # 4
        ])

        pri_norm = torch.maximum(mx[0], mx[1])
        dua_norm = mx[2] * cinv
        dua2_norm = mx[3] * cinv
        eps_pri = s.eps_abs + s.eps_rel * torch.maximum(
            torch.maximum(mx[4], mx[5]), torch.maximum(mx[6], mx[7]))
        max_norm = torch.maximum(mx[8], torch.maximum(mx[9], mx[10])) * cinv
        eps_dua = s.eps_abs + s.eps_rel * max_norm
        eps_dua_in = st.eps_abs_in + st.eps_rel_in * max_norm
        solved = (pri_norm < eps_pri) & (dua_norm < eps_dua)

        # ---- infeasibility certificates (termination.c:136-240) ----------
        eps_pinf_norm = s.eps_prim_inf * torch.maximum(mx[11], mx[12])
        pinf = ((eps_pinf_norm > 0) & (mx[13] <= eps_pinf_norm)
                & (sm[0] <= -eps_pinf_norm))
        eps_dinf_norm = s.eps_dual_inf * mx[14]
        bound_violation = ((mx[17] >= eps_dinf_norm)
                           | (mx[18] >= eps_dinf_norm)
                           | (mx[19] >= eps_dinf_norm))
        e2 = s.eps_dual_inf * s.eps_dual_inf
        curvature_ok = (sm[2] <= -cfac * e2 * sm[1]) | (
            (sm[2] <= cfac * e2 * sm[1]) & (sm[3] <= -cfac * eps_dinf_norm))
        dinf = (eps_dinf_norm > 0) & ~bound_violation & curvature_ok

        outer_trigger = (dua2_norm <= eps_dua_in) | (st.no_change == 3)
        exhausted = st.it == st.prev_it + s.inner_max_iter
        enter_leave = sm[4].to(i32)

        # ---- the four branches as selects --------------------------------
        do_term = (solved | pinf | dinf) & ~st.done
        live = ~st.done & ~do_term
        do_outer = live & outer_trigger
        do_exh = live & ~outer_trigger & exhausted
        do_inner = live & ~outer_trigger & ~exhausted
        do_sig = do_outer | do_exh

        # outer / exhausted: sigma update (iteration.c:86-145)
        pn_uns = torch.maximum(mx[15], mx[16])
        upd_sigma = do_sig & (st.it_out > 0) & (pri_norm > eps_pri)
        cond_eq = pri_eq.abs() > s.theta * st.pri_in_eq.abs()
        cond_box = (pri_box.abs() > s.theta * st.pri_in_box.abs()) \
            & active_box
        mult_eq = torch.clamp(s.delta * pri_eq.abs()
                              / b(pn_uns + 1e-6, pri_eq), min=1.0)
        mult_box = torch.clamp(s.delta * pri_box.abs()
                               / b(pn_uns + 1e-6, pri_box), min=1.0)
        sig_eq = torch.where(b(upd_sigma, cond_eq) & cond_eq, torch.clamp(
            mult_eq * st.sig_eq, max=s.sigma_max), st.sig_eq)
        sig_box = torch.where(b(upd_sigma, cond_box) & cond_box, torch.clamp(
            mult_box * st.sig_box, max=s.sigma_max), st.sig_box)
        y_eq = _sel(do_outer, yh_eq, st.y_eq)
        y_box = _sel(do_outer, yh_box, st.y_box)
        eps_abs_in = torch.where(do_outer, torch.clamp(
            s.rho * st.eps_abs_in, min=s.eps_abs), st.eps_abs_in)
        eps_rel_in = torch.where(do_outer, torch.clamp(
            s.rho * st.eps_rel_in, min=s.eps_rel), st.eps_rel_in)

        # proximal: gamma step / settled-active-set boost (qpalm.c:612-630)
        gamma, gmaxed = st.gamma, st.gamma_maxed
        active_old, nbch = st.active_old, st.nb_changed
        if prox:
            check = (do_outer & ~st.gamma_maxed & (st.it_out > 0)
                     & (st.nb_changed == 0) & (pri_norm < eps_pri))
            Axys2 = Abox + y_box / sig_box
            act2 = (Axys2 <= d.lo) | (Axys2 >= d.hi)
            nb2f, nact2f = pvec(mesh.psum, [
                _lsum((act2 != st.active_old).to(dtype)),
                _lsum(act2.to(dtype))])
            nb2, nact2 = nb2f.to(i32), nact2f.to(i32)
            boost = check & (nb2 == 0)
            boosted = torch.where(
                nact2 > 0, torch.clamp(1e14 / torch.clamp(st.gersh,
                                                          min=1e-30),
                                       min=s.gamma_max),
                torch.full_like(st.gamma, 1e12))
            stepped = torch.where(
                st.gamma < s.gamma_max,
                torch.clamp(st.gamma * s.gamma_upd, max=s.gamma_max),
                st.gamma)
            gamma = torch.where(do_outer, torch.where(boost, boosted,
                                                      stepped),
                                torch.where(do_exh, stepped, st.gamma))
            gmaxed = st.gamma_maxed | (boost & (nact2 > 0))
            active_old = _sel(check, act2, st.active_old)
            nbch = torch.where(check, torch.clamp(nb2, max=1),
                               st.nb_changed)
        z0 = _sel(do_sig, st.z, st.z0) if prox else st.z0
        pri_in_eq = _sel(do_sig, pri_eq, st.pri_in_eq)
        pri_in_box = _sel(do_sig, pri_box, st.pri_in_box)
        it_out = torch.where(do_sig, st.it_out + 1, st.it_out)
        prev_it = torch.where(do_sig, st.it, st.prev_it)
        no_change = torch.where(do_sig, torch.zeros_like(st.no_change),
                                st.no_change)

        # ---- inner: Newton by SPIKE, the gathered linesearch -------------
        sig_box_act = torch.where(active_box, sig_box,
                                  torch.zeros_like(sig_box))
        Dblk, Eblk, gersh = ops.blocks(sig_eq, sig_box_act, gamma, prox)
        dvec = spike_solve_local(mesh, Dblk, Eblk, -dphi)
        Hd = ops.h(dvec)
        Hd_prox = Hd + dvec / b(gamma, dvec) if prox else Hd
        eta, beta = pvec(mesh.psum, [_lsum(dvec * Hd_prox),
                                     _lsum(dvec * df)])
        Ad_eq, Ad_box = ops.a(dvec)
        sqrt_se, sqrt_sb = torch.sqrt(sig_eq), torch.sqrt(sig_box)
        L = dvec.shape[0]
        flat = lambda v: v.reshape(L, -1)  # noqa: E731
        s_ad = torch.cat([flat(sqrt_se * Ad_eq), flat(sqrt_sb * Ad_box)], -1)
        alpha_lo = torch.cat([
            flat((y_eq + sig_eq * (Aeq - d.beq)) / sqrt_se),
            flat((y_box + sig_box * (Abox - d.lo)) / sqrt_sb)], -1)
        alpha_hi = torch.cat([
            flat((-y_eq + sig_eq * (d.beq - Aeq)) / sqrt_se),
            flat((-y_box + sig_box * (d.hi - Abox)) / sqrt_sb)], -1)
        # one gather for both vectors, shard-major, eq rows before box rows
        both = mesh.all_gather(torch.stack(
            [torch.cat([-s_ad, s_ad], -1), torch.cat([alpha_lo, alpha_hi],
                                                     -1)], 1))
        tau = linesearch_from_breakpoints(
            eta[:1], beta[:1], both[:, 0].reshape(1, -1),
            both[:, 1].reshape(1, -1)).expand(L)

        z = _sel(do_inner, st.z + b(tau, dvec) * dvec, st.z)
        z_prev = _sel(do_inner, st.z, st.z_prev)
        Hd_t = _sel(do_inner, b(tau, Hd) * Hd, st.Hd_t)
        Ad_eq_t = _sel(do_inner, b(tau, Ad_eq) * Ad_eq, st.Ad_eq_t)
        Ad_box_t = _sel(do_inner, b(tau, Ad_box) * Ad_box, st.Ad_box_t)
        gersh = torch.where(do_inner, gersh, st.gersh)
        active_old = _sel(do_inner, active_box, active_old)
        nbch_new = torch.where(do_inner, torch.clamp(enter_leave, max=1),
                               nbch)
        # the stall counter reads the PREVIOUS Newton step's enter/leave
        # flag, the carried nb_changed (qpalm.c:664-665; mpc_loop.py:627-636)
        no_change = torch.where(
            do_inner, torch.where(st.nb_changed > 0,
                                  torch.zeros_like(no_change),
                                  no_change + 1), no_change)

        # certificates at termination (store_solution semantics)
        pcert = do_term & pinf & ~solved
        dy_eq_cert = _sel(pcert, scal.Eeq * (dy_eq / cfac), st.dy_eq_cert)
        dy_box_cert = _sel(pcert, scal.Ebox * (dy_box / cfac),
                           st.dy_box_cert)
        dz_cert = _sel(do_term & dinf & ~solved & ~pinf, scal.D * dz,
                       st.dz_cert)
        done = st.done | do_term
        code = torch.where(solved, C.QPALM_SOLVED, torch.where(
            pinf, C.QPALM_PRIMAL_INFEASIBLE, C.QPALM_DUAL_INFEASIBLE)) \
            .to(i32)
        status = torch.where(do_term, code, st.status)
        it = torch.where(done, st.it, st.it + 1)
        return _State(z, z0, z_prev, y_eq, y_box, sig_eq, sig_box,
                      pri_in_eq, pri_in_box, eps_abs_in, eps_rel_in,
                      active_old, gamma, gmaxed, gersh, nbch_new, no_change,
                      it, it_out, prev_it, done, status, Hd_t, Ad_eq_t,
                      Ad_box_t, dy_eq_cert, dy_box_cert, dz_cert, pri_norm,
                      dua_norm)

    return ops, iteration


def _shard(mesh, nt):
    return type(nt)(*(mesh.shard(t) if t.dim() else t for t in nt))


def solve_mpc_stage_sharded(data: MPCStageData, settings: Settings, mesh,
                            z0=None, y_eq0=None, y_box0=None) -> MPCResult:
    """Solve a stage-structured MPC QP with its horizon split over `mesh`
    (mpc_loop.py:681-857): proximal (with the gamma boost), Ruiz scaling,
    warm starts (`z0` / `y_eq0` / `y_box0`, unscaled (S, ...) numpy) and
    both infeasibility certificates, at float64.  S must be divisible by
    the mesh size.  Returns an MPCResult of tensors on the mesh's device
    (module docstring)."""
    S, nb = np.shape(data.q)
    nx = np.shape(data.beq)[-1]
    if S % mesh.size:
        raise ValueError(f"solve_mpc_stage_sharded: S = {S} stages over "
                         f"{mesh.size} shards")
    dev = mesh.device
    full = _tensors(stage_data_from(data), dev)
    if settings.scaling:
        scaled, scal = scale_stage_data(full, settings.scaling)
    else:
        scaled, scal = identity_stage_scaling(full)
    dd, ss = _shard(mesh, scaled), _shard(mesh, scal)
    kw = dict(dtype=torch.float64, device=dev)
    L = dd.q.shape[0]
    ops, iteration = _loop_body(mesh, dd, ss, settings)

    def warm(v, shape):
        return None if v is None else mesh.shard(torch.as_tensor(
            np.asarray(v, np.float64).reshape(shape), **kw))

    has_ws = z0 is not None or y_eq0 is not None or y_box0 is not None
    if has_ws:
        zw = warm(z0, (S, nb))
        yew = warm(y_eq0, (S, nx))
        ybw = warm(y_box0, (S, nb))
        zw = zw if zw is not None else torch.zeros_like(dd.q)
        yew = yew if yew is not None else torch.zeros_like(dd.beq)
        ybw = ybw if ybw is not None else torch.zeros_like(dd.q)
        cs = scal.c if settings.scaling else 1.0
        z = zw * (1.0 / ss.D)
        y_eq = yew * (1.0 / ss.Eeq) * cs
        y_box = ybw * (1.0 / ss.Ebox) * cs
    else:
        z = torch.zeros_like(dd.q)
        y_eq = torch.zeros_like(dd.beq)
        y_box = torch.zeros_like(dd.q)

    # initialize_sigma (iteration.c:50-84)
    Aeq0, Abox0 = ops.a(z)
    Hz0 = ops.h(z)
    Hz0p = Hz0 + z / settings.gamma_init if settings.proximal else Hz0
    psum = lambda v: mesh.psum(_lsum(v))  # noqa: E731
    f = 0.5 * psum(z * Hz0p) + psum(dd.q * z)
    dist2 = psum((Aeq0 - dd.beq) ** 2) + psum(
        (Abox0 - torch.clamp(Abox0, dd.lo, dd.hi)) ** 2)
    sig0 = torch.clamp(settings.sigma_init * torch.clamp(f.abs(), min=1.0)
                       / torch.clamp(0.5 * dist2, min=1.0), 1e-4, 1e4)

    rep = lambda v, dt=torch.float64: torch.full(  # noqa: E731
        (L,), v, dtype=dt, device=dev)
    zeros_eq = torch.zeros_like(dd.beq)
    st = _State(
        z=z, z0=z, z_prev=z, y_eq=y_eq, y_box=y_box,
        sig_eq=torch.ones_like(dd.beq) * sig0[:, None, None],
        sig_box=torch.ones_like(dd.q) * sig0[:, None, None],
        pri_in_eq=zeros_eq, pri_in_box=torch.zeros_like(dd.q),
        eps_abs_in=rep(settings.eps_abs_in),
        eps_rel_in=rep(settings.eps_rel_in),
        active_old=torch.zeros_like(dd.q, dtype=torch.bool),
        gamma=rep(settings.gamma_init), gamma_maxed=rep(False, torch.bool),
        gersh=rep(0.0), nb_changed=rep(1, torch.int32),
        no_change=rep(0, torch.int32), it=rep(0, torch.int32),
        it_out=rep(0, torch.int32), prev_it=rep(0, torch.int32),
        done=rep(False, torch.bool),
        status=rep(C.QPALM_UNSOLVED, torch.int32),
        Hd_t=torch.zeros_like(dd.q), Ad_eq_t=zeros_eq,
        Ad_box_t=torch.zeros_like(dd.q), dy_eq_cert=zeros_eq,
        dy_box_cert=torch.zeros_like(dd.q), dz_cert=torch.zeros_like(dd.q),
        pri_norm=rep(0.0), dua_norm=rep(0.0))

    k = 0
    while True:
        live = ~st.done & (st.it < settings.max_iter)
        if k % SYNC_STRIDE == 0 and not bool(live.any()):
            break
        nxt = iteration(st)
        st = _State(*(_sel(live, a, b_) for a, b_ in zip(nxt, st)))
        k += 1

    status = torch.where(st.done, st.status, torch.full_like(
        st.status, C.QPALM_MAX_ITER_REACHED))
    # unscale (termination.c:242-252); the multipliers are yh at the final
    # iterate, as store_solution computes them
    cinv = 1.0 / scal.c if settings.scaling else 1.0
    Aeqf, Aboxf = ops.a(st.z)
    yh_eq = st.y_eq + st.sig_eq * (Aeqf - dd.beq)
    yh_box = st.y_box + st.sig_box * (
        Aboxf - torch.clamp(Aboxf + st.y_box / st.sig_box, dd.lo, dd.hi))
    un = mesh.unshard
    return MPCResult(
        z=un(ss.D * st.z), y_eq=un(ss.Eeq * (cinv * yh_eq)),
        y_box=un(ss.Ebox * (cinv * yh_box)), status=status[0],
        iterations=st.it[0], pri_res_norm=st.pri_norm[0],
        dua_res_norm=st.dua_norm[0], delta_y_eq=un(st.dy_eq_cert),
        delta_y_box=un(st.dy_box_cert), delta_z=un(st.dz_cert))
