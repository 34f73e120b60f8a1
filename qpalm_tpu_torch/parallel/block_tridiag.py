"""Block-tridiagonal SPD solves: sequential block Cholesky-Thomas and
SPIKE with the stages partitioned over a mesh (counterpart of
qpalm_tpu/parallel/block_tridiag.py).

With the variables of a stage-structured MPC QP ordered by stage, the
P-ALM Schur matrix M = H + A' Sigma A is block-tridiagonal:
M = blocktridiag(D_0..D_{S-1}; E_0..E_{S-2}), D_k (nb, nb) SPD and E_k the
block (k + 1, k).  Every function here takes a leading batch dimension
(problems, or the shards of a mesh) or none.

* `thomas_factor` / `thomas_solve`: forward elimination stage by stage.
  Each eliminated block D^_k is factored by kernel K2a
  (`linalg.chol.cholesky_upper`, the upper R'R = D^_k that the general
  loop uses, where the reference takes jnp.linalg.cholesky's lower
  factor) and each stage's solves (W_k = D^_k^-1 E_k' with nb columns, the
  sweep's right-hand sides) run on K2b (`cholesky_solve`): on a card the
  CUDA kernels, on the CPU their twins.
* `spike_solve_local` / `spike_solve`: each shard factors its chunk of
  stages, solves for its boundary spikes, and the interface system is
  reduced by odd-even cyclic reduction over the mesh (a power-of-two
  shard count) or gathered and solved on every shard (any other count).
  Its small dense solves are `torch.linalg.solve` (LU with partial
  pivoting), library routines as in the reference, which took QR only
  because LU did not compile for its TPU (block_tridiag.py:144-149).
  One shard needs no interface: its solve is Thomas's.
"""

from __future__ import annotations

import torch

from ..linalg.chol import cholesky_solve, cholesky_upper
from ..solver.core import _sel

__all__ = ["thomas_factor", "thomas_solve", "spike_solve_local",
           "spike_solve", "extract_block_tridiag", "block_tridiag_error"]


def _batched(D, *rest):
    """Add a leading batch dimension where D has none."""
    if D.dim() == 3:
        return True, (D[None],) + tuple(None if t is None else t[None]
                                        for t in rest)
    return False, (D,) + rest


def thomas_factor(D: torch.Tensor, E: torch.Tensor):
    """Forward elimination (block_tridiag.py:50-79).  D: ([P,] S, nb, nb)
    diagonal blocks, E: ([P,] S-1, nb, nb), E[k] at block (k + 1, k).
    Returns (R, W): R[k] the upper factor of the eliminated block D^_k
    (R'R = D^_k) and W[k] = D^_k^-1 E_k' (W[S-1] = 0), for reuse across
    solves."""
    squeeze, (D, E) = _batched(D, E)
    S = D.shape[1]
    Rs, Ws = [], []
    schur = D[:, 0]
    for k in range(S - 1):
        Rk = cholesky_upper(schur)
        Wk = cholesky_solve(Rk, E[:, k].transpose(-1, -2))
        schur = D[:, k + 1] - E[:, k] @ Wk
        Rs.append(Rk)
        Ws.append(Wk)
    Rs.append(cholesky_upper(schur))
    Ws.append(torch.zeros_like(schur))
    R, W = torch.stack(Rs, 1), torch.stack(Ws, 1)
    return (R[0], W[0]) if squeeze else (R, W)


def thomas_solve(D: torch.Tensor, E: torch.Tensor, b: torch.Tensor,
                 factors=None) -> torch.Tensor:
    """Solve the block-tridiagonal SPD system M x = b (block_tridiag.py:
    82-119).  b: ([P,] S, nb) or ([P,] S, nb, k)."""
    squeeze, (D, E) = _batched(D, E)
    if squeeze:
        b = b[None]
        if factors is not None:
            factors = tuple(f[None] for f in factors)
    vec = b.dim() == 3
    if vec:
        b = b[..., None]
    S = D.shape[1]
    R, W = thomas_factor(D, E) if factors is None else factors
    # forward: z_k = D^_k^-1 (b_k - E_{k-1} z_{k-1})
    zs = [cholesky_solve(R[:, 0], b[:, 0])]
    for k in range(1, S):
        zs.append(cholesky_solve(R[:, k], b[:, k] - E[:, k - 1] @ zs[-1]))
    # backward: x_k = z_k - W_k x_{k+1}
    xs = [zs[-1]]
    for k in range(S - 2, -1, -1):
        xs.append(zs[k] - W[:, k] @ xs[-1])
    x = torch.stack(xs[::-1], 1)
    if vec:
        x = x[..., 0]
    return x[0] if squeeze else x


def _local_spikes(D, E, E_left, E_right, b):
    """Factor the local chunk and solve for [V | W | g] in one multi-column
    sweep (block_tridiag.py:122-141): A_d V = e_first E_left, A_d W =
    e_last E_right', A_d g = b."""
    L, S, nb = D.shape[:3]
    factors = thomas_factor(D, E)
    rhs = D.new_zeros((L, S, nb, 2 * nb + 1))
    rhs[:, 0, :, :nb] = E_left
    rhs[:, -1, :, nb:2 * nb] = E_right.transpose(-1, -2)
    rhs[..., 2 * nb] = b
    sol = thomas_solve(D, E, rhs, factors)
    return sol[..., :nb], sol[..., nb:2 * nb], sol[..., 2 * nb]


def _solve(B, X):
    """Solve B Z = X, batched (the reference's QR solve,
    block_tridiag.py:144-149)."""
    return torch.linalg.solve(B, X)


def _reduced_solve_cr(mesh, Vf, Vl, Wf, Wl, gf, gl):
    """Odd-even cyclic reduction of the SPIKE interface system over the
    mesh (block_tridiag.py:152-234), for a power-of-two shard count:
    log2(nd) rounds of shifts by 2^r.  Returns each shard's (x_first,
    x_last), each (L, nb)."""
    nd = mesh.size
    L, nb = Vf.shape[:2]
    two = 2 * nb
    idx = mesh.index
    eye = torch.eye(two, dtype=Vf.dtype, device=Vf.device).expand(L, two,
                                                                   two)
    B = eye
    C = Vf.new_zeros((L, two, two))
    C[:, :nb, nb:] = Vf
    C[:, nb:, nb:] = Vl
    F = Vf.new_zeros((L, two, two))
    F[:, :nb, :nb] = Wf
    F[:, nb:, :nb] = Wl
    g = torch.cat([gf, gl], -1)[..., None]
    levels = max(nd.bit_length() - 1, 0)

    def fetch(vals, s, direction):
        """The rows of shard idx - s (direction -1) or idx + s (+1); out
        of range, the no-op row B = I, C = F = 0, g = 0."""
        if direction < 0:
            valid = idx >= s
            got = [mesh.ppermute(v, s) for v in vals]
        else:
            valid = idx + s < nd
            got = [mesh.ppermute(v, -s) for v in vals]
        Bv, Cv, Fv, gv = got
        return (_sel(valid, Bv, eye), _sel(valid, Cv, torch.zeros_like(
            Cv)), _sel(valid, Fv, torch.zeros_like(Fv)),
            _sel(valid, gv, torch.zeros_like(gv)))

    for r in range(levels):
        s = 1 << r
        Bl, Cl, Fl, gl_ = fetch((B, C, F, g), s, -1)
        Br, Cr, Fr, gr_ = fetch((B, C, F, g), s, +1)
        CBl = C @ _solve(Bl, torch.cat([Fl, Cl, gl_], -1))
        FBr = F @ _solve(Br, torch.cat([Cr, Fr, gr_], -1))
        B_new = B - CBl[..., :two] - FBr[..., :two]
        C_new = -CBl[..., two:2 * two]
        F_new = -FBr[..., two:2 * two]
        g_new = g - CBl[..., 2 * two:] - FBr[..., 2 * two:]
        keep = (idx % (2 * s)) == 0
        B = _sel(keep, B_new, B)
        C = _sel(keep, C_new, C)
        F = _sel(keep, F_new, F)
        g = _sel(keep, g_new, g)

    u = _sel(idx == 0, _solve(B, g), torch.zeros_like(g))
    for r in range(levels - 1, -1, -1):
        s = 1 << r
        u_left = _sel(idx >= s, mesh.ppermute(u, s), torch.zeros_like(u))
        u_right = _sel(idx + s < nd, mesh.ppermute(u, -s),
                         torch.zeros_like(u))
        solver = (idx % (2 * s)) == s
        u_new = _solve(B, g - C @ u_left - F @ u_right)
        u = _sel(solver, u_new, u)
    u = u[..., 0]
    return u[:, :nb], u[:, nb:]


def _mv(M, v):
    """(L, S, r, c) x (L, S, c) -> (L, S, r)."""
    return (M @ v[..., None])[..., 0]


def spike_solve_local(mesh, D_loc, E_loc, b_loc):
    """The shard-local SPIKE solve (block_tridiag.py:237-325): D_loc,
    E_loc (L, S_loc, nb, nb), b_loc (L, S_loc, nb); E_loc[:, -1] couples a
    shard's last stage to the next shard's first (zero on the last
    shard).  Used by `spike_solve` and by the stage-sharded loop
    (parallel/mpc_loop.py).  On one shard there is no interface, and the
    solve is block Thomas's (the reference's x = g - V 0 - W 0)."""
    nd = mesh.size
    idx = mesh.index
    nb = D_loc.shape[-1]
    E_interior = E_loc[:, :-1]
    if nd == 1:
        return thomas_solve(D_loc, E_interior, b_loc)
    my_last_E = E_loc[:, -1]
    is_first = idx == 0
    is_last = idx == nd - 1
    E_left = _sel(is_first, torch.zeros_like(my_last_E),
                    mesh.ppermute(my_last_E, 1))
    E_right = _sel(is_last, torch.zeros_like(my_last_E), my_last_E)
    V, Wsp, g = _local_spikes(D_loc, E_interior, E_left, E_right, b_loc)

    if nd & (nd - 1) == 0:
        u_first, u_last = _reduced_solve_cr(
            mesh, V[:, 0], V[:, -1], Wsp[:, 0], Wsp[:, -1], g[:, 0],
            g[:, -1])
        x_last_prev = _sel(is_first, torch.zeros_like(u_last),
                             mesh.ppermute(u_last, 1))
        x_first_next = _sel(is_last, torch.zeros_like(u_first),
                              mesh.ppermute(u_first, -1))
        return g - _mv(V, x_last_prev[:, None]) - _mv(Wsp,
                                                      x_first_next[:, None])

    # any other shard count: gather the interface system and solve it,
    # the same on every shard
    bd = torch.stack([V[:, 0], V[:, -1], Wsp[:, 0], Wsp[:, -1]], 1)
    gb = torch.stack([g[:, 0], g[:, -1]], 1)
    all_bd = mesh.all_gather(bd)  # (nd, 4, nb, nb)
    all_gb = mesh.all_gather(gb)  # (nd, 2, nb)
    n_u = 2 * nd * nb
    R = D_loc.new_zeros((n_u, n_u))
    rhs = D_loc.new_zeros((n_u,))
    eye = torch.eye(nb, dtype=D_loc.dtype, device=D_loc.device)
    for d in range(nd):
        rf, rl = 2 * d * nb, (2 * d + 1) * nb
        R[rf:rf + nb, rf:rf + nb] = eye
        R[rl:rl + nb, rl:rl + nb] = eye
        if d > 0:
            cl = (2 * (d - 1) + 1) * nb
            R[rf:rf + nb, cl:cl + nb] += all_bd[d, 0]
            R[rl:rl + nb, cl:cl + nb] += all_bd[d, 1]
        if d < nd - 1:
            cf = 2 * (d + 1) * nb
            R[rf:rf + nb, cf:cf + nb] += all_bd[d, 2]
            R[rl:rl + nb, cf:cf + nb] += all_bd[d, 3]
        rhs[rf:rf + nb] = all_gb[d, 0]
        rhs[rl:rl + nb] = all_gb[d, 1]
    u = _solve(R, rhs[:, None])[:, 0].reshape(2 * nd, nb)
    zero = torch.zeros_like(g[:, 0])
    x_last_prev = _sel(is_first, zero, u[(2 * idx - 1).clamp(min=0)])
    x_first_next = _sel(is_last, zero,
                          u[torch.clamp(2 * (idx + 1), max=2 * nd - 1)])
    return g - _mv(V, x_last_prev[:, None]) - _mv(Wsp, x_first_next[:, None])


def spike_solve(D: torch.Tensor, E: torch.Tensor, b: torch.Tensor,
                mesh) -> torch.Tensor:
    """Block-tridiagonal solve with the stages split over `mesh`
    (block_tridiag.py:328-354).  D, E (S, nb, nb) global, E[k] at block
    (k + 1, k) (E[S-1] ignored), b (S, nb); S divisible by the mesh size.
    Returns x: the global (S, nb) on a LocalMesh, the rank's stages on a
    DistMesh."""
    if D.shape[0] % mesh.size:
        raise ValueError(f"spike_solve: S = {D.shape[0]} stages over "
                         f"{mesh.size} shards")
    x = spike_solve_local(mesh, mesh.shard(D), mesh.shard(E), mesh.shard(b))
    return mesh.unshard(x)


def extract_block_tridiag(M: torch.Tensor, nb: int):
    """(D, E) of a stage-ordered ([B,] n, n) matrix (block_tridiag.py:
    357-373): D ([B,] S, nb, nb), E ([B,] S, nb, nb) with E[k] = M's block
    (k + 1, k) and E[S-1] = 0."""
    n = M.shape[-1]
    S = n // nb
    Mb = M.reshape(M.shape[:-2] + (S, nb, S, nb)).transpose(-3, -2)
    ar = torch.arange(S, device=M.device)
    D = Mb[..., ar, ar, :, :]
    E = torch.zeros_like(D)
    E[..., :S - 1, :, :] = Mb[..., ar[1:], ar[:-1], :, :]
    return D, E


def block_tridiag_error(M: torch.Tensor, nb: int):
    """Max |entry| of M outside the block-tridiagonal band
    (block_tridiag.py:376-383)."""
    n = M.shape[-1]
    blk = torch.arange(n, device=M.device) // nb
    band = (blk[:, None] - blk[None, :]).abs() <= 1
    return torch.where(band, torch.zeros_like(M), M).abs().amax((-2, -1))
