"""Intra-QP parallelism: one QP with its constraint rows sharded over a mesh
(counterpart of qpalm_tpu/parallel/schur.py).

For one large QP the heavy operations are the Schur assembly
M = Q + A' diag(sigma active) A (reference: ldlcholQAtsigmaA,
solver_interface.c:372-405) and the A and A' products, all contractions
over the constraint dimension m.  With A's rows split over the mesh each
of them is a local block operation and one `psum`:

    A  : (m, n)  sharded by rows, (L, m / size, n) a shard's
    Ax : (m,)    sharded               (local product, no collective)
    A'y: (n,)    replicated            (psum of the local A_k' y_k)
    M  : (n, n)  replicated            (psum of the local B_k' B_k)

The reference lets XLA's SPMD partitioner insert these collectives into
its unchanged solver loop.  Here the port's general loop (solver/core.py)
takes a `RowSharded` A and routes each m-sized contraction through the
mesh: `_mtv` and the Schur assembly by `psum`, the inf-norms, sums and
counts over m by `pmax` or `psum` of the shards' partial values, and the
exact linesearch gathers its 2m breakpoints (`mesh.all_gather`) and runs
replicated.  The Newton step is SCHUR: M, n x n and replicated, is
factored by kernel K2a and solved by K2b (linalg/chol.py).

Written once against the mesh object (parallel/mesh.py): on
`LocalMesh(k)` the k shards are the leading dimension of one device's
tensors, on `DistMesh` one shard a process over torch.distributed (gloo
on the CPU, NCCL on cards), and a k-process run is bit for bit the same
as `LocalMesh(k)`.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..solver import core
from ..types import QPData, ScalingInfo, Settings, SolverState

__all__ = ["RowSharded", "sharded_schur_matrix", "solve_constraint_sharded"]

# the SolverState fields that are m-sized (split by rows over the mesh)
_M_FIELDS = ("y", "Ax", "Axys", "z", "pri_res", "pri_res_in", "yh", "Ad",
             "active", "active_old", "sigma", "sigma_inv", "sqrt_sigma",
             "delta_y")


class RowSharded:
    """A matrix whose rows are split over `mesh`: `local` (L, r / size, c)
    holds the shard's rows (L = mesh.local).  The products the general loop
    needs (solver/core.py: `_mv`, `_mtv`, the Schur assembly, the
    linesearch's gather) as methods; the loop tells it apart from a tensor
    by its `mesh`."""

    def __init__(self, local: torch.Tensor, mesh):
        self.local = local
        self.mesh = mesh

    def double(self) -> "RowSharded":
        return RowSharded(self.local.double(), self.mesh)

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        """A v for a replicated v (1, c): the shards' rows, (L, r_loc)."""
        return torch.matmul(self.local, v.unsqueeze(-1)).squeeze(-1)

    def tmv(self, w: torch.Tensor) -> torch.Tensor:
        """A' w for a sharded w (L, r_loc): the psum of the local
        A_k' w_k, (1, c)."""
        part = torch.matmul(self.local.transpose(-1, -2),
                            w.unsqueeze(-1)).squeeze(-1)
        return self.mesh.psum(part)[:1]

    def gram(self, w: torch.Tensor) -> torch.Tensor:
        """A' diag(w^2) A for a sharded w (L, r_loc): the psum of the local
        B_k' B_k, B_k = diag(w_k) A_k; (1, c, c)."""
        Bw = self.local * w[:, :, None]
        return self.mesh.psum(torch.bmm(Bw.transpose(1, 2), Bw))[:1]

    def gather(self, *vs: torch.Tensor):
        """Whole (1, r) rows of sharded (L, r_loc) vectors, in row order,
        by one all_gather."""
        g = self.mesh.all_gather(torch.stack(vs, 1))  # (size, len(vs), r_loc)
        return tuple(g.transpose(0, 1).reshape(len(vs), 1, -1).unbind(0))


def _rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """A whole (1, r, ...) tensor -> its shard's rows, (L, r / size, ...)."""
    return mesh.shard(t[0])


def _gather_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """Sharded (L, r_loc) -> the whole (r,) on every shard."""
    return mesh.all_gather(t).reshape(-1)


def sharded_schur_matrix(A, sqrt_sigma, active, mesh,
                         axis_name: str = "con") -> torch.Tensor:
    """A' diag(sigma active) A with A's rows split over `mesh`: the local
    B_k' B_k of each shard and one psum (schur.py:38-62).  `A` (m, n),
    `sqrt_sigma` (m,) and `active` (m,) are whole on every rank; m a
    multiple of the mesh size.  Returns (n, n), replicated.  The mesh has
    one unnamed axis: `axis_name` is accepted for the reference's
    signature and not read."""
    dev = mesh.device
    A = torch.as_tensor(A).to(dev)
    m = A.shape[0]
    if m % mesh.size:
        raise ValueError(f"sharded_schur_matrix: m = {m} rows over "
                         f"{mesh.size} shards")
    ss = torch.as_tensor(sqrt_sigma).to(device=dev, dtype=A.dtype)
    act = torch.as_tensor(active).to(device=dev, dtype=torch.bool)
    w = torch.where(mesh.shard(act), mesh.shard(ss),
                    torch.zeros((), dtype=A.dtype, device=dev))
    return RowSharded(mesh.shard(A), mesh).gram(w)[0]


def _sharded_problem(data: QPData, settings: Settings, mesh):
    """Scale and initialise the whole problem on every rank (so that each
    rank's scaling is bit for bit a LocalMesh's), then split its m-sized
    data, scaling and state by rows."""
    dev = mesh.device
    dtype = torch.as_tensor(data.Q).dtype
    whole = QPData(*(torch.as_tensor(t).to(device=dev, dtype=dtype)[None]
                     for t in data))
    st, sdata, scal = core.setup(whole, settings)
    sdata = QPData(Q=sdata.Q, A=RowSharded(_rows(mesh, sdata.A), mesh),
                   q=sdata.q, bmin=_rows(mesh, sdata.bmin),
                   bmax=_rows(mesh, sdata.bmax), c=sdata.c)
    scal = ScalingInfo(D=scal.D, Dinv=scal.Dinv, E=_rows(mesh, scal.E),
                       Einv=_rows(mesh, scal.Einv), c=scal.c, cinv=scal.cinv)
    st = SolverState(**{f: _rows(mesh, v) if f in _M_FIELDS else v
                        for f, v in st._asdict().items()})
    return st, sdata, scal


def solve_constraint_sharded(data: QPData, settings: Settings, mesh,
                             axis_name: str = "con"):
    """Solve one QP with its constraint dimension split over `mesh`
    (schur.py:97-112).  `data` is one unbatched problem (Q (n, n), A (m,
    n), q, bmin, bmax, c; numpy arrays or tensors), whole on every rank, in
    the dtype it comes in; m a multiple of the mesh size (pad with free
    rows, bounds -+1e21, otherwise).  The general loop runs with A, the
    bounds and every m-sized iterate split by rows; the Newton step is
    SCHUR (K2 on the card).  Verbose is off, as in the reference.

    Returns (x (n,), y (m,), status, iterations, objective), replicated,
    tensors on the mesh's device.  `axis_name` is accepted for the
    reference's signature; the mesh has one unnamed axis."""
    settings = settings.replace(verbose=False)
    data = QPData(*data)
    if settings.factorization_method in (C.FACTORIZE_KKT, C.FACTORIZE_CG,
                                         C.FACTORIZE_STAGE):
        raise ValueError("solve_constraint_sharded: the Newton step on "
                         "sharded rows is SCHUR (factorization_method "
                         f"{settings.factorization_method})")
    m = torch.as_tensor(data.A).shape[0]
    if m % mesh.size:
        raise ValueError(f"solve_constraint_sharded: m = {m} rows over "
                         f"{mesh.size} shards (pad with free rows)")
    st, sdata, scal = _sharded_problem(data, settings, mesh)
    final = core.solve_from_state(st, sdata, scal, settings)
    x, y, obj = core.finalize(final, sdata, scal, settings)
    return (x[0], _gather_rows(mesh, y), final.status[0], final.iter[0],
            obj[0])
