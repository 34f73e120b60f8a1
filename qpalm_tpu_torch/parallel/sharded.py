"""Data-parallel batch solves over a mesh (counterpart of
qpalm_tpu/parallel/sharded.py).

The batch is split over the mesh's shards; each shard runs the port's
general loop (solver/core.py, kernel K2 inside) on its own lanes, the
counterpart of the reference's vmapped `_solve_one` under `shard_map`.
A finished lane is frozen, so no lane waits on another's.  On a
`LocalMesh` the shards share one device and one call of the loop; on a
`DistMesh` each rank solves its lanes.  The aggregates ride one
collective.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..batch import BatchResult
from ..solver import core
from ..types import QPData, Settings
from .mesh import default_mesh

__all__ = ["default_mesh", "pad_batch_to_devices", "solve_batch_sharded"]


def pad_batch_to_devices(data: QPData, n_devices: int):
    """Pad the batch up to a multiple of the mesh size with neutral dummy
    problems (unit Hessian, no constraints): (data, valid mask (B_pad,)
    numpy) (sharded.py:35-61)."""
    B = data.q.shape[0]
    B_pad = -(-B // n_devices) * n_devices
    if B_pad == B:
        return data, np.ones((B,), bool)
    k = B_pad - B
    n_pad, m_pad = data.q.shape[1], data.bmin.shape[1]
    kw = dict(dtype=data.Q.dtype, device=data.Q.device)
    eye = torch.eye(n_pad, **kw).expand(k, n_pad, n_pad)
    data = QPData(
        Q=torch.cat([data.Q, eye]),
        A=torch.cat([data.A, torch.zeros((k, m_pad, n_pad), **kw)]),
        q=torch.cat([data.q, torch.zeros((k, n_pad), **kw)]),
        bmin=torch.cat([data.bmin, torch.full((k, m_pad), -1e21, **kw)]),
        bmax=torch.cat([data.bmax, torch.full((k, m_pad), 1e21, **kw)]),
        c=torch.cat([data.c, torch.zeros((k,), **kw)]))
    mask = np.zeros((B_pad,), bool)
    mask[:B] = True
    return data, mask


def solve_batch_sharded(data: QPData, x_ws, y_ws, gamma, settings: Settings,
                        has_ws: bool, has_gamma: bool, mesh,
                        aggregate: bool = True):
    """Split the batch over `mesh` and solve (sharded.py:70-158).  `data`
    is the whole stacked batch (B divisible by the mesh size; see
    `pad_batch_to_devices`) on every rank; `x_ws` / `y_ws` unscaled warm
    starts (B, n) / (B, m) used when `has_ws`, `gamma` (B,) nonconvex pins
    used when `has_gamma`.

    Returns (BatchResult, aggregates): the results of the shards' lanes
    (the whole batch on a LocalMesh, the rank's lanes on a DistMesh) and
    {"n_solved", "total_iters", "max_iters"}: with `aggregate` one packed
    collective gives every shard the totals; without it each shard's own
    partials, (L,) (the caller reduces).  The general loop runs with
    `use_fused="never"` semantics: K1 takes no shard."""
    B = data.q.shape[0]
    if B % mesh.size:
        raise ValueError(f"solve_batch_sharded: a batch of {B} over "
                         f"{mesh.size} shards (pad_batch_to_devices)")
    dev = mesh.device

    def lanes(t):
        t = mesh.shard(torch.as_tensor(t).to(dev))
        return t.reshape((-1,) + tuple(t.shape[2:]))

    d = QPData(*(lanes(t) for t in data))
    settings = settings.replace(verbose=False)
    g = lanes(gamma) if has_gamma else None
    final, x, y, obj = core.full_solve(
        d, settings, lanes(x_ws) if has_ws else None,
        lanes(y_ws) if has_ws else None, g, g)
    res = BatchResult(x=x, y=y, status=final.status, iterations=final.iter,
                      objective=obj, pri_res_norm=final.pri_res_norm,
                      dua_res_norm=final.dua_res_norm)

    L = mesh.local
    status = final.status.reshape(L, -1)
    iters = final.iter.reshape(L, -1)
    n_solved = (status == C.QPALM_SOLVED).to(torch.int32).sum(-1)
    total_iters = iters.sum(-1)
    max_iters = iters.amax(-1)
    if aggregate:
        # ONE collective for the three: the two sums and a one-hot of each
        # shard's max in its slot, in the widest dtype taking part (a sum of
        # int32 counts must not wrap); the max over the summed slots is exact
        pdt = torch.promote_types(total_iters.dtype, torch.int32)
        slots = torch.arange(mesh.size, device=dev)
        onehot = torch.where(slots[None] == mesh.index[:, None],
                             max_iters[:, None].to(pdt),
                             torch.zeros((), dtype=pdt, device=dev))
        packed = mesh.psum(torch.cat([n_solved[:, None].to(pdt),
                                      total_iters[:, None].to(pdt), onehot],
                                     -1))[0]
        agg = {"n_solved": packed[0].to(torch.int32),
               "total_iters": packed[1].to(total_iters.dtype),
               "max_iters": packed[2:].amax().to(max_iters.dtype)}
    else:
        agg = {"n_solved": n_solved.to(torch.int32),
               "total_iters": total_iters, "max_iters": max_iters}
    return res, agg
