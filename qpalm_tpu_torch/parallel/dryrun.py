"""The multi-process dry run (counterpart of __graft_entry__.
dryrun_multichip's parallel parts and scripts/multihost_dryrun.py):
data-parallel batches, SPIKE and the stage-sharded P-ALM loop over k
processes of `torch.distributed` (gloo on the CPU), each result held bit
for bit against the same run on `LocalMesh(k)`.

    from qpalm_tpu_torch.parallel.dryrun import dryrun_processes
    dryrun_processes(4, workdir)    # raises on any difference or hang

The processes are spawned (`torch.multiprocessing.start_processes`) and
meet through a `FileStore` in `workdir`, so no port is opened; the
process group and the join each wait at most `timeout` seconds, so that a
hang fails instead of blocking.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..batch import stack_problems
from ..types import Settings
from .block_tridiag import spike_solve, thomas_solve
from .mesh import DistMesh, LocalMesh
from .mpc_loop import mpc_chain_stage_data, solve_mpc_stage_sharded
from .sharded import solve_batch_sharded

__all__ = ["dryrun", "dryrun_processes", "compare"]


def _tiny_batch(batch, n, m, seed=0):
    """Random strictly convex QPs with a box on A x (the reference dry
    run's problems, scripts/multihost_dryrun.py:71-78)."""
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(batch):
        M = rng.standard_normal((n, n))
        probs.append((M @ M.T + 0.5 * np.eye(n), rng.standard_normal((m, n)),
                      rng.standard_normal(n), -0.5 * np.ones(m),
                      0.5 * np.ones(m)))
    return probs


def _block_tridiag(S, nb, seed):
    rng = np.random.default_rng(seed)
    D = np.zeros((S, nb, nb))
    E = np.zeros((S, nb, nb))
    for k in range(S):
        X = rng.standard_normal((nb, nb))
        D[k] = X @ X.T + 5 * np.eye(nb)
    for k in range(S - 1):
        E[k] = 0.3 * rng.standard_normal((nb, nb))
    return D, E, rng.standard_normal((S, nb))


def dryrun(mesh) -> dict:
    """Run the three parallel paths on `mesh` at a size of two lanes or
    stages a shard, checking each; returns this process's results as numpy,
    the keys of sharded results starting with "sharded_" (the whole of
    each on a LocalMesh, the rank's part on a DistMesh)."""
    k, dev = mesh.size, mesh.device
    out = {}
    # data-parallel batches: the general loop on each shard's lanes
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, scaling=2)
    data = stack_problems(_tiny_batch(2 * k, 8, 8), np.float64, device=dev)
    B, n = data.q.shape
    zx, zy = torch.zeros_like(data.q), torch.zeros_like(data.bmin)
    gam = torch.full((B,), s.gamma_init, dtype=torch.float64, device=dev)
    res, agg = solve_batch_sharded(data, zx, zy, gam, s, False, False, mesh)
    _, part = solve_batch_sharded(data, zx, zy, gam, s, False, False, mesh,
                                  aggregate=False)
    if int(agg["n_solved"]) != B:
        raise AssertionError(f"data-parallel dry run: {int(agg['n_solved'])}"
                             f"/{B} solved")
    for f in ("x", "status", "iterations"):
        out[f"sharded_dp_{f}"] = getattr(res, f).cpu().numpy()
    for f in agg:
        out[f"dp_{f}"] = agg[f].cpu().numpy()
        out[f"sharded_dp_part_{f}"] = part[f].cpu().numpy()

    # SPIKE against block Thomas
    D, E, b = (torch.from_numpy(a).to(dev) for a in _block_tridiag(
        2 * k, 4, seed=2))
    x_sp = spike_solve(D, E, b, mesh)
    x_th = mesh.unshard(mesh.shard(thomas_solve(D, E[:-1], b)))
    err = float((x_sp - x_th).abs().max())
    if err > 1e-10:
        raise AssertionError(f"SPIKE dry run: {err:.3e} from block Thomas")
    out["sharded_spike_x"] = x_sp.cpu().numpy()

    # the stage-sharded loop (proximal, scaling)
    r = solve_mpc_stage_sharded(
        mpc_chain_stage_data(2, 2 * k, seed=0),
        Settings(eps_abs=1e-6, eps_rel=1e-6, proximal=True, scaling=2), mesh)
    if int(r.status) != 1:
        raise AssertionError(f"stage loop dry run: status {int(r.status)}")
    for f in ("z", "y_eq", "y_box"):
        out[f"sharded_mpc_{f}"] = getattr(r, f).cpu().numpy()
    for f in ("status", "iterations", "pri_res_norm", "dua_res_norm"):
        out[f"mpc_{f}"] = getattr(r, f).cpu().numpy()
    return out


def compare(local: dict, got, rank: int, k: int) -> dict:
    """Hold rank `rank`'s dryrun results `got` (a DistMesh(k) run) bit for
    bit against `local` (LocalMesh(k)'s): the rank's slice of each sharded
    result, the whole of each replicated one.  Raises AssertionError;
    returns {key: True} for the keys compared."""
    if set(got) != set(local):
        raise AssertionError(f"rank {rank}: keys {sorted(got)}")
    for key, want in local.items():
        if key.startswith("sharded_"):
            m = want.shape[0] // k
            want = want[rank * m:(rank + 1) * m]
        have = got[key]
        if have.shape != want.shape or not np.array_equal(have, want):
            raise AssertionError(f"rank {rank} {key}: DistMesh({k}) differs "
                                 f"from LocalMesh({k}): {have} against "
                                 f"{want}")
    return {key: True for key in local}


def _worker(rank, k, workdir, timeout):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), k)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=k,
                            timeout=timedelta(seconds=timeout))
    try:
        out = dryrun(DistMesh(device="cpu"))
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def dryrun_processes(k: int, workdir, timeout: float = 60.0) -> dict:
    """`dryrun` on DistMesh over k spawned gloo processes and on
    LocalMesh(k) in this process; raises AssertionError where any result
    differs by a bit, TimeoutError where the processes take longer than
    `timeout` seconds.  Returns {key: True} for the keys compared."""
    workdir = str(workdir)
    ctx = torch.multiprocessing.start_processes(
        _worker, args=(k, workdir, timeout), nprocs=k, join=False,
        start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"dry run: {k} processes still running "
                               f"after {timeout} s")
    local = dryrun(LocalMesh(k, device="cpu"))
    checked = {}
    for rank in range(k):
        with np.load(os.path.join(workdir, f"rank{rank}.npz")) as got:
            checked.update(compare(local, dict(got), rank, k))
    return checked
