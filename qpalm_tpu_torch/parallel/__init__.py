"""Distribution over a mesh of shards (counterpart of qpalm_tpu/parallel/).

* `mesh`          — the mesh and its collectives: `LocalMesh` (every shard
  on one device, the leading dimension of its tensors) and `DistMesh`
  (one shard a process over torch.distributed, gloo or NCCL);
* `sharded`       — data-parallel batch solves: each shard runs the
  general loop on its lanes; the aggregates ride one collective;
* `block_tridiag` — block Thomas and SPIKE for the stage-banded Newton
  systems of MPC ladders (the FACTORIZE_STAGE method of solver/core.py);
* `mpc_loop`      — the whole P-ALM loop stage-sharded: halo matvecs,
  SPIKE a Newton step, the gathered linesearch;
* `dryrun`        — the multi-process check: the three above over k gloo
  processes, bit for bit against `LocalMesh(k)`.

The reference's constraint sharding (`parallel/schur.py`,
`solve_constraint_sharded`) is not ported yet (ROADMAP.md).
"""

from .mesh import DistMesh, LocalMesh
from .mpc_loop import MPCStageData, from_mpc_chain, solve_mpc_stage_sharded
from .sharded import default_mesh, pad_batch_to_devices, solve_batch_sharded

__all__ = [
    "default_mesh",
    "pad_batch_to_devices",
    "solve_batch_sharded",
    "MPCStageData",
    "from_mpc_chain",
    "solve_mpc_stage_sharded",
    "LocalMesh",
    "DistMesh",
]
