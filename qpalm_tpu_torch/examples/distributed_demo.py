"""Distribution demo on the port (examples/distributed_demo.py): the three
modes over a mesh of shards, on a `LocalMesh(8)`: eight shards on ONE
device (the leading dimension of its tensors), not eight devices.  The
same code runs one shard a process on a `DistMesh` (torch.distributed;
parallel/dryrun.py holds the two bit for bit).

  1. data parallel: a batch of QPs split over the shards
     (solve_batch_sharded);
  2. one QP with its constraint rows split over the shards
     (solve_constraint_sharded: A'y and the Schur matrix a psum);
  3. SPIKE: a block-tridiagonal system split by stages (spike_solve)
     against sequential block Thomas.

    python -m qpalm_tpu_torch.examples.distributed_demo [--device cuda|cpu]
        [--shards 8]
"""

import sys

import numpy as np

from ..scripts._common import device, parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--shards", type=int, default=8)
    args = ap.parse_args(argv)
    dev = device(args)
    import torch

    from .. import Settings
    from ..batch import pad_problem, stack_problems
    from ..parallel import (LocalMesh, solve_batch_sharded,
                            solve_constraint_sharded)
    from ..parallel.block_tridiag import spike_solve, thomas_solve

    k = args.shards
    mesh = LocalMesh(k, device=dev)
    print(f"mesh: {mesh}: {k} shards on one {dev.type} device, not "
          f"{k} devices")
    rng = np.random.default_rng(0)
    settings = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)

    # 1. data parallel: the batch split over the shards
    probs = []
    for _ in range(2 * k):
        M = rng.standard_normal((8, 8))
        probs.append((M @ M.T + 0.5 * np.eye(8), rng.standard_normal((12, 8)),
                      rng.standard_normal(8), -np.ones(12), np.ones(12)))
    data = stack_problems(probs, np.float64, device=dev)
    B = data.q.shape[0]
    gam = torch.full((B,), settings.gamma_init, dtype=torch.float64,
                     device=dev)
    res, agg = solve_batch_sharded(
        data, torch.zeros_like(data.q), torch.zeros_like(data.bmin), gam,
        settings, False, False, mesh)
    print(f"1. data-parallel batch: {int(agg['n_solved'])}/{B} solved, "
          f"{int(agg['total_iters'])} total iterations (one psum over the "
          f"shards)")

    # 2. one QP with its constraint rows split over the shards
    n, m = 12, 2 * k
    M = rng.standard_normal((n, n))
    Q = M @ M.T + 0.5 * np.eye(n)
    A = rng.standard_normal((m, n))
    d1 = pad_problem(Q, A, rng.standard_normal(n), -np.ones(m), np.ones(m),
                     16, m, np.float64) + (np.zeros(()),)
    x, y, status, iters, obj = solve_constraint_sharded(d1, settings, mesh)
    print(f"2. constraint-sharded single QP: status {int(status)}, "
          f"{int(iters)} iterations (A'y and the Schur matrix a psum over "
          f"the shards, K2 on the replicated Newton system)")

    # 3. SPIKE: the stage-partitioned block-tridiagonal solve
    S, nb = 2 * k, 4
    D = np.zeros((S, nb, nb))
    E = np.zeros((S, nb, nb))
    for i in range(S):
        X = rng.standard_normal((nb, nb))
        D[i] = X @ X.T + 5 * np.eye(nb)
    for i in range(S - 1):
        E[i] = 0.3 * rng.standard_normal((nb, nb))
    b = rng.standard_normal((S, nb))
    Dt, Et, bt = (torch.from_numpy(a).to(dev) for a in (D, E, b))
    x_sp = spike_solve(Dt, Et, bt, mesh)
    x_seq = thomas_solve(Dt, Et[:-1], bt)
    err = float((x_sp - x_seq).abs().max())
    print(f"3. SPIKE stage-partitioned solve over the shards: max diff vs "
          f"sequential Thomas = {err:.2e}")
    assert int(agg["n_solved"]) == B and int(status) == 1 and err < 1e-10
    return 0


if __name__ == "__main__":
    sys.exit(main())
