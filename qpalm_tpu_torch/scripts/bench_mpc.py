"""Sequential warm-started MPC benchmark (the chain80w protocol) on the port
(scripts/bench_mpc.py).

Reference: simulations/chain80w, 101 warm-started QPs, 240 variables, 709
constraints, horizon 80 (info.txt:16-24), eps 1e-6, scaling 2, proximal
off.  Here the oscillating-masses ladder at matched scale
(workloads.SequentialMPC), closed-loop solves/s and iteration statistics
for the dense (SCHUR, K2), the stage-structured (block Thomas, K2 a
stage) and the host sparse-LDL' Newton paths.  The first (cold) step is
excluded from the timing, as in the reference.

    python -m qpalm_tpu_torch.scripts.bench_mpc [--masses 6] [--horizon 20]
        [--steps 25] [--device cuda|cpu]
"""

import sys
import time

import numpy as np

from ._common import device, parser, sync


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--masses", type=int, default=6)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--steps", type=int, default=25)
    args = ap.parse_args(argv)
    dev = device(args)

    from ..workloads import SequentialMPC, mpc_chain

    H, A, _, _, _, meta = mpc_chain(args.masses, args.horizon)
    print(f"MPC ladder: {H.shape[0]} vars, {A.shape[0]} constraints, "
          f"horizon {args.horizon} (chain80w protocol: 240/709/80) "
          f"on {dev}")

    configs = [("dense-cholesky", {}),
               ("stage-thomas", {"stage_structured": True}),
               ("sparse-ldl", {"backend": "sparse"})]
    for label, kw in configs:
        mpc = SequentialMPC(args.masses, args.horizon, seed=0, device=dev,
                            **kw)
        mpc.step()  # the first (cold) solve, excluded
        sync(dev)
        t0 = time.perf_counter()
        iters = mpc.run(args.steps)
        sync(dev)
        dt = time.perf_counter() - t0
        print(f"{label:>15}: {args.steps/dt:6.1f} solves/s  "
              f"iters p50={np.median(iters):.0f} max={max(iters)}  "
              f"|x|={np.abs(mpc.x).max():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
