"""Batched solves demo on the port (examples/batch_demo.py): 256 QPs in
one float32 batch (kernel K1), stragglers re-solved in float64
(batch.solve_batch_escalate).

    python -m qpalm_tpu_torch.examples.batch_demo [--device cuda|cpu]
        [--batch 256]
"""

import sys
import time

import numpy as np

from ..scripts._common import device, parser, sync


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)
    dev = device(args)
    from .. import Settings
    from ..batch import solve_batch_escalate

    rng = np.random.default_rng(0)
    problems = []
    for _ in range(args.batch):
        n, m = 16, 24
        M = rng.standard_normal((n, n))
        Q = M @ M.T / n + 0.1 * np.eye(n)
        A = rng.standard_normal((m, n))
        problems.append((Q, A, rng.standard_normal(n),
                         -2 * rng.random(m), 2 * rng.random(m)))

    settings = Settings(dtype="float32", eps_abs=1e-4, eps_rel=1e-4,
                        max_iter=200, delta=10.0, verbose=False)
    t0 = time.perf_counter()
    res = solve_batch_escalate(problems, settings, device=dev)
    sync(dev)
    dt = time.perf_counter() - t0
    solved = int((res.status.cpu().numpy() == 1).sum())
    print(f"{solved}/{len(problems)} solved in {dt:.2f}s "
          f"({len(problems)/dt:.0f} solves/s, includes the kernels' "
          f"first use)")
    print("iterations p50/p95:",
          np.percentile(res.iterations.cpu().numpy(), [50, 95]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
