"""Branch-and-bound mixed-integer QP demo on the port
(examples/branch_and_bound_demo.py): dual-objective termination and warm
starts doing the job they exist for.

The reference exposes `enable_dual_termination` "useful in branch and
bound" (reference src/qpalm.c:63) but ships no driver.  This is a
best-first B&B over binary variables whose node relaxations QPALM solves
with warm starts from the parent's solution and `dual_objective_limit` at
the incumbent (a node whose dual objective passes it exits early,
QPALM_DUAL_TERMINATED).  Problem: min 0.5 x'Qx + q'x s.t. sum(x) >= k,
x_i in {0, 1}; checked against brute-force enumeration.

    python -m qpalm_tpu_torch.examples.branch_and_bound_demo
        [--device cuda|cpu]
"""

import heapq
import itertools
import sys

import numpy as np

from ..scripts._common import device, parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = device(args)
    from .. import QPALM, Settings, constants as C

    rng = np.random.default_rng(7)
    n, k = 10, 3
    M = rng.standard_normal((n, n))
    Q = M @ M.T / n + 0.5 * np.eye(n)
    q = rng.standard_normal(n) - 0.2
    # rows: [sum(x) >= k ; identity boxes for the binaries]
    A = np.vstack([np.ones((1, n)), np.eye(n)])

    def solve_node(fixed, incumbent, warm):
        lo = np.array([float(k)]
                      + [float(fixed.get(i, 0.0)) for i in range(n)])
        hi = np.array([np.inf] + [float(fixed.get(i, 1.0)) for i in range(n)])
        s = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False,
                     enable_dual_termination=True,
                     dual_objective_limit=float(incumbent))
        solver = QPALM(Q, A, q, lo, hi, settings=s, device=dev)
        if warm is not None:
            solver.warm_start(warm[0], warm[1])
        r = solver.solve()
        return (r.info.status_val, float(r.info.objective),
                np.asarray(r.solution.x), np.asarray(r.solution.y),
                int(r.info.iter))

    incumbent, incumbent_x = np.inf, None
    nodes_solved = nodes_pruned = total_iters = 0
    # best-first queue: (parent bound, tiebreak, fixed assignment, warm)
    heap = [(-np.inf, 0, {}, None)]
    tiebreak = itertools.count(1)
    while heap:
        bound, _, fixed, warm = heapq.heappop(heap)
        if bound >= incumbent - 1e-9:
            nodes_pruned += 1
            continue
        status, obj, x, y, iters = solve_node(fixed, incumbent, warm)
        nodes_solved += 1
        total_iters += iters
        if status == C.QPALM_DUAL_TERMINATED:
            nodes_pruned += 1  # provably no improvement
            continue
        if status != C.QPALM_SOLVED or obj >= incumbent - 1e-9:
            nodes_pruned += 1
            continue
        frac = [i for i in range(n) if i not in fixed
                and min(x[i], 1.0 - x[i]) > 1e-6]
        if not frac:
            incumbent = obj
            incumbent_x = np.round(x).astype(int)
            continue
        i = max(frac, key=lambda j: min(x[j], 1.0 - x[j]))
        for v in (0.0, 1.0):
            child = dict(fixed)
            child[i] = v
            heapq.heappush(heap, (obj, next(tiebreak), child, (x, y)))

    best, best_x = np.inf, None
    for bits in itertools.product((0, 1), repeat=n):
        xv = np.array(bits, float)
        if xv.sum() < k:
            continue
        val = 0.5 * xv @ Q @ xv + q @ xv
        if val < best:
            best, best_x = val, np.array(bits, int)

    assert incumbent_x is not None
    # the incumbent is the relaxation's objective at eps 1e-6
    assert abs(incumbent - best) < 1e-5, (incumbent, best)
    assert (incumbent_x == best_x).all()
    print(f"optimal MIQP objective {incumbent:.6f} (matches brute force)")
    print(f"nodes solved: {nodes_solved}, pruned: {nodes_pruned}, "
          f"total QP iterations: {total_iters} (of {2 ** n} enumerations)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
