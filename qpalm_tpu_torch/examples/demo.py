"""Basic demo on the port (examples/demo.py): setup -> solve -> warm start
-> parametric update re-solve, the reference demos (examples/qpalm_demo.c,
interfaces/python/qpalm_python_demo.py) on api.QPALM.

    python -m qpalm_tpu_torch.examples.demo [--device cuda|cpu]
"""

import sys

import numpy as np

from ..scripts._common import device, parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = device(args)
    from .. import QPALM, Settings

    # the reference python demo problem (qpalm_python_demo.py:11-24)
    Q = np.array([[1.0, -1.0, 0.0], [-1.0, 2.0, 0.0], [0.0, 0.0, 0.0]])
    q = np.array([-2.0, -6.0, 1.0])
    A = np.array([[1.0, 1.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                  [0.0, 0.0, 1.0]])
    bmin = np.array([0.5, -10.0, -10.0, -10.0])
    bmax = np.array([0.5, 10.0, 10.0, 10.0])

    settings = Settings(eps_abs=1e-10, eps_rel=1e-10, verbose=True)
    solver = QPALM(Q, A, q, bmin, bmax, settings=settings, device=dev)
    res = solver.solve()
    print("x =", res.solution.x)
    assert np.allclose(res.solution.x, [5.5, 5.0, -10.0], atol=1e-5)

    # warm start with the solution: expect an immediate exit
    solver.warm_start(res.solution.x, res.solution.y)
    res2 = solver.solve()
    print("warm-started resolve iterations:", int(res2.info.iter))

    # parametric updates (reference demo lines 45-60)
    solver.update_bounds(bmin - 1.0, bmax + 1.0)
    solver.update_q(np.array([0.0, -3.0, 2.0]))
    res3 = solver.solve()
    print("after updates:", res3.info.status, "objective:",
          float(res3.info.objective))
    return 0


if __name__ == "__main__":
    sys.exit(main())
