"""The large dense-QP pipeline of the port (qpalm_tpu_torch.large:
solve_batch at f32, the f64 host polish or the device polish, the
finisher) against qpalm_tpu.large, mirroring tests/test_large.py at small
sizes on the CPU (the plain twins of K2).

The f32 pass is held at the f32 bar (equal statuses and iteration counts,
|dx| < 1e-4 scaled); the certified f64 solutions, which both packages
polish to the same active set's KKT point, at |dx| <= 1e-8 scaled."""

import numpy as np
import pytest

from helpers import kkt_check
from qpalm_tpu_torch.large import solve_large_dense
from qpalm_tpu_torch.workloads import random_qp
from torch_support import _scaled


def test_pipeline_certifies_batch_as_reference():
    """tests/test_large.py:19-27 at n = 48, m = 72."""
    n, m = 48, 72
    probs = [random_qp(n, m, density=0.5, seed=s) for s in range(3)]
    r = solve_large_dense(probs, eps=1e-6, device="cpu")
    assert r.ok.all(), r.ok
    assert (r.status == 1).all()
    for i, p in enumerate(probs):
        kkt_check(p[0], p[1], p[2], p[3], p[4], r.x[i][:n], r.y[i][:m],
                  tol=1e-5)
    pytest.importorskip("jax")
    from qpalm_tpu.large import solve_large_dense as jlarge

    ref = jlarge(probs, eps=1e-6)
    np.testing.assert_array_equal(r.ok, np.asarray(ref.ok))
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    np.testing.assert_array_equal(r.iterations, np.asarray(ref.iterations))
    assert _scaled(np.asarray(ref.x), r.x).max() <= 1e-8
    assert _scaled(np.asarray(ref.objective), r.objective).max() <= 1e-8


def test_pipeline_objective_matches_f64_solve():
    """tests/test_large.py:30-41: the certified objective is the f64
    solve's."""
    from qpalm_tpu_torch import Settings, solve

    n, m = 32, 48
    p = random_qp(n, m, density=0.3, seed=11)
    r = solve_large_dense([p], eps=1e-6, device="cpu")
    assert r.ok[0]
    ref = solve(*p, settings=Settings(eps_abs=1e-9, eps_rel=1e-9,
                                      verbose=False), device="cpu")
    assert abs(r.objective[0] - ref.info.objective) <= 1e-5 * max(
        1.0, abs(ref.info.objective))


def test_failed_lane_is_flagged_not_lied_about():
    """tests/test_large.py:44-54: an infeasible problem cannot certify."""
    n = 8
    Q = np.eye(n)
    A = np.zeros((2, n))
    A[0, 0] = A[1, 0] = 1.0
    bmin = np.array([1.0, -np.inf])
    bmax = np.array([np.inf, 0.0])
    r = solve_large_dense([(Q, A, np.ones(n), bmin, bmax)], eps=1e-6,
                          device="cpu")
    assert not r.ok[0]
    assert r.status[0] == -3  # the f32 pass's primal infeasibility


def test_device_polish_certifies_as_host_polish():
    """device_polish=True: polish_device.polish_batch on the f64 data (its
    twin on the CPU), then the host retry; every lane certified, at the
    host polish's solutions."""
    n, m = 40, 60
    probs = [random_qp(n, m, density=0.5, seed=20 + s) for s in range(3)]
    host = solve_large_dense(probs, eps=1e-6, device="cpu")
    dev = solve_large_dense(probs, eps=1e-6, device_polish=True,
                            device="cpu")
    assert dev.ok.all() and host.ok.all()
    np.testing.assert_array_equal(dev.iterations, host.iterations)
    assert _scaled(host.x, dev.x).max() <= 1e-6
    for i, p in enumerate(probs):
        kkt_check(*p, dev.x[i][:n], dev.y[i][:m], tol=1e-5)
