"""The oscillating-masses MPC chain and its closed loop (the port's
workloads.mpc_chain and SequentialMPC) against qpalm_tpu.workloads', as
tests/test_workloads.py:45-60 drives them, on the CPU.  The generators are
copies and must give the same arrays; the closed loop runs QPALM on the
port's general loop and is held step by step at the f64 bar of
tests/test_torch_api.py."""

import numpy as np
import pytest

from qpalm_tpu_torch.workloads import (SequentialMPC, _chain_dynamics,
                                       mpc_chain, mpc_stage_permutation)
import torch_support  # noqa: F401


@pytest.mark.parametrize("n_masses,horizon", [(1, 3), (4, 8), (6, 20)])
def test_generators_equal_reference(n_masses, horizon):
    pytest.importorskip("jax")
    from qpalm_tpu import workloads as W

    for a, b in zip(_chain_dynamics(n_masses), W._chain_dynamics(n_masses)):
        np.testing.assert_array_equal(a, b)
    got, want = mpc_chain(n_masses, horizon, seed=3), \
        W.mpc_chain(n_masses, horizon, seed=3)
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(a, b)
    assert got[5].keys() == want[5].keys()
    for k in got[5]:
        np.testing.assert_array_equal(got[5][k], want[5][k])
    nx, nu = got[5]["nx"], got[5]["nu"]
    np.testing.assert_array_equal(mpc_stage_permutation(nx, nu, horizon),
                                  W.mpc_stage_permutation(nx, nu, horizon))


def test_mpc_chain_structure():
    """tests/test_workloads.py:45-51."""
    H, A, q, bmin, bmax, meta = mpc_chain(4, 8, seed=0)
    nx, nu, N = meta["nx"], meta["nu"], meta["N"]
    assert H.shape[0] == N * (nx + nu)
    assert A.shape[0] == meta["m_eq"] + N * (nx + nu)
    np.testing.assert_array_equal(bmin[:meta["m_eq"]], bmax[:meta["m_eq"]])
    perm = mpc_stage_permutation(nx, nu, N)
    assert sorted(perm.tolist()) == list(range(N * (nx + nu)))


def test_sequential_mpc_matches_reference():
    """tests/test_workloads.py:54-60: the closed loop stays bounded and the
    warm-started re-solves get cheaper; each step equal to the reference's
    (status, iterations, u0 and the plant's state)."""
    mpc = SequentialMPC(n_masses=4, horizon=8, seed=0, device="cpu")
    steps = [mpc.step() for _ in range(8)]
    iters = [it for _, it, _ in steps]
    assert all(st == "solved" for st, _, _ in steps)
    assert np.abs(mpc.x).max() < 4.0
    assert iters[-1] <= iters[0]
    assert max(iters[1:]) < 12 + iters[0]
    pytest.importorskip("jax")
    from qpalm_tpu.workloads import SequentialMPC as JSequentialMPC

    ref = JSequentialMPC(n_masses=4, horizon=8, seed=0)
    for k, (st, it, u0) in enumerate(steps):
        rst, rit, ru0 = ref.step()
        assert (st, it) == (rst, rit), k
        scale = np.maximum(1.0, np.abs(ru0))
        assert (np.abs(u0 - np.asarray(ru0)) / scale).max() <= 1e-8, k
    np.testing.assert_allclose(mpc.x, ref.x, rtol=0, atol=1e-8)
