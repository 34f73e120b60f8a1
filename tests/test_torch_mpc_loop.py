"""The stage-sharded P-ALM loop of the PyTorch port
(qpalm_tpu_torch/parallel/mpc_loop.py on a LocalMesh, K2's twins on the
CPU) against qpalm_tpu's solve_mpc_stage_sharded on the 8 virtual CPU
devices of tests/conftest.py: the seven tests of tests/test_mpc_loop.py,
each held to the reference's status and iteration count exactly and its
z within 1e-6."""

import numpy as np
import pytest

from qpalm_tpu_torch import Settings
from qpalm_tpu_torch import constants as C
from qpalm_tpu_torch.parallel import LocalMesh
from qpalm_tpu_torch.parallel.mpc_loop import (MPCStageData, from_mpc_chain,
                                               mpc_chain_stage_data,
                                               solve_mpc_stage_sharded,
                                               stage_data_from)
from qpalm_tpu_torch.workloads import mpc_chain, mpc_stage_permutation
import torch_support  # noqa: F401

Z_BAR = 1e-6


def _settings(proximal, scaling, **kw):
    return Settings(eps_abs=1e-6, eps_rel=1e-6, proximal=proximal,
                    scaling=scaling, verbose=False,
                    factorization_method=C.FACTORIZE_SCHUR, **kw)


def _reference(data, s, nd, **ws):
    """The JAX package's loop on the same numpy data and settings."""
    pytest.importorskip("jax")
    import dataclasses

    import qpalm_tpu
    from qpalm_tpu.parallel import default_mesh
    from qpalm_tpu.parallel import mpc_loop as J

    jd = J.MPCStageData(*(np.asarray(a) for a in data))
    return J.solve_mpc_stage_sharded(
        jd, qpalm_tpu.Settings(**dataclasses.asdict(s)),
        default_mesh(nd, axis_name="stage"), "stage", **ws)


def _held(res, ref, bar=Z_BAR):
    assert int(res.status) == int(ref.status)
    assert int(res.iterations) == int(ref.iterations), (
        int(res.iterations), int(ref.iterations))
    assert np.abs(res.z.numpy() - np.asarray(ref.z)).max() <= bar


@pytest.mark.parametrize("proximal,scaling", [
    (False, 0), (True, 0), (False, 2), (True, 2)])
def test_stage_sharded_matches_reference_settings_matrix(proximal, scaling):
    """tests/test_mpc_loop.py:40-60."""
    data = from_mpc_chain(*mpc_chain(4, 16, seed=0))
    s = _settings(proximal, scaling)
    res = solve_mpc_stage_sharded(data, s, LocalMesh(8, device="cpu"))
    assert int(res.status) == C.QPALM_SOLVED
    _held(res, _reference(data, s, 8))


def test_stage_sharded_proximal_small_gamma():
    """tests/test_mpc_loop.py:63-78: gamma_init 100 on 4 shards."""
    data = from_mpc_chain(*mpc_chain(4, 16, seed=1))
    s = _settings(True, 2, gamma_init=100.0, gamma_max=1e4)
    res = solve_mpc_stage_sharded(data, s, LocalMesh(4, device="cpu"))
    assert int(res.status) == C.QPALM_SOLVED
    _held(res, _reference(data, s, 4))


def test_stage_sharded_warm_start():
    """tests/test_mpc_loop.py:81-104: a warm start from the cold solution
    takes fewer iterations, each run as the reference's."""
    data = from_mpc_chain(*mpc_chain(3, 8, seed=2))
    s = _settings(True, 2)
    mesh = LocalMesh(8, device="cpu")
    cold = solve_mpc_stage_sharded(data, s, mesh)
    assert int(cold.status) == C.QPALM_SOLVED
    ws = dict(z0=cold.z.numpy(), y_eq0=cold.y_eq.numpy(),
              y_box0=cold.y_box.numpy())
    warm = solve_mpc_stage_sharded(data, s, mesh, **ws)
    assert int(warm.status) == C.QPALM_SOLVED
    assert int(warm.iterations) < int(cold.iterations)
    np.testing.assert_allclose(warm.z.numpy().ravel(),
                               cold.z.numpy().ravel(), atol=1e-4)
    ref_cold = _reference(data, s, 8)
    _held(cold, ref_cold)
    _held(warm, _reference(data, s, 8, z0=ws["z0"], y_eq0=ws["y_eq0"],
                           y_box0=ws["y_box0"]))


def test_stage_sharded_chain80w_scale():
    """tests/test_mpc_loop.py:107-121: the chain80w shape, 240 variables,
    horizon 80 on 8 shards, against the reference's loop and the port's
    sequential QPALM."""
    from qpalm_tpu_torch import QPALM

    H, A, q, bmin, bmax, meta = mpc_chain(1, 80, seed=0)
    assert H.shape[0] == 240
    data = from_mpc_chain(H, A, q, bmin, bmax, meta)
    s = _settings(False, 0)
    res = solve_mpc_stage_sharded(data, s, LocalMesh(8, device="cpu"))
    assert int(res.status) == C.QPALM_SOLVED
    _held(res, _reference(data, s, 8))
    perm = mpc_stage_permutation(meta["nx"], meta["nu"], meta["N"])
    seq = QPALM(H[np.ix_(perm, perm)], A[:, perm], q[perm], bmin, bmax,
                settings=s, device="cpu").solve()
    np.testing.assert_allclose(res.z.numpy().ravel(), seq.solution.x,
                               atol=1e-8)


def test_stage_sharded_primal_infeasible_certificate():
    """tests/test_mpc_loop.py:124-158: dynamics forcing x_1 far outside
    its box; the certificate meets the Farkas conditions."""
    H, A, q, bmin, bmax, meta = mpc_chain(1, 8, seed=1)
    nx, nu, N = meta["nx"], meta["nu"], meta["N"]
    data = from_mpc_chain(H, A, q, bmin, bmax, meta)
    beq = data.beq.copy()
    beq[0, :] = 50.0
    data = data._replace(beq=beq)
    for proximal, scaling in [(True, 2), (False, 0)]:
        s = _settings(proximal, scaling)
        res = solve_mpc_stage_sharded(data, s, LocalMesh(8, device="cpu"))
        assert int(res.status) == C.QPALM_PRIMAL_INFEASIBLE
        ref = _reference(data, s, 8)
        assert int(ref.status) == int(res.status)
        dy_eq = res.delta_y_eq.numpy().reshape(-1)
        dy_box = res.delta_y_box.numpy().reshape(-1)
        perm = mpc_stage_permutation(nx, nu, N)
        A_eq = np.asarray(A)[:meta["m_eq"]][:, perm]
        At_dy = A_eq.T @ dy_eq + dy_box
        scale = max(1.0, np.abs(dy_eq).max(), np.abs(dy_box).max())
        assert np.abs(At_dy).max() <= 1e-4 * scale


def test_stage_sharded_dual_infeasible_certificate():
    """tests/test_mpc_loop.py:161-183: zero Hessian, free boxes, a descent
    direction in the dynamics' nullspace."""
    data = from_mpc_chain(*mpc_chain(1, 8, seed=3))
    S, nb = data.q.shape
    data = MPCStageData(
        H=np.zeros_like(data.H), q=-np.ones((S, nb)),
        beq=np.zeros_like(data.beq), lo=np.full((S, nb), -np.inf),
        hi=np.full((S, nb), np.inf), Ad=data.Ad, Bd=data.Bd)
    s = _settings(True, 0)
    res = solve_mpc_stage_sharded(data, s, LocalMesh(8, device="cpu"))
    assert int(res.status) == C.QPALM_DUAL_INFEASIBLE
    assert int(_reference(data, s, 8).status) == int(res.status)
    dz = res.delta_z.numpy().reshape(-1)
    assert np.abs(dz).max() > 0
    assert float(np.dot(np.full(dz.shape, -1.0), dz)) < 0


def test_stage_data_direct_constructor_matches_dense_route():
    """tests/test_mpc_loop.py:186-199, and both routes bit-identical to
    the JAX package's."""
    pytest.importorskip("jax")
    from qpalm_tpu.parallel import mpc_loop as J

    for masses, horizon, seed in ((4, 16, 0), (10, 12, 3), (3, 7, 11)):
        dense = from_mpc_chain(*mpc_chain(masses, horizon, seed=seed))
        direct = mpc_chain_stage_data(masses, horizon, seed=seed)
        ref = stage_data_from(J.mpc_chain_stage_data(masses, horizon,
                                                     seed=seed))
        for field, a, b, c in zip(dense._fields, dense, direct, ref):
            assert a.shape == b.shape == c.shape, field
            assert np.array_equal(a, b) and np.array_equal(b, c), field
