"""The stage-structured path of the PyTorch port against qpalm_tpu's:
block Thomas and SPIKE (parallel/block_tridiag.py, on K2's plain twins on
the CPU) against the JAX functions on the 8 virtual CPU devices of
tests/conftest.py and against dense solves, FACTORIZE_STAGE through QPALM,
solve_batch and the closed-loop MPC against the JAX package's, as
tests/test_block_tridiag.py drives them; on a card, K2 at the stage
shapes bit for bit against its twins."""

import numpy as np
import pytest
import torch

from qpalm_tpu_torch import QPALM, Settings
from qpalm_tpu_torch import constants as C
from qpalm_tpu_torch.parallel import LocalMesh
from qpalm_tpu_torch.parallel.block_tridiag import (block_tridiag_error,
                                                    extract_block_tridiag,
                                                    spike_solve,
                                                    thomas_factor,
                                                    thomas_solve)
from qpalm_tpu_torch.workloads import (SequentialMPC, mpc_chain,
                                       mpc_stage_permutation)
from torch_support import _cuda


def _random_spd_tridiag(S, nb, seed=0):
    """tests/test_block_tridiag.py:18-33."""
    rng = np.random.default_rng(seed)
    D = np.zeros((S, nb, nb))
    E = np.zeros((S, nb, nb))
    for k in range(S):
        X = rng.standard_normal((nb, nb))
        D[k] = X @ X.T + 5 * np.eye(nb)
    for k in range(S - 1):
        E[k] = 0.5 * rng.standard_normal((nb, nb))
    M = np.zeros((S * nb, S * nb))
    for k in range(S):
        M[k * nb:(k + 1) * nb, k * nb:(k + 1) * nb] = D[k]
    for k in range(S - 1):
        M[(k + 1) * nb:(k + 2) * nb, k * nb:(k + 1) * nb] = E[k]
        M[k * nb:(k + 1) * nb, (k + 1) * nb:(k + 2) * nb] = E[k].T
    return D, E, M


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from qpalm_tpu.parallel import default_mesh
    from qpalm_tpu.parallel import block_tridiag as J

    return jnp, default_mesh, J


def test_thomas_matches_jax_and_dense():
    """tests/test_block_tridiag.py:36-41, one and several right-hand sides,
    with and without a leading batch dimension."""
    jnp, _, J = _jax()
    D, E, M = _random_spd_tridiag(12, 3, seed=1)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((12, 3))
    x = thomas_solve(_t(D), _t(E[:-1]), _t(b)).numpy()
    np.testing.assert_allclose(
        x, np.linalg.solve(M, b.ravel()).reshape(12, 3), atol=1e-10)
    xj = np.asarray(J.thomas_solve(jnp.asarray(D), jnp.asarray(E[:-1]),
                                   jnp.asarray(b)))
    np.testing.assert_allclose(x, xj, atol=1e-12)
    bk = rng.standard_normal((12, 3, 5))
    xk = thomas_solve(_t(D), _t(E[:-1]), _t(bk)).numpy()
    np.testing.assert_allclose(xk, np.asarray(J.thomas_solve(
        jnp.asarray(D), jnp.asarray(E[:-1]), jnp.asarray(bk))), atol=1e-12)
    # a batch dimension solves each problem as alone, bit for bit
    D2, E2, _ = _random_spd_tridiag(12, 3, seed=9)
    Db, Eb = _t(np.stack([D, D2])), _t(np.stack([E[:-1], E2[:-1]]))
    xb = thomas_solve(Db, Eb, _t(np.stack([b, b]))).numpy()
    assert np.array_equal(xb[0], x)
    R, W = thomas_factor(Db, Eb)
    assert R.shape == (2, 12, 3, 3) and torch.equal(R, torch.triu(R))
    assert np.array_equal(thomas_solve(Db, Eb, _t(np.stack([b, b])),
                                       (R, W)).numpy(), xb)


def test_spike_local_mesh_8_matches_jax():
    """tests/test_block_tridiag.py:44-53: LocalMesh(8) (cyclic reduction)
    against JAX spike_solve on 8 devices and a dense solve."""
    jnp, default_mesh, J = _jax()
    S, nb = 16, 4
    D, E, M = _random_spd_tridiag(S, nb, seed=3)
    b = np.random.default_rng(4).standard_normal((S, nb))
    x = spike_solve(_t(D), _t(E), _t(b), LocalMesh(8, device="cpu")).numpy()
    np.testing.assert_allclose(
        x, np.linalg.solve(M, b.ravel()).reshape(S, nb), atol=1e-10)
    xj = np.asarray(J.spike_solve(jnp.asarray(D), jnp.asarray(E),
                                  jnp.asarray(b),
                                  default_mesh(8, axis_name="stage"),
                                  "stage"))
    np.testing.assert_allclose(x, xj, atol=1e-12)


@pytest.mark.parametrize("nd,S,nb", [(3, 12, 4), (64, 128, 2)])
def test_spike_qr_fallback_and_cyclic_reduction(nd, S, nb):
    """nd = 3 takes the gathered QR solve of the interface; nd = 64 the
    cyclic reduction (tests/test_block_tridiag.py:93-140 at its size):
    both against a dense solve and block Thomas."""
    D, E, M = _random_spd_tridiag(S, nb, seed=nd)
    b = np.random.default_rng(nd + 1).standard_normal((S, nb))
    x = spike_solve(_t(D), _t(E), _t(b), LocalMesh(nd, device="cpu")).numpy()
    np.testing.assert_allclose(
        x, np.linalg.solve(M, b.ravel()).reshape(S, nb), atol=1e-10)
    xt = thomas_solve(_t(D), _t(E[:-1]), _t(b)).numpy()
    assert np.abs(x - xt).max() < 1e-8
    # one shard is block Thomas itself
    assert np.array_equal(spike_solve(_t(D), _t(E), _t(b),
                                      LocalMesh(1, device="cpu")).numpy(), xt)


def test_mpc_schur_is_block_tridiagonal():
    """tests/test_block_tridiag.py:93-121."""
    jnp, _, J = _jax()
    H, A, q, bmin, bmax, meta = mpc_chain(4, 8, seed=0)
    nx, nu, N = meta["nx"], meta["nu"], meta["N"]
    nb = nx + nu
    perm = mpc_stage_permutation(nx, nu, N)
    Hp, Ap = H[np.ix_(perm, perm)], A[:, perm]
    rng = np.random.default_rng(5)
    sigma = 1.0 + rng.random(A.shape[0])
    active = rng.random(A.shape[0]) < 0.7
    M = Hp + Ap.T @ (np.where(active, sigma, 0.0)[:, None] * Ap) \
        + 1e-7 * np.eye(Hp.shape[0])
    assert float(block_tridiag_error(_t(M), nb)) == 0.0
    assert float(block_tridiag_error(_t(M), nb - 1)) > 0.0
    D, E = extract_block_tridiag(_t(M), nb)
    Dj, Ej = J.extract_block_tridiag(jnp.asarray(M), nb)
    assert np.array_equal(D.numpy(), np.asarray(Dj))
    assert np.array_equal(E.numpy(), np.asarray(Ej))
    b = rng.standard_normal(M.shape[0])
    S = M.shape[0] // nb
    x_ref = np.linalg.solve(M, b).reshape(S, nb)
    x = thomas_solve(D, E[:-1], _t(b.reshape(S, nb))).numpy()
    np.testing.assert_allclose(x, x_ref, atol=1e-8)
    x_sp = spike_solve(D, E, _t(b.reshape(S, nb)),
                       LocalMesh(8, device="cpu")).numpy()
    np.testing.assert_allclose(x_sp, x_ref, atol=1e-8)


def _mpc_qp(masses, horizon, seed=0):
    H, A, q, bmin, bmax, meta = mpc_chain(masses, horizon, seed=seed)
    nx, nu, N = meta["nx"], meta["nu"], meta["N"]
    perm = mpc_stage_permutation(nx, nu, N)
    return (H[np.ix_(perm, perm)], A[:, perm], q[perm], bmin, bmax), nx + nu


def test_factorize_stage_matches_jax():
    """tests/test_block_tridiag.py:56-78: QPALM with FACTORIZE_STAGE on
    the stage-ordered chain against the JAX package's STAGE (equal status
    and iterations, x within 1e-10) and the port's dense SCHUR."""
    pytest.importorskip("jax")
    import qpalm_tpu

    p, nb = _mpc_qp(4, 10)
    base = dict(eps_abs=1e-6, eps_rel=1e-6, proximal=False, scaling=2,
                verbose=False)
    s = Settings(factorization_method=C.FACTORIZE_STAGE, stage_block=nb,
                 **base)
    r = QPALM(*p, settings=s, device="cpu").solve()
    rj = qpalm_tpu.QPALM(*p, settings=qpalm_tpu.Settings(
        factorization_method=C.FACTORIZE_STAGE, stage_block=nb,
        **base)).solve()
    assert r.info.status == rj.info.status == "solved"
    assert r.info.iter == rj.info.iter
    np.testing.assert_allclose(r.solution.x, rj.solution.x, atol=1e-10)
    rd = QPALM(*p, settings=Settings(**base), device="cpu").solve()
    np.testing.assert_allclose(r.solution.x, rd.solution.x, atol=1e-10)
    # the state keeps no factor: L is a dummy (1, 1, 1)
    assert tuple(r.state.L.shape) == (1, 1, 1)
    # solve_batch runs the same loop on a batch of one with exact shapes
    from qpalm_tpu_torch.batch import solve_batch

    b = solve_batch([p], s, pad_multiple=1, device="cpu")
    assert int(b.iterations[0]) == r.info.iter
    np.testing.assert_allclose(b.x[0].numpy(), r.solution.x, atol=1e-12)


def test_sequential_mpc_stage_structured_matches_jax():
    """tests/test_block_tridiag.py:81-90: SequentialMPC(3, 6) with and
    without the stage structure, against the JAX package's, step by
    step."""
    pytest.importorskip("jax")
    from qpalm_tpu.workloads import SequentialMPC as JSequentialMPC

    m1 = SequentialMPC(3, 6, seed=1, device="cpu")
    m2 = SequentialMPC(3, 6, seed=1, stage_structured=True, device="cpu")
    i1, i2 = m1.run(5), m2.run(5)
    assert i1 == i2
    np.testing.assert_allclose(m1.x, m2.x, atol=1e-8)
    ref = JSequentialMPC(3, 6, seed=1, stage_structured=True)
    assert ref.run(5) == i2
    np.testing.assert_allclose(m2.x, ref.x, atol=1e-10)


def test_stage_block_must_divide_n():
    p, nb = _mpc_qp(2, 3)
    for bad in (nb + 1, 2 * nb + 1):
        with pytest.raises(ValueError, match="stage_block"):
            QPALM(*p, settings=Settings(
                factorization_method=C.FACTORIZE_STAGE, stage_block=bad),
                device="cpu")
    with pytest.raises(ValueError, match="stage_block"):
        from qpalm_tpu_torch.batch import solve_batch

        solve_batch([p], Settings(factorization_method=C.FACTORIZE_STAGE,
                                  stage_block=nb), device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("B,nb,ks", [(8, 119, (119, 239)), (1, 29, (29, 1)),
                                     (1, 119, (119, 1)), (1, 17, (17, 1)),
                                     (3, 29, (29, 59))])
def test_cuda_k2_at_stage_shapes_is_bit_identical(B, nb, ks):
    """K2 at the stage shapes (factor (B, nb, nb), solves of the stage
    counts of columns: f64, odd nb, the warp plan) bit for bit against
    the twins, and block Thomas on the card against the CPU's."""
    from qpalm_tpu_torch.linalg import chol

    dev = _cuda()
    rng = np.random.default_rng(nb)
    G = rng.standard_normal((B, nb, nb))
    M = torch.from_numpy(G @ G.transpose(0, 2, 1) + nb * np.eye(nb)).to(dev)
    R = chol.cholesky_upper(M)
    assert torch.equal(R, chol.cholesky_upper_plain(M))
    for k in ks:
        b = torch.from_numpy(rng.standard_normal((B, nb, k))).to(dev)
        b = b[..., 0] if k == 1 else b
        assert torch.equal(chol.cholesky_solve(R, b),
                           chol.cholesky_solve_plain(R, b))
    D, E, M = _random_spd_tridiag(16, nb, seed=1)
    # couplings small enough for M to stay positive definite at any nb
    E = E / nb
    M = np.zeros_like(M)
    for k in range(16):
        M[k * nb:(k + 1) * nb, k * nb:(k + 1) * nb] = D[k]
    for k in range(15):
        M[(k + 1) * nb:(k + 2) * nb, k * nb:(k + 1) * nb] = E[k]
        M[k * nb:(k + 1) * nb, (k + 1) * nb:(k + 2) * nb] = E[k].T
    b = np.random.default_rng(2).standard_normal((16, nb))
    x = thomas_solve(_t(D).to(dev), _t(E[:-1]).to(dev), _t(b).to(dev))
    want = np.linalg.solve(M, b.ravel()).reshape(16, nb)
    assert np.abs(x.cpu().numpy() - want).max() <= 1e-9 * np.abs(want).max()
