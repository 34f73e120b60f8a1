"""Kernel K2 (batched Cholesky factor and solve) of the PyTorch port: the
plain twin against numpy and against qpalm_tpu's Pallas kernels in
interpret mode (as tests/test_pallas.py:41-70 runs them), and the CUDA
kernel against its plain twin on a card."""

import numpy as np
import pytest
import torch

from qpalm_tpu_torch.linalg.chol import (cholesky_solve, cholesky_solve_plain,
                                         cholesky_upper, cholesky_upper_plain)


def _spd_batch(B, n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n)).astype(dtype)
    return M @ np.transpose(M, (0, 2, 1)) + n * np.eye(n, dtype=dtype)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [8, 16, 64])
def test_cholesky_plain_matches_numpy_and_pallas(n):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from qpalm_tpu.linalg.pallas_chol import _chol_pallas

    M = _spd_batch(4, n)
    R = cholesky_upper_plain(torch.from_numpy(M)).numpy()
    assert np.array_equal(R, np.triu(R))
    rel = np.max(np.abs(np.transpose(R, (0, 2, 1)) @ R - M)) / np.max(np.abs(M))
    assert rel < 1e-5
    Rj = np.asarray(_chol_pallas(jnp.asarray(M), interpret=True))
    assert np.max(np.abs(R - Rj)) / np.max(np.abs(Rj)) < 1e-5
    # the CPU wrapper is the plain twin
    assert np.array_equal(cholesky_upper(torch.from_numpy(M)).numpy(), R)


@pytest.mark.parametrize("n", [8, 16, 64])
def test_solve_plain_matches_pallas(n):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from qpalm_tpu.linalg.pallas_chol import _chol_pallas, _solve_pallas

    B = 4
    M = _spd_batch(B, n, seed=1)
    b = np.random.default_rng(2).standard_normal((B, n)).astype(np.float32)
    R = cholesky_upper_plain(torch.from_numpy(M))
    x = cholesky_solve(R, torch.from_numpy(b)).numpy()
    resid = np.einsum("bij,bj->bi", M.astype(np.float64), x) - b
    assert np.max(np.abs(resid)) < 1e-4
    Rj = _chol_pallas(jnp.asarray(M), interpret=True)
    xj = np.asarray(_solve_pallas(Rj, jnp.asarray(b), interpret=True))
    assert np.max(np.abs(x - xj)) / np.max(np.abs(xj)) < 1e-5


def test_solve_plain_identity_rhs_gives_inverse():
    B, n = 3, 16
    M = _spd_batch(B, n, seed=3)
    R = cholesky_upper_plain(torch.from_numpy(M))
    eye = torch.eye(n).expand(B, n, n).contiguous()
    Minv = cholesky_solve_plain(R, eye).numpy()
    err = np.einsum("bij,bjk->bik", M.astype(np.float64), Minv) - np.eye(n)
    assert np.max(np.abs(err)) < 1e-4
    # columns solved one at a time give the same numbers
    x0 = cholesky_solve_plain(R, eye[:, :, 0].contiguous()).numpy()
    assert np.allclose(x0, Minv[:, :, 0], rtol=0, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(64, 0), (64, 64), (24, 7), (100, 130)])
def test_cuda_kernels_match_plain(n, k):
    dev = _cuda()
    B = 37
    M = torch.from_numpy(_spd_batch(B, n, seed=4)).to(dev)
    R = cholesky_upper(M)
    Rp = cholesky_upper_plain(M)
    assert torch.equal(R, torch.triu(R))
    rel = ((R - Rp).abs().max() / Rp.abs().max()).item()
    assert rel < 1e-4, rel
    rng = np.random.default_rng(5)
    shape = (B, n) if k == 0 else (B, n, k)
    b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    x = cholesky_solve(R, b)
    xp = cholesky_solve_plain(R, b)
    rel = ((x - xp).abs().max() / xp.abs().max()).item()
    assert rel < 1e-4, rel


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 64, 241])
def test_cuda_factor_is_bit_identical_to_plain(n):
    """K2a keeps every entry's arithmetic of cholesky_upper_plain (the
    look-ahead only moves when row k + 1 is formed): bit for bit, up to the
    largest n whose matrix fits a block's shared memory."""
    dev = _cuda()
    M = torch.from_numpy(_spd_batch(9, n, seed=6)).to(dev)
    assert torch.equal(cholesky_upper(M), cholesky_upper_plain(M))


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    with pytest.raises(ValueError):
        cholesky_upper(torch.eye(4, dtype=torch.float64, device=dev)[None])
    with pytest.raises(ValueError):
        cholesky_upper(torch.eye(256, device=dev)[None])  # over 227 KB
