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


def _solve_in_kernel_order(R, b):
    """csrc/chol.cu's solve as scalar float32 steps, one column at a time:
    forward x_l -= y_j R_jl, then backward x_l /= R_ll and x_r -= R_rl x_l
    for r < l, l from n - 1 down."""
    f = np.float32
    x = b.astype(f).copy()
    B, n, k = x.shape
    for i in range(B):
        for c in range(k):
            v = x[i, :, c]
            for j in range(n):
                yj = f(v[j] / R[i, j, j])
                for l in range(j + 1, n):
                    v[l] = f(v[l] - f(yj * R[i, j, l]))
                v[j] = yj
            for l in range(n - 1, -1, -1):
                v[l] = f(v[l] / R[i, l, l])
                for r in range(l):
                    v[r] = f(v[r] - f(R[i, r, l] * v[l]))
    return x


@pytest.mark.parametrize("n", [1, 7, 16])
def test_solve_twin_sums_in_the_kernel_order(n):
    """The twin updates whole rows and columns at once; it rounds as the
    kernel's scalar steps do, bit for bit."""
    M = _spd_batch(2, n, seed=7)
    R = cholesky_upper_plain(torch.from_numpy(M))
    b = np.random.default_rng(8).standard_normal((2, n, 3)).astype(np.float32)
    got = cholesky_solve_plain(R, torch.from_numpy(b)).numpy()
    assert np.array_equal(got, _solve_in_kernel_order(R.numpy(), b))


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
    # K2b sums in the twin's order: bit for bit
    assert torch.equal(x, xp)


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
@pytest.mark.parametrize("B,n,k", [(512, 64, -1), (64, 64, 64), (37, 24, 7),
                                   (37, 100, 130), (9, 1, 1), (9, 1, 0),
                                   (37, 16, 5), (37, 120, 40), (37, 64, 0),
                                   (5, 64, 200), (37, 160, 64)])
def test_cuda_solve_is_bit_identical_to_plain(B, n, k):
    """K2b against its twin bit for bit: the blocked kernel (n a multiple
    of 8 whose plan fits, 32 or 64 columns a block) and the entry-by-entry
    one (n = 1, 100, and 160, whose blocked plan is over 227 KB); k = -1 is
    the polish's identity right-hand sides, k = 0 one vector."""
    dev = _cuda()
    R = cholesky_upper(torch.from_numpy(_spd_batch(B, n, seed=9)).to(dev))
    if k < 0:
        b = torch.eye(n, device=dev).expand(B, n, n).contiguous()
    else:
        rng = np.random.default_rng(10)
        b = torch.from_numpy(rng.standard_normal(
            (B, n) if k == 0 else (B, n, k)).astype(np.float32)).to(dev)
    before = cholesky_solve.launches
    x = cholesky_solve(R, b)
    assert cholesky_solve.launches == before + 1
    assert torch.equal(x, cholesky_solve_plain(R, b))


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    with pytest.raises(ValueError):
        cholesky_upper(torch.eye(4, dtype=torch.float64, device=dev)[None])
    with pytest.raises(ValueError):
        cholesky_upper(torch.eye(256, device=dev)[None])  # over 227 KB
