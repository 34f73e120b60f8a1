"""Kernel K2 (batched Cholesky factor and solve) of the PyTorch port: the
plain twin against numpy and against qpalm_tpu's Pallas kernels in
interpret mode (as tests/test_pallas.py:41-70 runs them), and the CUDA
kernel against its plain twin on a card."""

import numpy as np
import pytest
import torch

from qpalm_tpu_torch.linalg import chol
from qpalm_tpu_torch.linalg.chol import (cholesky_solve, cholesky_solve_plain,
                                         cholesky_upper, cholesky_upper_plain)
from torch_support import _cuda


def _spd_batch(B, n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n)).astype(dtype)
    return M @ np.transpose(M, (0, 2, 1)) + n * np.eye(n, dtype=dtype)


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
    """csrc/chol.cu's solve as scalar steps in b's precision, one column at a time:
    forward x_l -= y_j R_jl, then backward x_l /= R_ll and x_r -= R_rl x_l
    for r < l, l from n - 1 down."""
    f = np.float64 if b.dtype == np.float64 else np.float32
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
    """Types and shapes no plan takes raise; since the global plan, f64
    and n past shared memory are taken, and since the wide plans every n:
    a solve past the global plan's shared vectors runs (on a random upper
    R with a dominant diagonal) and is counted under the wide plan."""
    dev = _cuda()
    with pytest.raises(ValueError):
        cholesky_upper(torch.eye(4, dtype=torch.float16, device=dev)[None])
    with pytest.raises(ValueError):
        cholesky_upper(torch.eye(4, device=dev))  # not batched
    with pytest.raises(ValueError):
        cholesky_solve(torch.eye(4, device=dev)[None],
                       torch.ones((1, 4), dtype=torch.float64, device=dev))
    big = chol.SMEM_LIMIT // 16 + 1  # the global plan's vectors over 227 KB
    R = torch.triu(torch.rand((1, big, big), dtype=torch.float64,
                              device=dev))
    R.diagonal(dim1=1, dim2=2).fill_(big)
    b = torch.ones((1, big), dtype=torch.float64, device=dev)
    before = chol.KERNEL_LAUNCHES["chol_solve_global_wide_f64"]
    assert torch.equal(cholesky_solve(R, b), cholesky_solve_plain(R, b))
    assert chol.KERNEL_LAUNCHES["chol_solve_global_wide_f64"] == before + 1


@pytest.mark.parametrize("n,dtype,plan", [
    (64, torch.float32, "smem"), (241, torch.float32, "smem"),
    (242, torch.float32, "global"), (480, torch.float32, "global"),
    (64, torch.float64, "smem"), (170, torch.float64, "smem"),
    (171, torch.float64, "global"), (224, torch.float64, "global"),
    (3632, torch.float64, "global"), (3633, torch.float64, "wide"),
    (7264, torch.float32, "global"), (7265, torch.float32, "wide"),
    (chol.SMEM_LIMIT // 16 + 1, torch.float64, "wide")])
def test_factor_plan_selection(n, dtype, plan):
    """The factor keeps the matrix in shared memory while n x n elements
    fit 227 KB (f32 n <= 241, f64 n <= 170), else in global memory, with
    each CTA's panel in its shared memory while 8 rows fit (f32 n <= 7264,
    f64 n <= 3632), else in a global scratch: every n."""
    assert chol.factor_plan(n, dtype) == plan


@pytest.mark.parametrize("B,n,k,dtype,plan", [
    (512, 64, 1, torch.float32, ("panel", 64)),
    (64, 64, 1, torch.float32, ("panel", 32)),
    (64, 100, 130, torch.float32, ("entry", 64)),
    (64, 240, 1, torch.float32, ("entry", 1)),
    (64, 240, 64, torch.float32, ("global", 1)),
    (64, 480, 1, torch.float32, ("global", 1)),
    (512, 64, 1, torch.float64, ("warp", 1)),
    (512, 64, 64, torch.float64, ("warp", 16)),
    (64, 168, 1, torch.float64, ("warp", 1)),
    (64, 169, 1, torch.float64, ("warp", 1)),
    (64, 170, 1, torch.float64, ("warp", 1)),
    (1, 119, 1, torch.float64, ("warp", 1)),
    (1, 119, 119, torch.float64, ("warp", 1)),
    (8, 119, 119, torch.float64, ("warp", 4)),
    (8, 119, 239, torch.float64, ("warp", 8)),
    (1, 29, 29, torch.float64, ("warp", 1)),
    (64, 33, 1, torch.float64, ("warp", 1)),
    (2, 169, 7, torch.float64, ("warp", 1)),
    (100, 33, 3, torch.float64, ("warp", 2)),
    (132, 17, 17, torch.float64, ("warp", 16)),
    (64, 171, 1, torch.float64, ("global", 1)),
    (128, 224, 1, torch.float64, ("global", 1)),
    (64, 211, 211, torch.float32, ("entry", 64)),
    (64, 212, 212, torch.float32, ("global", 1)),
    (64, 480, 480, torch.float32, ("global", 1)),
    (64, 256, 256, torch.float32, ("global", 1)),
    (8, 200, 3, torch.float64, ("global", 1)),
    (8, 200, 1, torch.float64, ("global", 1)),
    (1, 14528, 1, torch.float64, ("wide", 1)),
    (1, 14529, 1, torch.float64, ("wide", 1)),
    (1, 16384, 2, torch.float32, ("wide", 1)),
    (1, 16385, 2, torch.float32, ("wide", 1)),
    (64, 14528, 1, torch.float64, ("global", 1)),
    (64, 14529, 1, torch.float64, ("wide", 1)),
    (64, 16384, 2, torch.float32, ("global", 1)),
    (64, 16385, 2, torch.float32, ("wide", 1)),
    (1, 479, 1, torch.float64, ("global", 1)),
    (1, 480, 1, torch.float64, ("wide", 1)),
    (4, 480, 4, torch.float32, ("wide", 1)),
    (4, 480, 5, torch.float32, ("global", 1))])
def test_solve_plan_selection(B, n, k, dtype, plan):
    """The solve: the blocked kernel for f32 n a multiple of 8 whose plan
    fits, a warp a column for every f64 solve whose R fits (any k, either
    parity of n; W warps a block: the most of 1, 2, 4, 8, 16, at most k,
    that leave B ceil(k / W) >= 132 blocks), else R and the columns in
    shared memory (f32), else global memory: the
    column and R's diagonal in shared memory while they fit and n <= 16384
    for more than 16 columns in all (or n < 480), else the wide plan (the
    stripe solve: every n, and at most 16 columns from n = 480 on, where
    it measured faster).  The global and warp plans count their one-vector
    solves and their solves of several columns (the polish's identity from
    f32 n = 212, the stage sweeps' nb columns) apart."""
    assert chol.solve_plan(B, n, k, dtype, sms=132) == plan
    if plan[0] in ("global", "warp"):
        assert chol.solve_kernel(plan[0], k, dtype) == (
            f"chol_solve_{plan[0]}" + ("_cols" if k > 1 else "")
            + ("_f64" if dtype == torch.float64 else ""))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int32])
def test_plans_raise_on_types_no_kernel_takes(dtype):
    with pytest.raises(ValueError, match="no kernel"):
        chol.factor_plan(8, dtype)
    with pytest.raises(ValueError, match="no kernel"):
        chol.solve_plan(1, 8, 1, dtype)


def test_dispatch_raises_rather_than_falls_back():
    """An input that is not on the CPU reaches a kernel or raises: with no
    kernel (a device that is not a card, a dtype) it raises before
    anything is built or launched, and never runs the twin or a library
    call (a meta tensor stands in for a card's).  At every n of a kernel's
    dtype a plan takes the input (the wide ones past the others)."""
    big = chol.SMEM_LIMIT // 16 + 1
    before = (cholesky_upper.launches, cholesky_solve.launches)
    M = torch.empty((2, big, big), dtype=torch.float64, device="meta")
    assert chol.solve_plan(2, big, 1, torch.float64) == ("wide", 1)
    assert chol.factor_plan(big, torch.float64) == "wide"
    with pytest.raises(ValueError):
        cholesky_upper(M)
    with pytest.raises(ValueError):
        cholesky_solve(M, torch.empty((2, big), dtype=torch.float64,
                                      device="meta"))
    with pytest.raises(ValueError):
        cholesky_upper(torch.empty((2, 8, 8), dtype=torch.float16,
                                   device="meta"))
    with pytest.raises(ValueError):
        cholesky_solve(torch.empty((2, 8, 8), device="meta"),
                       torch.empty((2, 8), dtype=torch.float64,
                                   device="meta"))
    assert (cholesky_upper.launches, cholesky_solve.launches) == before


@pytest.mark.parametrize("B,n,k", [(1, 29, 29), (3, 119, 5), (2, 17, 1),
                                   (8, 33, 4)])
def test_twin_solves_odd_n_several_columns_at_float64(B, n, k):
    """The twin at the shapes the f64 warp solve now takes (odd n, several
    columns): R'R x = b to 1e-12 at f64, each column equal to its own
    one-vector solve, bit for bit."""
    M = _spd_batch(B, n, seed=25 + n, dtype=np.float64)
    R = cholesky_upper_plain(torch.from_numpy(M))
    b = np.random.default_rng(26).standard_normal((B, n, k))
    x = cholesky_solve_plain(R, torch.from_numpy(b)).numpy()
    assert np.max(np.abs(M @ x - b)) < 1e-12 * np.abs(M).max() \
        * max(np.abs(x).max(), 1.0)
    for c in range(k):
        xc = cholesky_solve_plain(R, torch.from_numpy(b[:, :, c])).numpy()
        assert np.array_equal(xc, x[:, :, c])


@pytest.mark.parametrize("n", [8, 33])
def test_twins_at_float64(n):
    """The twins at f64: R'R = M to 1e-13, and R'R x = b to 1e-12; the
    solve rounds as the kernel's scalar steps do, bit for bit."""
    M = _spd_batch(3, n, seed=20, dtype=np.float64)
    R = cholesky_upper_plain(torch.from_numpy(M))
    assert R.dtype == torch.float64
    Rn = R.numpy()
    assert np.array_equal(Rn, np.triu(Rn))
    rel = np.max(np.abs(np.transpose(Rn, (0, 2, 1)) @ Rn - M)) / np.abs(M).max()
    assert rel < 1e-13
    b = np.random.default_rng(21).standard_normal((3, n, 2))
    x = cholesky_solve_plain(R, torch.from_numpy(b)).numpy()
    assert np.max(np.abs(M @ x - b)) < 1e-12 * np.abs(M).max()
    assert np.allclose(x, np.linalg.solve(M, b), rtol=1e-10, atol=1e-12)
    assert np.array_equal(x, _solve_in_kernel_order(Rn, b))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,dtype", [
    (37, 64, torch.float64), (9, 170, torch.float64),
    (9, 171, torch.float64), (9, 224, torch.float64),
    (9, 242, torch.float32), (5, 480, torch.float32), (3, 7, torch.float64),
    (3, 300, torch.float64),
    (1, 243, torch.float32), (3, 301, torch.float32),
    (64, 479, torch.float32), (200, 481, torch.float32),
    (200, 171, torch.float64), (64, 173, torch.float64),
    (1, 300, torch.float64), (3, 480, torch.float64),
    (64, 480, torch.float64), (200, 224, torch.float64)])
def test_cuda_factor_plans_are_bit_identical_to_plain(B, n, dtype):
    """K2a's f64 instantiation and its global-memory plan (the cluster
    factor, ragged tiles and last panels, one cluster and several waves)
    keep every entry's arithmetic of the twin: bit for bit."""
    dev = _cuda()
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    M = torch.from_numpy(_spd_batch(B, n, seed=22, dtype=np_dt)).to(dev)
    before = dict(chol.KERNEL_LAUNCHES)
    R = cholesky_upper(M)
    name = chol.KERNELS["factor", chol.factor_plan(n, dtype), dtype]
    assert chol.KERNEL_LAUNCHES[name] == before.get(name, 0) + 1
    assert R.dtype == dtype
    assert torch.equal(R, cholesky_upper_plain(M))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,k,dtype", [
    (37, 64, 0, torch.float64), (37, 64, 64, torch.float64),
    (9, 169, 0, torch.float64), (9, 170, 0, torch.float64),
    (9, 224, 3, torch.float64), (9, 240, 64, torch.float32),
    (5, 480, 0, torch.float32), (3, 7, 5, torch.float64),
    (3, 300, 2, torch.float64), (512, 64, 0, torch.float64),
    (1, 2, 0, torch.float64), (3, 168, 0, torch.float64),
    (200, 100, 0, torch.float64), (64, 9, 0, torch.float64),
    (64, 480, 0, torch.float64), (64, 480, 0, torch.float32),
    (3, 481, 0, torch.float64), (3, 483, 0, torch.float32),
    (4, 256, -1, torch.float32), (1, 8191, 0, torch.float64),
    (1, 8193, 0, torch.float64), (1, 16383, 0, torch.float32),
    (1, 16384, 0, torch.float32),
    (1, 119, 0, torch.float64), (1, 119, 119, torch.float64),
    (8, 119, 239, torch.float64), (1, 29, 0, torch.float64),
    (3, 29, 59, torch.float64), (1, 17, 0, torch.float64),
    (64, 33, 0, torch.float64), (2, 169, 0, torch.float64),
    (5, 31, 3, torch.float64), (5, 33, 3, torch.float64),
    (5, 63, 0, torch.float64), (5, 65, 2, torch.float64),
    (3, 169, 17, torch.float64), (64, 64, -1, torch.float64),
    (100, 33, 3, torch.float64)])
def test_cuda_solve_plans_are_bit_identical_to_plain(B, n, k, dtype):
    """K2b's f64 warp solve (a warp a column, any k and parity of n, W
    warps a block) and its global plan against the twin, bit for bit;
    k = 0 is one vector, k = -1 the polish's identity right-hand sides.
    The warp solve at the stage sweeps' shapes (odd nb: R staged as one
    span, an odd matrix's first entry 8 bytes off a 16-byte boundary), at
    E's edges n = 31, 33, 63, 65 and at several warps a block.  The global
    solve at the general loop's (64, 480), at odd n (rows of R not 16-byte
    aligned), at the identity's smallest global shape past f32 n = 211,
    and at n = 512 E +- 1 where E steps up to 32 (f64 8192, f32 16384,
    whose n + 1 takes the wide plan; a random upper R with a strong
    diagonal: no factor that large)."""
    dev = _cuda()
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    if n > 1000:
        g = torch.Generator(device=dev).manual_seed(23)
        R = torch.triu(torch.randn((B, n, n), generator=g, device=dev,
                                   dtype=dtype)) \
            + n * torch.eye(n, device=dev, dtype=dtype)
    else:
        R = cholesky_upper_plain(torch.from_numpy(
            _spd_batch(B, n, seed=23, dtype=np_dt)).to(dev))
    rng = np.random.default_rng(24)
    if k < 0:
        b = torch.eye(n, device=dev, dtype=dtype).expand(B, n, n).contiguous()
    else:
        b = torch.from_numpy(rng.standard_normal(
            (B, n) if k == 0 else (B, n, k)).astype(np_dt)).to(dev)
    cols = 1 if b.dim() == 2 else b.shape[2]
    name = chol.solve_kernel(chol.solve_plan(B, n, cols, dtype)[0], cols,
                             dtype)
    before = dict(chol.KERNEL_LAUNCHES)
    x = cholesky_solve(R, b)
    assert chol.KERNEL_LAUNCHES[name] == before.get(name, 0) + 1
    assert x.dtype == dtype
    assert torch.equal(x, cholesky_solve_plain(R, b))
