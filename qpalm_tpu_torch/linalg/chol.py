"""Kernel K2: batched unpivoted Cholesky factor and solve.

Replaces the Pallas kernels of qpalm_tpu/linalg/pallas_chol.py:
`_chol_kernel_loop` (factor, via `_chol_pallas`) and `_solve_kernel_loop`
(solve, via `_solve_pallas`).  The CUDA source is csrc/chol.cu; the plain
twins below follow the Pallas loops in the kernels' order of operations,
so that kernel and twin agree bit for bit, and are what a CPU tensor runs.

    cholesky_upper(M)      M (B, n, n) SPD f32 -> upper R with R'R = M
    cholesky_solve(R, b)   b (B, n) or (B, n, k) -> x with R'R x = b

Dispatch: a CPU tensor goes to the plain twin; a CUDA tensor goes to the
kernel, and an input the kernel does not take raises.  Each wrapper counts
its kernel launches in `.launches`.
"""

from __future__ import annotations

import torch

from .._build import check_launch, kernels

# Largest shared-memory plan one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448
_SOLVE_COLS = 64  # right-hand-side columns per block of the solve kernel
PANEL = 8  # rows of a panel of the blocked solve kernel (csrc/chol.cu)


def panel_smem_bytes(n: int, cols: int) -> int:
    """Shared memory of the blocked solve kernel (csrc/chol.cu,
    panel_smem_floats): R, its transpose and the columns, rows padded to
    n + 4 floats, and two 8-byte mbarriers."""
    return 4 * (n * n + (n + cols) * (n + 4)) + 16


def cholesky_upper_plain(M: torch.Tensor) -> torch.Tensor:
    """Outer-product recurrence of `_chol_kernel_loop`: for each k, scale
    row k by 1/sqrt(M[k,k]), subtract its outer product from the trailing
    block, and zero the lower triangle."""
    R = M.clone()
    n = M.shape[-1]
    for k in range(n):
        inv = 1.0 / torch.sqrt(R[:, k, k])
        row = R[:, k, :] * inv[:, None]
        rt = row[:, k + 1:]
        R[:, k + 1:, k + 1:] -= rt[:, :, None] * rt[:, None, :]
        R[:, k, k:] = row[:, k:]
    return torch.triu(R)


def cholesky_solve_plain(R: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`_solve_kernel_loop` in the kernel's order (csrc/chol.cu): forward
    substitution R'y = b in saxpy form over rows of R, then backward
    substitution R x = y in column form: x[l] = y[l] / R[l, l], then
    y[r] -= R[r, l] x[l] for every r < l, for l = n - 1 down to 0 (so row
    r's terms leave it from l = n - 1 down, each rounded)."""
    vec = b.dim() == 2
    y = (b[..., None] if vec else b).clone()
    n = R.shape[-1]
    for j in range(n):
        yj = y[:, j, :] / R[:, j, j, None]
        y[:, j + 1:, :] -= yj[:, None, :] * R[:, j, j + 1:, None]
        y[:, j, :] = yj
    for k in range(n - 1, -1, -1):
        xk = y[:, k, :] / R[:, k, k, None]
        y[:, :k, :] -= R[:, :k, k, None] * xk[:, None, :]
        y[:, k, :] = xk
    return y[..., 0] if vec else y


def _check_f32_cuda(name, t, ndims):
    if t.dtype != torch.float32 or t.dim() not in ndims or not t.is_cuda:
        raise ValueError(f"{name}: need a CUDA float32 tensor of "
                         f"{' or '.join(map(str, ndims))} dimensions, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def cholesky_upper(M: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor R (R'R = M) of a batch of SPD matrices."""
    if M.device.type == "cpu":
        return cholesky_upper_plain(M)
    _check_f32_cuda("cholesky_upper", M, (3,))
    B, n, n2 = M.shape
    if n != n2:
        raise ValueError(f"cholesky_upper: square matrices needed, got "
                         f"{tuple(M.shape)}")
    smem = n * n * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"cholesky_upper: n={n} needs {smem} bytes of "
                         f"shared memory, over {SMEM_LIMIT}")
    M = M.contiguous()
    R = torch.empty_like(M)
    with torch.cuda.device(M.device):
        rc = kernels().qp_chol(M.data_ptr(), R.data_ptr(), B, n,
                               torch.cuda.current_stream().cuda_stream)
    check_launch("qp_chol", rc)
    cholesky_upper.launches += 1
    return R


cholesky_upper.launches = 0


def cholesky_solve(R: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve R'R x = b given the upper factor R; b is (B, n) or (B, n, k)."""
    if R.device.type == "cpu":
        return cholesky_solve_plain(R, b)
    _check_f32_cuda("cholesky_solve", R, (3,))
    _check_f32_cuda("cholesky_solve", b, (2, 3))
    B, n, _ = R.shape
    if b.shape[:2] != (B, n):
        raise ValueError(f"cholesky_solve: b {tuple(b.shape)} does not match "
                         f"R {tuple(R.shape)}")
    k = 1 if b.dim() == 2 else b.shape[2]
    R = R.contiguous()
    b = b.contiguous()
    panel = False
    if n % PANEL == 0:
        # 32 columns a block where 64 would give fewer blocks than SMs
        sms = torch.cuda.get_device_properties(R.device).multi_processor_count
        cols = 64 if B * -(-k // 64) >= sms else 32
        panel = panel_smem_bytes(n, cols) <= SMEM_LIMIT
        if panel and R.data_ptr() % 16:  # R is read as float4
            R = R.clone()
    if not panel:
        cols = min(k, _SOLVE_COLS)
        smem = (n * n + n * cols) * 4
        if smem > SMEM_LIMIT:
            raise ValueError(f"cholesky_solve: n={n} needs {smem} bytes of "
                             f"shared memory, over {SMEM_LIMIT}")
    x = torch.empty_like(b)
    with torch.cuda.device(R.device):
        rc = kernels().qp_chol_solve(
            R.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, k, cols,
            int(panel), torch.cuda.current_stream().cuda_stream)
    check_launch("qp_chol_solve", rc)
    cholesky_solve.launches += 1
    return x


cholesky_solve.launches = 0
