"""Kernel K2: batched unpivoted Cholesky factor and solve.

Replaces the Pallas kernels of qpalm_tpu/linalg/pallas_chol.py:
`_chol_kernel_loop` (factor, via `_chol_pallas`) and `_solve_kernel_loop`
(solve, via `_solve_pallas`).  The CUDA source is csrc/chol.cu; the plain
twins below follow the Pallas loops in the kernels' order of operations,
so that kernel and twin agree bit for bit, and are what a CPU tensor runs.

    cholesky_upper(M)      M (B, n, n) SPD -> upper R with R'R = M
    cholesky_solve(R, b)   b (B, n) or (B, n, k) -> x with R'R x = b

Both take float32 and float64, at any n.  Dispatch: a CPU tensor goes to
the plain twin; a CUDA tensor goes to a kernel, in the memory plan
`factor_plan` / `solve_plan` pick by n, dtype and SMEM_LIMIT: the matrix
in one block's shared memory where it fits (f32 n <= 241, f64 n <= 170
for the factor), else in global memory, in the same order of operations:
past shared memory the factor runs right-looking in panels across a
thread block cluster, in the shape `global_plan` picks, with each CTA's
panel in its shared memory while a panel of 8 rows fits there (f32 n <=
7264, f64 n <= 3632), else in a global scratch (the "wide" plans; the
solve's likewise past its vectors' shared memory or its ring's entries).
Only a dtype no kernel takes raises; nothing falls back to a library call
or to the twin.  Each wrapper counts its launches in `.launches`, and
`KERNEL_LAUNCHES` counts them by kernel (the names of KERNELS).
"""

from __future__ import annotations

import collections

import torch

from .._build import check_launch, kernels

# Largest shared-memory plan one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448
_SOLVE_COLS = 64  # right-hand-side columns per block of the solve kernel
PANEL = 8  # rows of a panel of the blocked solve kernel (csrc/chol.cu)
# the cluster factor (csrc/chol.cu, chol_cluster_kernel): tiles of the
# trailing triangle, threads a CTA, the largest cluster (the portable size)
CLUSTER_TILE = 8
CLUSTER_THREADS = 256
CLUSTER_MAX = 8


# launches by kernel: (factor or solve, plan, dtype) -> name
KERNELS = {
    ("factor", "smem", torch.float32): "chol",
    ("factor", "smem", torch.float64): "chol_f64",
    ("factor", "global", torch.float32): "chol_global",
    ("factor", "global", torch.float64): "chol_global_f64",
    # the cluster factor with its panels in a global scratch
    ("factor", "wide", torch.float32): "chol_global_wide",
    ("factor", "wide", torch.float64): "chol_global_wide_f64",
    ("solve", "smem", torch.float32): "chol_solve",
    ("solve", "smem", torch.float64): "chol_solve_f64",
    ("solve", "warp", torch.float64): "chol_solve_warp_f64",
    ("solve", "global", torch.float32): "chol_solve_global",
    ("solve", "global", torch.float64): "chol_solve_global_f64",
    # the global plan with several right-hand sides (the polish's identity)
    ("solve", "global_cols", torch.float32): "chol_solve_global_cols",
    ("solve", "global_cols", torch.float64): "chol_solve_global_cols_f64",
    # the global solve past its reach, any k (chol_solve_wide_kernel)
    ("solve", "wide", torch.float32): "chol_solve_global_wide",
    ("solve", "wide", torch.float64): "chol_solve_global_wide_f64",
}
KERNEL_LAUNCHES: collections.Counter = collections.Counter()

_ESIZE = {torch.float32: 4, torch.float64: 8}
_SOLVE_KINDS = {"entry": 0, "panel": 1, "warp": 2}  # qp_chol_solve's kind


def panel_smem_bytes(n: int, cols: int) -> int:
    """Shared memory of the blocked solve kernel (csrc/chol.cu,
    panel_smem_floats): R, its transpose and the columns, rows padded to
    n + 4 floats, and two 8-byte mbarriers."""
    return 4 * (n * n + (n + cols) * (n + 4)) + 16


WARP_N_MAX = 192  # the f64 one-vector solve: 6 entries a lane


def warp_smem_bytes(n: int) -> int:
    """Shared memory of the f64 one-vector solve (csrc/chol.cu,
    chol_solve_warp_kernel): R's n rows of doubles, n + 2 apart where n is
    a multiple of 4 (else n), and two 8-byte mbarriers."""
    return 8 * n * (n + 2 if n % 4 == 0 else n) + 16


def _esize(dtype, name) -> int:
    if dtype not in _ESIZE:
        raise ValueError(f"{name}: no kernel takes {dtype} (float32 and "
                         "float64 only)")
    return _ESIZE[dtype]


def global_smem_bytes(n: int, dtype, b: int) -> int:
    """The panel of a CTA of the cluster factor (csrc/chol.cu,
    cluster_smem_bytes), b rows of CLUSTER_TILE * ceil(n / CLUSTER_TILE)
    elements: its dynamic shared memory, or (a wide plan) its slice of the
    global scratch."""
    es = _esize(dtype, "cholesky_upper")
    return es * b * -(-n // CLUSTER_TILE) * CLUSTER_TILE


# the cluster factor's shape: CTAs a matrix, rows a panel, and where each
# CTA's panel lives, "smem" (its shared memory) or "global" (its slice of a
# scratch that the wrapper allocates: the wide plan)
GlobalPlan = collections.namedtuple("GlobalPlan", "cluster b panel",
                                    defaults=("smem",))
WIDE_B = 32  # rows a panel of the wide plan


def panel_scratch_bytes(B: int, n: int, dtype, plan: GlobalPlan) -> int:
    """Bytes of the global scratch the cluster factor's wide plan takes
    (csrc/chol.cu, launch_global): a panel for each of its B * cluster
    CTAs, CTA i's at byte i * global_smem_bytes; 0 for panels in shared
    memory."""
    if plan.panel != "global":
        return 0
    return B * plan.cluster * global_smem_bytes(n, dtype, plan.b)


# the global solve (csrc/chol.cu, chol_solve_global_kernel): threads a
# block at most, entries a thread at most (the C side checks both), and
# the bytes of R a thread that the threads are picked for
GS_THREADS_MAX, GS_E_MAX, GS_ENTRY_BYTES = 512, 32, 8
GS_N_MAX = GS_THREADS_MAX * GS_E_MAX


def global_solve_shape(n: int, dtype) -> tuple[int, int]:
    """(threads, E) of the global solve for n x n, any number of
    right-hand sides: a thread for each GS_ENTRY_BYTES of a row of R (n / 2
    at f32, n at f64), a multiple of 32 in [32, GS_THREADS_MAX], and E
    entries a thread, the least power of two with E threads >= n (at most
    GS_E_MAX, so n <= GS_N_MAX).  E is larger than GS_ENTRY_BYTES' worth
    only at GS_THREADS_MAX threads, which the kernel then takes as a
    constant.  The kernel's ring depth follows from E on the C side."""
    per = GS_ENTRY_BYTES // _esize(dtype, "cholesky_solve")
    nt = min(max(32, -(-n // (32 * per)) * 32), GS_THREADS_MAX)
    E = 1
    while E * nt < n:
        E *= 2
    return nt, E


def global_plan(B: int, n: int, dtype, sms: int = 132) -> GlobalPlan:
    """The cluster factor's shape for B matrices n x n past shared memory:
    the largest cluster C of 1, 2, 4 or 8 CTAs a matrix with B C <= sms
    (C = 1 past sms matrices), so that every matrix runs at once, one CTA
    an SM, and panels of 32 rows (16 or 8 where 32 do not fit a CTA's
    shared memory).  At the general loop's B = 64 that is 2 CTAs a matrix.
    Where not even a panel of 8 rows fits a CTA (f32 n > 7264, f64 n >
    3632) each CTA's panel of WIDE_B rows lives in a global scratch (the
    wide plan).  Raises ValueError only for a dtype no kernel takes."""
    C = max(c for c in (1, 2, 4, CLUSTER_MAX) if c == 1 or B * c <= sms)
    for b in (32, 16, 8):
        if global_smem_bytes(n, dtype, b) <= SMEM_LIMIT:
            return GlobalPlan(C, b)
    return GlobalPlan(C, WIDE_B, "global")


def factor_plan(n: int, dtype) -> str:
    """The factor's memory plan: "smem" while the n x n matrix fits one
    block's shared memory, else "global" (the cluster factor) while a CTA's
    shared memory holds a panel of 8 rows, else "wide" (the cluster factor,
    its panels in a global scratch); raises ValueError for a dtype no
    kernel takes."""
    es = _esize(dtype, "cholesky_upper")
    if n * n * es <= SMEM_LIMIT:
        return "smem"
    fits = global_smem_bytes(n, dtype, CLUSTER_TILE) <= SMEM_LIMIT
    return "global" if fits else "wide"


def solve_plan(B: int, n: int, k: int, dtype, sms: int = 132):
    """The solve's plan and right-hand-side columns a block, (plan, cols):
    "panel" (f32, n a multiple of PANEL, 32 or 64 columns: 32 where 64
    would leave some of the card's `sms` multiprocessors idle), "warp"
    (f64, one right-hand side, n even: a warp a matrix, R in shared
    memory), "entry" (R and up to 64 columns in shared memory: f64 with
    several columns or odd n, f32 n not a multiple of PANEL) or "global"
    (one column a block, the column and R's diagonal in shared memory,
    while they fit and n <= GS_N_MAX) or "wide" (one column a block, any
    n: R's diagonal through registers, the column in shared memory while
    it fits, else in x's); raises ValueError only for a dtype no kernel
    takes."""
    es = _esize(dtype, "cholesky_solve")
    if dtype == torch.float32 and n % PANEL == 0:
        cols = 64 if B * -(-k // 64) >= sms else 32
        if panel_smem_bytes(n, cols) <= SMEM_LIMIT:
            return "panel", cols
    if (dtype == torch.float64 and k == 1 and n % 2 == 0
            and n <= WARP_N_MAX and warp_smem_bytes(n) <= SMEM_LIMIT):
        return "warp", 1
    cols = min(k, _SOLVE_COLS)
    if (n * n + n * cols) * es <= SMEM_LIMIT:
        return "entry", cols
    # the global plan's two n-vectors in shared memory (f64 n <= 14528),
    # and at most GS_E_MAX entries of each a thread (n <= GS_N_MAX)
    if 2 * n * es <= SMEM_LIMIT and n <= GS_N_MAX:
        return "global", 1
    return "wide", 1


def solve_kernel(plan: str, k: int, dtype) -> str:
    """The name in KERNELS that a solve in `plan` with k right-hand sides
    counts under: the global plan's one-vector solves apart from its
    solves of several columns (the polish's identity)."""
    if plan == "global":
        key = "global_cols" if k > 1 else "global"
    elif plan == "wide":
        key = "wide"
    else:
        key = "warp" if plan == "warp" else "smem"
    return KERNELS["solve", key, dtype]


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


def _check_cuda(name, t, ndims, dtype=None):
    if (t.dtype not in _ESIZE or t.dim() not in ndims or not t.is_cuda
            or (dtype is not None and t.dtype != dtype)):
        want = "float32 or float64" if dtype is None else str(dtype)
        raise ValueError(f"{name}: need a CUDA {want} tensor of "
                         f"{' or '.join(map(str, ndims))} dimensions, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


# the cluster factor's sections, by its cycle counters
CLUSTER_SECTIONS = ("gather", "panel", "trailing", "cluster_wait", "write")


def _launch_global(M: torch.Tensor, R: torch.Tensor, plan: GlobalPlan,
                   prof: torch.Tensor | None = None) -> int:
    """Launch the cluster factor on contiguous CUDA M and R in the shape
    `plan` (a wide plan's panels in a scratch allocated here); returns the
    C entry point's error code.  prof, an int64 CUDA tensor of (B *
    plan.cluster, 8), runs the profiled instantiation, which takes each
    CTA's cycles by section (CLUSTER_SECTIONS, counted by its thread 0)."""
    B, n, _ = M.shape
    nbytes = panel_scratch_bytes(B, n, M.dtype, plan)
    # the stream orders the kernel before any reuse of the freed scratch
    pan = torch.empty(nbytes // M.element_size(), dtype=M.dtype,
                      device=M.device) if nbytes else None
    return kernels().qp_chol_global(
        M.data_ptr(), R.data_ptr(), B, n, int(M.dtype == torch.float64),
        plan.cluster, plan.b, None if pan is None else pan.data_ptr(),
        None if prof is None else prof.data_ptr(), _stream())


def cholesky_upper(M: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor R (R'R = M) of a batch of SPD matrices."""
    if M.device.type == "cpu":
        return cholesky_upper_plain(M)
    _check_cuda("cholesky_upper", M, (3,))
    B, n, n2 = M.shape
    if n != n2:
        raise ValueError(f"cholesky_upper: square matrices needed, got "
                         f"{tuple(M.shape)}")
    plan = factor_plan(n, M.dtype)
    gplan = None
    if plan != "smem":
        sms = torch.cuda.get_device_properties(
            M.device).multi_processor_count
        gplan = global_plan(B, n, M.dtype, sms)
    M = M.contiguous()
    if gplan is not None and M.data_ptr() % 16:  # read in 16-byte loads
        M = M.clone()
    R = torch.empty_like(M)
    with torch.cuda.device(M.device):
        if gplan is None:
            rc = kernels().qp_chol(M.data_ptr(), R.data_ptr(), B, n,
                                   int(M.dtype == torch.float64), _stream())
        else:
            rc = _launch_global(M, R, gplan)
    check_launch("qp_chol", rc)
    cholesky_upper.launches += 1
    KERNEL_LAUNCHES[KERNELS["factor", plan, M.dtype]] += 1
    return R


cholesky_upper.launches = 0


def cholesky_solve(R: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve R'R x = b given the upper factor R; b is (B, n) or (B, n, k),
    of R's dtype."""
    if R.device.type == "cpu":
        return cholesky_solve_plain(R, b)
    _check_cuda("cholesky_solve", R, (3,))
    _check_cuda("cholesky_solve", b, (2, 3), R.dtype)
    B, n, _ = R.shape
    if b.shape[:2] != (B, n):
        raise ValueError(f"cholesky_solve: b {tuple(b.shape)} does not match "
                         f"R {tuple(R.shape)}")
    k = 1 if b.dim() == 2 else b.shape[2]
    f64 = R.dtype == torch.float64
    sms = torch.cuda.get_device_properties(R.device).multi_processor_count
    plan, cols = solve_plan(B, n, k, R.dtype, sms)
    R = R.contiguous()
    b = b.contiguous()
    if plan in ("panel", "warp") and R.data_ptr() % 16:  # bulk copy, float4
        R = R.clone()
    x = torch.empty_like(b)
    with torch.cuda.device(R.device):
        lib = kernels()
        ptrs = (R.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, k)
        if plan == "global":
            rc = lib.qp_chol_solve_global(*ptrs,
                                          *global_solve_shape(n, R.dtype),
                                          int(f64), _stream())
        elif plan == "wide":
            rc = lib.qp_chol_solve_wide(*ptrs, int(f64), _stream())
        else:
            rc = lib.qp_chol_solve(*ptrs, cols, _SOLVE_KINDS[plan],
                                   int(f64), _stream())
    check_launch("qp_chol_solve", rc)
    cholesky_solve.launches += 1
    KERNEL_LAUNCHES[solve_kernel(plan, k, R.dtype)] += 1
    return x


cholesky_solve.launches = 0
