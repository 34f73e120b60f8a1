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
thread block cluster, in the shape `global_plan` picks, while a panel of 8
rows fits a CTA's shared memory (f32 n <= 7264, f64 n <= 3632), and past
that n across the whole card, one CTA an SM with a grid barrier a step
(the grid factor, the "wide" factor plan); the solve likewise, past its
vectors' shared memory or its ring's entries, cuts each column into
stripes, a CTA a stripe (the stripe solve, the "wide" solve plan).
Every f64 solve whose R fits shared memory (n <= 170), at any k and
either parity of n, is the warp solve: a warp a column, W warps a block
sharing one staged R (`warp_cols`).  Only a dtype no kernel takes
raises; nothing falls back to a library call or to the twin.  Each
wrapper counts its launches in `.launches`, `KERNEL_LAUNCHES` counts them
by kernel (the names of KERNELS) and `KERNEL_SHAPES` by kernel and
shape.  Counters (trace.py): "chol.plan.factor_<plan>" and
"chol.plan.solve_<plan>", one a call, by the plan that ran.
"""

from __future__ import annotations

import collections

import torch

from .. import trace
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
# the grid factor (chol_grid_kernel): threads a CTA, the panel rows it is
# instantiated for and the ones the plans take (GRID_B_WIDE past the
# cluster factor's limit, GRID_B below it); below that limit global_plan
# takes it for at most GRID_B_MAX matrices from GRID_N_MIN on: each where
# it measured faster (PERF.md, tools/chol_plans.py)
GRID_THREADS = 256
GRID_BS = (32, 64)
GRID_B, GRID_B_WIDE = 32, 64
GRID_B_MAX = 8
GRID_N_MIN = {torch.float32: 960, torch.float64: 640}
# the stripe solve (chol_solve_stripe_kernel): the stripe widths it is
# instantiated for and the one the plans take by dtype; below the global
# solve's limits solve_plan takes it for at most STRIPE_BK_MAX columns in
# all from n = STRIPE_N_MIN on, where it measured faster (PERF.md)
STRIPE_WS = (32, 64, 128)
STRIPE_W = {torch.float32: 64, torch.float64: 32}
STRIPE_BK_MAX = 16
STRIPE_N_MIN = 480


# launches by kernel: (factor or solve, plan, dtype) -> name
KERNELS = {
    ("factor", "smem", torch.float32): "chol",
    ("factor", "smem", torch.float64): "chol_f64",
    ("factor", "global", torch.float32): "chol_global",
    ("factor", "global", torch.float64): "chol_global_f64",
    # the grid factor (past the cluster factor's panel, and wherever
    # global_plan picks it)
    ("factor", "wide", torch.float32): "chol_global_wide",
    ("factor", "wide", torch.float64): "chol_global_wide_f64",
    ("solve", "smem", torch.float32): "chol_solve",
    # every f64 solve whose R fits shared memory: a warp a column, one
    # vector apart from several columns
    ("solve", "warp", torch.float64): "chol_solve_warp_f64",
    ("solve", "warp_cols", torch.float64): "chol_solve_warp_cols_f64",
    ("solve", "global", torch.float32): "chol_solve_global",
    ("solve", "global", torch.float64): "chol_solve_global_f64",
    # the global plan with several right-hand sides (the polish's identity)
    ("solve", "global_cols", torch.float32): "chol_solve_global_cols",
    ("solve", "global_cols", torch.float64): "chol_solve_global_cols_f64",
    # the stripe solve (past the global solve's reach, and wherever
    # solve_plan picks it), any k
    ("solve", "wide", torch.float32): "chol_solve_global_wide",
    ("solve", "wide", torch.float64): "chol_solve_global_wide_f64",
}
KERNEL_LAUNCHES: collections.Counter = collections.Counter()
# launches by kernel and shape: (name, B, n, k), k None for a factor
KERNEL_SHAPES: collections.Counter = collections.Counter()

_ESIZE = {torch.float32: 4, torch.float64: 8}
_SOLVE_KINDS = {"entry": 0, "panel": 1, "warp": 2}  # qp_chol_solve's kind


def panel_smem_bytes(n: int, cols: int) -> int:
    """Shared memory of the blocked solve kernel (csrc/chol.cu,
    panel_smem_floats): R, its transpose and the columns, rows padded to
    n + 4 floats, and two 8-byte mbarriers."""
    return 4 * (n * n + (n + cols) * (n + 4)) + 16


# the f64 warp solve (csrc/chol.cu, chol_solve_warp_kernel): 6 entries a
# lane, a warp a column, WARP_W the warps a block it takes
WARP_N_MAX = 192
WARP_W = (1, 2, 4, 8, 16)


def warp_smem_bytes(n: int) -> int:
    """Shared memory of the f64 warp solve (csrc/chol.cu, warp_smem): R's
    n rows of doubles, n + 2 apart where n is a multiple of 4 (else n),
    one double more for a span staged an entry on, and two 8-byte
    mbarriers."""
    return 8 * (n * (n + 2 if n % 4 == 0 else n) + 1) + 16


def warp_cols(B: int, k: int, sms: int = 132) -> int:
    """W, the warps (columns) a block of the f64 warp solve: the most of
    WARP_W, at most k, that still gives B ceil(k / W) >= sms blocks, so
    that the card fills while as few blocks as that stage each matrix's R
    (1 where even a warp a block leaves SMs idle)."""
    return max(w for w in WARP_W if w == 1 or (w <= k and B * -(-k // w)
                                               >= sms))


def _esize(dtype, name) -> int:
    if dtype not in _ESIZE:
        raise ValueError(f"{name}: no kernel takes {dtype} (float32 and "
                         "float64 only)")
    return _ESIZE[dtype]


def global_smem_bytes(n: int, dtype, b: int) -> int:
    """The panel of a CTA of the cluster factor (csrc/chol.cu,
    cluster_smem_bytes), b rows of CLUSTER_TILE * ceil(n / CLUSTER_TILE)
    elements: its dynamic shared memory."""
    es = _esize(dtype, "cholesky_upper")
    return es * b * -(-n // CLUSTER_TILE) * CLUSTER_TILE


# the cluster factor's shape: CTAs a matrix (a cluster) and rows a panel;
# the grid factor's: CTAs in all (one an SM) and rows a panel
GlobalPlan = collections.namedtuple("GlobalPlan", "cluster b")
GridPlan = collections.namedtuple("GridPlan", "ctas b")


def stripe_sync_ints(B: int, n: int, k: int, w: int) -> int:
    """The stripe solve's tickets and flags (csrc/chol.cu,
    chol_solve_stripe_kernel), zeroed by the wrapper: for each pass and
    each of the B k columns a ticket and a flag a stripe of w entries."""
    return 2 * B * k * (-(-n // w) + 1)


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


def global_plan(B: int, n: int, dtype, sms: int = 132):
    """The factor's plan for B matrices n x n past shared memory: the
    cluster factor, GlobalPlan(C, b), the largest cluster C of 1, 2, 4 or 8
    CTAs a matrix with B C <= sms (C = 1 past sms matrices), so that every
    matrix runs at once, one CTA an SM, and panels of b = 32 rows (16 or 8
    where 32 do not fit a CTA's shared memory); at the general loop's B =
    64 that is 2 CTAs a matrix.  The grid factor, the card's sms CTAs
    shared out over the matrices: GridPlan(sms, GRID_B_WIDE) where not
    even a panel of 8 rows fits a CTA (f32 n > 7264, f64 n > 3632), and
    GridPlan(sms, GRID_B) for at most GRID_B_MAX matrices from GRID_N_MIN
    on.  Raises ValueError only for a dtype no kernel takes."""
    if global_smem_bytes(n, dtype, 8) > SMEM_LIMIT:
        return GridPlan(sms, GRID_B_WIDE)
    if B <= GRID_B_MAX and n >= GRID_N_MIN[dtype]:
        return GridPlan(sms, GRID_B)
    C = max(c for c in (1, 2, 4, CLUSTER_MAX) if c == 1 or B * c <= sms)
    b = next(b for b in (32, 16, 8)
             if global_smem_bytes(n, dtype, b) <= SMEM_LIMIT)
    return GlobalPlan(C, b)


def factor_plan(n: int, dtype) -> str:
    """The factor's memory plan: "smem" while the n x n matrix fits one
    block's shared memory, else "global" (global_plan's) while a CTA's
    shared memory holds a panel of 8 rows of the cluster factor, else
    "wide" (the grid factor); raises ValueError for a dtype no kernel
    takes."""
    es = _esize(dtype, "cholesky_upper")
    if n * n * es <= SMEM_LIMIT:
        return "smem"
    fits = global_smem_bytes(n, dtype, CLUSTER_TILE) <= SMEM_LIMIT
    return "global" if fits else "wide"


def solve_plan(B: int, n: int, k: int, dtype, sms: int = 132):
    """The solve's plan and right-hand-side columns a block, (plan, cols):
    "panel" (f32, n a multiple of PANEL, 32 or 64 columns: 32 where 64
    would leave some of the card's `sms` multiprocessors idle), "warp"
    (f64, any k and either parity of n up to WARP_N_MAX while R fits
    shared memory, n <= 170: a warp a column, warp_cols(B, k, sms) warps a
    block sharing R), "entry" (f32 n not a multiple of PANEL: R and up to
    64 columns in shared memory) or "global"
    (one column a block, the column and R's diagonal in shared memory,
    while they fit and n <= GS_N_MAX) or "wide" (the stripe solve: a CTA a
    stripe of STRIPE_W entries of each column, every n and k past those,
    and at most STRIPE_BK_MAX columns in all from STRIPE_N_MIN on); raises
    ValueError only for a dtype no kernel takes."""
    es = _esize(dtype, "cholesky_solve")
    if dtype == torch.float32 and n % PANEL == 0:
        cols = 64 if B * -(-k // 64) >= sms else 32
        if panel_smem_bytes(n, cols) <= SMEM_LIMIT:
            return "panel", cols
    if (dtype == torch.float64 and n <= WARP_N_MAX
            and warp_smem_bytes(n) <= SMEM_LIMIT):
        return "warp", warp_cols(B, k, sms)
    cols = min(k, _SOLVE_COLS)
    if (n * n + n * cols) * es <= SMEM_LIMIT:
        return "entry", cols
    # the global plan's two n-vectors in shared memory (f64 n <= 14528),
    # and at most GS_E_MAX entries of each a thread (n <= GS_N_MAX)
    few = B * k <= STRIPE_BK_MAX and n >= STRIPE_N_MIN
    if 2 * n * es <= SMEM_LIMIT and n <= GS_N_MAX and not few:
        return "global", 1
    return "wide", 1


def solve_kernel(plan: str, k: int, dtype) -> str:
    """The name in KERNELS that a solve in `plan` with k right-hand sides
    counts under: the global and warp plans' one-vector solves apart from
    their solves of several columns (the polish's identity, the stage
    sweeps' nb columns)."""
    if plan in ("global", "warp"):
        key = plan + ("_cols" if k > 1 else "")
    else:
        key = "wide" if plan == "wide" else "smem"
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


# the cluster factor's sections and the grid factor's, by their cycle
# counters
CLUSTER_SECTIONS = ("gather", "panel", "trailing", "cluster_wait", "write")
GRID_SECTIONS = ("diagonal", "slice", "trailing", "barrier", "write")


def prof_ctas(B: int, plan) -> int:
    """CTAs of a launch in `plan` (rows of its profile): B clusters of
    plan.cluster, or the grid factor's groups of plan.ctas // groups."""
    if isinstance(plan, GridPlan):
        groups = min(B, plan.ctas)
        return groups * (plan.ctas // groups)
    return B * plan.cluster


def _launch_global(M: torch.Tensor, R: torch.Tensor, plan,
                   prof: torch.Tensor | None = None) -> int:
    """Launch the factor past shared memory on contiguous CUDA M and R in
    `plan` (a GlobalPlan: the cluster factor; a GridPlan: the grid factor,
    a cooperative launch); returns the C entry point's error code.  prof,
    an int64 CUDA tensor of (prof_ctas(B, plan), 8), runs the profiled
    instantiation, which takes each CTA's cycles by section
    (CLUSTER_SECTIONS or GRID_SECTIONS, counted by its thread 0)."""
    B, n, _ = M.shape
    fn = (kernels().qp_chol_grid if isinstance(plan, GridPlan)
          else kernels().qp_chol_global)
    return fn(M.data_ptr(), R.data_ptr(), B, n,
              int(M.dtype == torch.float64), plan[0], plan.b,
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
    if isinstance(gplan, GridPlan):
        plan = "wide"
    trace.count("chol.plan.factor_" + plan)
    name = KERNELS["factor", plan, M.dtype]
    KERNEL_LAUNCHES[name] += 1
    KERNEL_SHAPES[name, B, n, None] += 1
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
    # bulk copies of rows and float4 loads; the warp solve copies R of n
    # not a multiple of 4 as one span, from any double's address
    if (plan == "panel" or (plan == "warp" and n % 4 == 0)) \
            and R.data_ptr() % 16:
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
            # the tickets and flags; the stream orders the launches before
            # any reuse of the freed memory
            w = STRIPE_W[R.dtype]
            sync = torch.zeros(stripe_sync_ints(B, n, k, w),
                               dtype=torch.int32, device=R.device)
            rc = lib.qp_chol_solve_stripe(*ptrs, w, sync.data_ptr(),
                                          int(f64), _stream())
        else:
            rc = lib.qp_chol_solve(*ptrs, cols, _SOLVE_KINDS[plan],
                                   int(f64), _stream())
    check_launch("qp_chol_solve", rc)
    cholesky_solve.launches += 1
    trace.count("chol.plan.solve_" + plan)
    name = solve_kernel(plan, k, R.dtype)
    KERNEL_LAUNCHES[name] += 1
    KERNEL_SHAPES[name, B, n, k] += 1
    return x


cholesky_solve.launches = 0
