"""Batched QPALM front end (counterpart of qpalm_tpu/batch.py and the
padding of qpalm_tpu/api.py:30-65).

    solve_batch / solve_many
      -> stack_problems                  padding written in place, tensors
                                         on `device`
      -> [nonconvex] solver.nonconvex.batch_gamma_pins   LOBPCG on scaled Q
      -> _fused_eligible                 dtype, settings, K1's memory plan
      -> solver.fused.solve_batch_fused  kernel K1 (its plain twin on a CPU)
         or solver.core.full_solve       the general loop (kernel K2 inside),
                                         host-chunked under a time limit
      -> BatchResult                     objective on the unscaled data

The padding is written in numpy, bit-equal to the reference's.  A batch
goes to K1 where the reference's routing rule sends it to its fused
kernel (qpalm_tpu/batch.py:141-172: float32, SCHUR, no time limit,
refinement or f64 residuals, and a shape with a fused memory plan); every
other batch runs the general loop, as the reference's does.  `solve_batch_escalate`
re-solves the lanes that did not solve in float64 on the same device.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import constants as C
from . import trace
from .linalg.chol import SMEM_LIMIT
from .solver import core
from .solver.fused import (STREAM_N_MAX, fused_smem_bytes, pick_tier,
                           solve_batch_fused)
from .solver.nonconvex import batch_gamma_pins
from .types import QPData, Settings


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# Padding conventions (neutral w.r.t. the solve — see pad_problem):
_PAD_BOUND = 1e21  # beyond QPALM_INFTY so padded rows count as unconstrained


def _densify(M) -> np.ndarray:
    if hasattr(M, "toarray"):  # scipy sparse
        return np.asarray(M.toarray())
    return np.asarray(M)


def pad_problem(Q, A, q, bmin, bmax, n_pad: int, m_pad: int, dtype):
    """Embed the QP in padded fixed shapes without changing its solution.

    Padded variables get a unit Hessian diagonal and zero gradient (they stay
    exactly 0); padded constraints get zero rows and +-1e21 bounds (beyond
    QPALM_INFTY, so they are inactive and excluded from every infeasibility
    test, reference: termination.c:160-177).
    """
    n, m = Q.shape[0], A.shape[0]
    Qp = np.zeros((n_pad, n_pad), dtype)
    Qp[:n, :n] = Q
    if n_pad > n:
        Qp[range(n, n_pad), range(n, n_pad)] = 1.0
    Ap = np.zeros((m_pad, n_pad), dtype)
    Ap[:m, :n] = A
    qp = np.zeros((n_pad,), dtype)
    qp[:n] = q
    bl = np.full((m_pad,), -_PAD_BOUND, dtype)
    bl[:m] = bmin
    bu = np.full((m_pad,), _PAD_BOUND, dtype)
    bu[:m] = bmax
    return Qp, Ap, qp, bl, bu


def stack_problems(
    problems: Sequence[tuple],
    dtype,
    pad_multiple: int = 8,
    n_pad: Optional[int] = None,
    m_pad: Optional[int] = None,
    device="cpu",
    pin_memory: bool = False,
) -> QPData:
    """Pad each (Q, A, q, bmin, bmax[, c]) tuple to a common shape and stack
    into one batched QPData of `dtype` tensors on `device`, each problem
    padded as `pad_problem` pads it.

    The stacked arrays are allocated once and written in place: the
    padding strips for the whole batch, then each problem's blocks.  With
    `pin_memory`, or a CUDA `device`, they are allocated page-locked (from
    torch's caching host allocator), so the copy to the card reads them
    directly.  Span (trace.py): "stack.pad", the allocation and the
    writes; counter "stack.pinned_bytes", the bytes written into
    page-locked memory."""
    device = torch.device(device)
    pin = pin_memory or device.type == "cuda"
    with trace.span("stack.pad"):
        host = _stack_in_place(problems, np.dtype(dtype), pad_multiple,
                               n_pad, m_pad, pin)
    if pin:
        trace.count("stack.pinned_bytes", sum(t.nbytes for t in host))
    return QPData(*(t.to(device) for t in host))


def _stack_in_place(problems, dtype, pad_multiple, n_pad, m_pad, pin):
    """`stack_problems`' host tensors Q, A, q, bmin, bmax, c, bit-equal to
    `pad_problem` a problem, the bounds clipped to +-_PAD_BOUND, and
    `np.stack`."""
    dense = [(_densify(p[0]), _densify(p[1])) for p in problems]
    ns = [Q.shape[0] for Q, _ in dense]
    ms = [A.shape[0] for _, A in dense]
    if n_pad is None:
        n_pad = _round_up(max(ns), pad_multiple)
    if m_pad is None:
        m_pad = _round_up(max(max(ms), 1), pad_multiple)
    B = len(problems)
    tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
    host = [torch.empty(shape, dtype=tdtype, pin_memory=pin)
            for shape in ((B, n_pad, n_pad), (B, m_pad, n_pad), (B, n_pad),
                          (B, m_pad), (B, m_pad), (B,))]
    Q, A, q, bl, bu, c = (t.numpy() for t in host)

    # the padding strips, one write a strip for each group of problems of
    # one (n, m)
    groups: dict = {}
    for i, nm in enumerate(zip(ns, ms)):
        groups.setdefault(nm, []).append(i)
    for (n, m), idx in groups.items():
        lanes = slice(None) if len(idx) == B else idx
        diag = np.arange(n, n_pad)
        Q[lanes, n:, :] = 0
        Q[lanes, :n, n:] = 0
        Q[np.asarray(idx)[:, None], diag, diag] = 1
        A[lanes, m:, :] = 0
        A[lanes, :m, n:] = 0
        q[lanes, n:] = 0
        bl[lanes, m:] = -_PAD_BOUND
        bu[lanes, m:] = _PAD_BOUND

    for i, (p, (Qi, Ai), n, m) in enumerate(zip(problems, dense, ns, ms)):
        Q[i, :n, :n] = Qi
        A[i, :m, :n] = Ai
        q[i, :n] = np.asarray(p[2], float).ravel()
        bl[i, :m] = np.asarray(p[3], float).ravel()
        bu[i, :m] = np.asarray(p[4], float).ravel()
    c[:] = np.asarray([p[5] if len(p) > 5 else 0.0 for p in problems],
                      dtype)
    np.maximum(bl, -_PAD_BOUND, out=bl)
    np.minimum(bu, _PAD_BOUND, out=bu)
    return host


def bucket_indices(sizes: Sequence[tuple], pad_multiple: int = 8) -> dict:
    """Group problem indices by padded (n_pad, m_pad) bucket, so that a
    heterogeneous sweep runs one batch per bucket."""
    buckets: dict = {}
    for i, (n, m) in enumerate(sizes):
        key = (_round_up(n, pad_multiple), _round_up(max(m, 1), pad_multiple))
        buckets.setdefault(key, []).append(i)
    return buckets


class BatchResult(NamedTuple):
    """Stacked per-problem results (leading axis = batch), tensors on the
    batch's device."""

    x: torch.Tensor  # (B, n_pad) unscaled primal solutions
    y: torch.Tensor  # (B, m_pad) unscaled dual solutions
    status: torch.Tensor  # (B,) int32 status codes (constants.QPALM_*)
    iterations: torch.Tensor  # (B,) int32
    objective: torch.Tensor  # (B,)
    pri_res_norm: torch.Tensor  # (B,)
    dua_res_norm: torch.Tensor  # (B,)

    @property
    def solved(self) -> torch.Tensor:
        return self.status == C.QPALM_SOLVED

    def iteration_histogram(self, bins=10):
        """Per-problem iteration histogram (counts, edges): the lockstep
        straggler diagnostic."""
        return np.histogram(self.iterations.cpu().numpy(), bins=bins)


def _not_fused(settings: Settings, n_pad: int,
               m_pad: int) -> Optional[str]:
    """Why kernel K1 does not take this batch, None when it does.  The
    rules for dtype, factorization, time limit, refinement and f64
    residuals are the reference's (qpalm_tpu/batch.py:152-163); the shape
    rule is K1's memory plan on the card (`fused.pick_tier`: on chip, or
    streaming up to n_pad 352), applied to the plain twin as well, so that
    a batch takes the same route on either device.  Such a batch runs the
    general loop (solver/core.py)."""
    if settings.use_fused == "never":
        return "use_fused='never'"
    rules = (
        (settings.dtype == "float32", f"dtype {settings.dtype!r}"),
        (settings.factorization_method in (
            C.FACTORIZE_SCHUR, C.FACTORIZE_KKT_OR_SCHUR),
         f"factorization_method {settings.factorization_method}"),
        (settings.time_limit >= C.QPALM_INFTY, "a time_limit"),
        (settings.max_refine == 0, f"max_refine {settings.max_refine}"),
        (not settings.residuals_fp64, "residuals_fp64"),
    )
    for ok, what in rules:
        if not ok:
            return what
    if n_pad % 4 or pick_tier(n_pad, m_pad) is None:
        return (f"n_pad={n_pad}, m_pad={m_pad} has no fused memory plan "
                f"(n_pad a multiple of 4 and at most {STREAM_N_MAX}, the "
                f"streaming tier's {fused_smem_bytes(n_pad, m_pad, True)} "
                f"bytes of shared memory at most {SMEM_LIMIT})")
    return None


def check_device(device) -> torch.device:
    """`device` as a torch.device; the port runs on CPU and CUDA tensors
    only."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"device {device}: the port runs on CPU "
                                  "and CUDA tensors only")
    return device


def _fused_eligible(settings: Settings, n_pad: int, m_pad: int) -> bool:
    """Route a batch through kernel K1 (its plain twin for CPU tensors)?
    `Settings.use_fused` "never" refuses, "always" raises ValueError on a
    batch the kernel cannot take, "auto" decides."""
    why = _not_fused(settings, n_pad, m_pad)
    if settings.use_fused == "always" and why is not None:
        raise ValueError("use_fused='always' but the configuration is not "
                         f"fused-kernel eligible: {why} (the general loop, "
                         "solver/core.py, runs such batches)")
    return why is None


def _objective(data: QPData, x: torch.Tensor) -> torch.Tensor:
    """0.5 x'Qx + q'x + c per problem, on the unscaled data."""
    Qx = torch.matmul(data.Q, x[..., None])[..., 0]
    return 0.5 * (x * Qx).sum(-1) + (data.q * x).sum(-1) + data.c


def solve_batch(
    problems: Sequence[tuple],
    settings: Optional[Settings] = None,
    x0: Optional[Sequence] = None,
    y0: Optional[Sequence] = None,
    pad_multiple: int = 8,
    device="cuda",
    chunk: int = 0,
    **settings_kw,
) -> BatchResult:
    """Solve a batch of QPs given as (Q, A, q, bmin, bmax[, c]) tuples on
    `device` ("cuda": the CUDA kernels; "cpu": their plain twins): through
    kernel K1 where `_fused_eligible` says so, else through the general
    loop (solver/core.py, kernel K2 inside), host-chunked under a
    `time_limit`.

    All problems are padded to one shared shape; warm starts (`x0`, `y0`)
    are all-or-none.  For `Settings(nonconvex=True)` each problem's minimum
    eigenvalue is estimated with a batched LOBPCG and gamma is pinned per
    problem (reference: nonconvex.c:171-183); problems that turn out convex
    keep the default proximal schedule.  `chunk` > 0 runs K1 in launches
    of that many iterations with a host early exit between them.
    """
    if settings is None:
        settings = Settings(**settings_kw)
    elif settings_kw:
        settings = settings.replace(**settings_kw)
    check_device(device)
    dtype = np.dtype(settings.dtype)
    data = stack_problems(problems, dtype, pad_multiple, device=device)
    B, n_pad = data.q.shape
    m_pad = data.bmin.shape[1]

    x_ws = y_ws = None
    if x0 is not None or y0 is not None:
        x_ws = np.zeros((B, n_pad), dtype)
        y_ws = np.zeros((B, m_pad), dtype)
        for i, p in enumerate(problems):
            ni = _densify(p[0]).shape[0]
            mi = _densify(p[1]).shape[0]
            if x0 is not None:
                x_ws[i, :ni] = np.asarray(x0[i], float).ravel()
            if y0 is not None:
                y_ws[i, :mi] = np.asarray(y0[i], float).ravel()

    gamma_init = gamma_max = None
    if settings.nonconvex:
        gamma_init, gamma_max = batch_gamma_pins(data, settings)
        settings = settings.replace(proximal=True)
    settings = settings.replace(verbose=False)

    if _fused_eligible(settings, n_pad, m_pad):
        x, y, status, iters, prn, dan, _, _ = solve_batch_fused(
            data, settings, x_ws=x_ws, y_ws=y_ws, chunk=chunk,
            gamma_init=gamma_init, gamma_max=gamma_max)
        return BatchResult(x=x, y=y, status=status, iterations=iters,
                           objective=_objective(data, x), pri_res_norm=prn,
                           dua_res_norm=dan)

    if settings.time_limit < C.QPALM_INFTY:
        if settings.nonconvex:
            raise NotImplementedError(
                "time_limit is not supported for nonconvex batch solves "
                "(the host-chunked enforcement does not carry the "
                "per-problem gamma pins; qpalm_tpu/batch.py:327-331)")
        return _solve_batch_time_limited(data, settings, x_ws, y_ws)
    final, x, y, obj = core.full_solve(data, settings, x_ws, y_ws,
                                       gamma_init, gamma_max)
    return _result(final, x, y, obj)


def _result(final, x, y, obj) -> BatchResult:
    return BatchResult(x=x, y=y, status=final.status,
                       iterations=final.iter, objective=obj,
                       pri_res_norm=final.pri_res_norm,
                       dua_res_norm=final.dua_res_norm)


def _solve_batch_time_limited(data: QPData, settings: Settings, x_ws=None,
                              y_ws=None) -> BatchResult:
    """The general loop in chunks of min(200, max_iter) iterations with the
    wall clock read between them (qpalm_tpu/batch.py:175-203, reference
    qpalm.c:680-708); problems unfinished when the limit passes get
    QPALM_TIME_LIMIT_REACHED."""
    t0 = time.perf_counter()
    st, sdata, scal = core.setup(data, settings, x_ws, y_ws)
    chunk = max(1, min(200, settings.max_iter))
    limit = chunk
    while True:
        st = core.solve_from_state(st, sdata, scal, settings, max_iter=limit)
        if bool(st.done.all()) or limit >= settings.max_iter:
            break
        if time.perf_counter() - t0 > settings.time_limit:
            st = st._replace(
                status=torch.where(st.done, st.status, torch.full_like(
                    st.status, C.QPALM_TIME_LIMIT_REACHED)),
                done=torch.ones_like(st.done))
            break
        limit = min(limit + chunk, settings.max_iter)
    return _result(st, *core.finalize(st, sdata, scal, settings))


class ManyResult(NamedTuple):
    """Results of a heterogeneous sweep: every array is rectangular, padded
    to the largest bucket; `n`/`m` carry each problem's true sizes so
    `result.x[i, :result.n[i]]` is problem i's solution."""

    x: np.ndarray  # (B, max_n_pad) zero-padded primal solutions
    y: np.ndarray  # (B, max_m_pad) zero-padded dual solutions
    status: np.ndarray  # (B,) int32
    iterations: np.ndarray  # (B,) int32
    objective: np.ndarray  # (B,)
    pri_res_norm: np.ndarray  # (B,)
    dua_res_norm: np.ndarray  # (B,)
    n: np.ndarray  # (B,) true variable counts
    m: np.ndarray  # (B,) true constraint counts

    @property
    def solved(self) -> np.ndarray:
        return self.status == C.QPALM_SOLVED


def solve_many(
    problems: Sequence[tuple],
    settings: Optional[Settings] = None,
    pad_multiple: int = 8,
    escalate: bool = False,
    device="cuda",
    **settings_kw,
) -> ManyResult:
    """Solve a heterogeneous problem list: bucket by padded shape, run one
    batch per bucket, scatter the results back into input order (numpy).
    `escalate=True` adds the f32 -> f64 straggler re-solve
    (solve_batch_escalate)."""
    if settings is None:
        settings = Settings(**settings_kw)
    elif settings_kw:
        settings = settings.replace(**settings_kw)
    sizes = [(_densify(p[0]).shape[0], _densify(p[1]).shape[0])
             for p in problems]
    B = len(problems)
    max_np = max(_round_up(n, pad_multiple) for n, _ in sizes)
    max_mp = max(_round_up(max(m, 1), pad_multiple) for _, m in sizes)
    x = np.zeros((B, max_np))
    y = np.zeros((B, max_mp))
    scal = {
        f: np.zeros((B,), np.int32 if f in ("status", "iterations") else float)
        for f in ("status", "iterations", "objective", "pri_res_norm",
                  "dua_res_norm")
    }
    for idxs in bucket_indices(sizes, pad_multiple).values():
        sub = [problems[i] for i in idxs]
        if escalate:
            res = solve_batch_escalate(sub, settings,
                                       pad_multiple=pad_multiple,
                                       device=device)
        else:
            res = solve_batch(sub, settings, pad_multiple=pad_multiple,
                              device=device)
        xb = res.x.cpu().numpy()
        yb = res.y.cpu().numpy()
        x[idxs, :xb.shape[1]] = xb
        y[idxs, :yb.shape[1]] = yb
        for f in scal:
            scal[f][idxs] = getattr(res, f).cpu().numpy()
    return ManyResult(x=x, y=y, n=np.asarray([s[0] for s in sizes], np.int32),
                      m=np.asarray([s[1] for s in sizes], np.int32), **scal)


def solve_batch_escalate(
    problems: Sequence[tuple],
    settings: Optional[Settings] = None,
    fallback_settings: Optional[Settings] = None,
    fallback_device=None,
    pad_multiple: int = 8,
    device="cuda",
    **settings_kw,
) -> BatchResult:
    """Two-pass batch solve (qpalm_tpu/batch.py:416-467): a float32 pass
    (by default), then a float64 re-solve of every problem that did not
    reach `solved`, scattered back into one BatchResult of the first pass's
    dtypes.  The re-solve runs the general loop on `fallback_device`, by
    default the first pass's device: the H100 runs float64 natively (the
    reference sent it to the host CPU because its TPU emulates f64)."""
    if settings is None:
        settings_kw.setdefault("dtype", "float32")
        settings = Settings(**settings_kw)
    elif settings_kw:
        settings = settings.replace(**settings_kw)
    res = solve_batch(problems, settings, pad_multiple=pad_multiple,
                      device=device)
    bad = torch.nonzero(res.status != C.QPALM_SOLVED).flatten().tolist()
    if not bad:
        return res
    if fallback_settings is None:
        fallback_settings = settings.replace(
            dtype="float64", max_iter=max(settings.max_iter, 4000),
            refine_fp64=False, residuals_fp64=False)
    if fallback_device is None:
        fallback_device = res.x.device
    res2 = solve_batch([problems[i] for i in bad], fallback_settings,
                       device=fallback_device)
    idx = torch.tensor(bad, device=res.x.device)
    merged = {}
    for field in BatchResult._fields:
        a = getattr(res, field).clone()
        b = getattr(res2, field).to(device=a.device, dtype=a.dtype)
        if a.dim() > 1 and a.shape[1] != b.shape[1]:
            # the re-solve's bucket may pad differently: align on the
            # smaller width
            w = min(a.shape[1], b.shape[1])
            a[idx, :w] = b[:, :w]
        else:
            a[idx] = b
        merged[field] = a
    return BatchResult(**merged)
