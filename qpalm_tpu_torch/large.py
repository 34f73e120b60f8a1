"""The pipeline for LARGE dense QPs (counterpart of qpalm_tpu/large.py).

1. An f32 `batch.solve_batch` pass on `device`: the general loop (SCHUR
   with refinement, which K1 does not take), its Newton systems on kernel
   K2 (past f32 n = 960 at up to 8 problems the grid factor and the stripe
   solve).
2. The f64 active-set polish on the host (`polish.polish_batch_np`: one
   compacted KKT solve and a full KKT check per problem), or with
   `device_polish=True` the device polish (`polish_device.polish_batch`,
   its preconditioner inverted explicitly by K2) on the f64 data on the
   card, then the host polish for the lanes it rejects.
3. The warm-started f64 numpy P-ALM finisher for the polish's failures
   (`finish_np.palm_finish_np`), re-certified by the same KKT check.

Every returned solution is certified at the target eps in f64 on the
unscaled problem, or flagged ok=False (qpalm_tpu/large.py:1-32).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .types import QPData, Settings


class LargeResult(NamedTuple):
    """Per-problem results of the large-dense pipeline (leading axis B),
    host numpy arrays."""

    x: np.ndarray          # (B, n) f64 polished primal solutions
    y: np.ndarray          # (B, m) f64 polished dual solutions
    ok: np.ndarray         # (B,) bool: f64 KKT-certified at eps
    status: np.ndarray     # (B,) int32 f32-pass status codes
    iterations: np.ndarray  # (B,) int32 f32-pass iterations
    objective: np.ndarray  # (B,) f64 certified objectives
    t_device_s: float      # f32 pass wall-clock
    t_polish_s: float      # polish + finisher wall-clock


def _lanes(d64: QPData, idx) -> QPData:
    return QPData(*(a[idx] for a in d64))


def solve_large_dense(
    problems: Sequence[tuple],
    eps: float = 1e-6,
    eps_f32: float = 1e-4,
    settings: Optional[Settings] = None,
    max_iter: int = 2000,
    scaling: int = 10,
    device_polish: bool = False,
    device="cuda",
) -> LargeResult:
    """Solve a batch of large dense QPs at f32 on `device`, then certify at
    `eps` in f64: by the host polish (default) or by the device polish on
    `device` (qpalm_tpu/large.py:57-160).

    `problems`: sequence of (Q, A, q, bmin, bmax[, c]) tuples, dense or
    scipy-sparse (densified).
    """
    from .batch import solve_batch, stack_problems
    from .finish_np import palm_finish_np
    from .polish import polish_batch_np
    from .polish_device import polish_batch

    if settings is None:
        settings = Settings(
            dtype="float32", eps_abs=eps_f32, eps_rel=eps_f32,
            max_iter=max_iter, scaling=scaling, max_refine=2, delta=10.0,
            verbose=False,
        )

    t0 = time.perf_counter()
    res = solve_batch(problems, settings, device=device)
    xy = torch.cat([res.x, res.y], dim=1).cpu().numpy()
    t_device = time.perf_counter() - t0

    t0 = time.perf_counter()
    d64 = QPData(*(a.numpy() for a in stack_problems(problems, np.float64,
                                                      device="cpu")))
    n_pad = d64.q.shape[1]
    x32, y32 = xy[:, :n_pad], xy[:, n_pad:]
    if device_polish:
        pd = polish_batch(
            QPData(*(torch.from_numpy(a).to(device) for a in d64)),
            torch.from_numpy(x32).to(device), torch.from_numpy(y32).to(device),
            eps_abs=eps, eps_rel=eps, refine_iters=4,
            second_round_k=min(16, len(problems)), seed_guard="norm",
        )
        ok, x64, y64, obj = (a.cpu().numpy().copy() for a in
                             (pd.ok, pd.x, pd.y, pd.objective))
        bad = np.where(~ok)[0]
        if len(bad):
            # host polish retry for the device's rejects (full-f64 LU and
            # more active-set rounds), before the finisher below
            polh = polish_batch_np(_lanes(d64, bad), x32[bad], y32[bad],
                                   eps_abs=eps, eps_rel=eps, rounds=3)
            ok[bad] = np.asarray(polh.ok)
            x64[bad] = np.asarray(polh.x)
            y64[bad] = np.asarray(polh.y)
            obj[bad] = np.asarray(polh.objective)
    else:
        pol = polish_batch_np(d64, x32, y32, eps_abs=eps, eps_rel=eps,
                              rounds=3)
        ok = np.array(pol.ok)
        x64 = np.array(pol.x)
        y64 = np.array(pol.y)
        obj = np.array(pol.objective)
    bad = np.where(~ok)[0]
    if len(bad):
        sub = _lanes(d64, bad)
        fin = palm_finish_np(sub, x64[bad], y64[bad], eps_abs=eps,
                             eps_rel=eps)
        pol2 = polish_batch_np(sub, fin.x, fin.y, eps_abs=eps, eps_rel=eps,
                               rounds=1, refine_steps=0)
        ok[bad] = np.asarray(pol2.ok)
        x64[bad] = np.asarray(pol2.x)
        y64[bad] = np.asarray(pol2.y)
        obj[bad] = np.asarray(pol2.objective)
    t_polish = time.perf_counter() - t0

    return LargeResult(
        x=x64, y=y64, ok=ok, status=res.status.cpu().numpy(),
        iterations=res.iterations.cpu().numpy(), objective=obj,
        t_device_s=t_device, t_polish_s=t_polish,
    )
