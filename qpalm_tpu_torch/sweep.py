"""The workloads sweep on the card: randomQP, lasso and portfolio, each lane
certified at 1e-6 in float64 on the unscaled problem (the port of the
pipeline of scripts/bench_workloads.py:170-208).

Per row, one batch, serially:

    batch.solve_batch (stacking in f32 on the card, the fused-plan
    routing, scaling, kernel K1 in the tier pick_tier gives, unscaling)
    -> copy x, y to the host
    -> polish.polish_batch_np(rounds=1, refine_steps=0) at 1e-6
    -> the lanes it rejects: polish_batch_np(rounds=3), then
       finish_np.palm_finish_np and a last polish_batch_np(rounds=1,
       refine_steps=0) check
    -> referee.check re-checks every certified lane (untimed)

The rows, generators, seeds, batch-size schedule and f32 settings are the
reference's (bench_workloads.py:61-90).  Of its 15 rows, the 8 with an
on-chip plan run K1's on-chip tier and 7 (n_pad 136 to 352) its streaming
tier.  The C baseline column is the reference's (bench_workloads.py:
221-251): the native single-threaded C/LAPACK solver (`baseline_c`) on the
row's first `baseline_sample` problems at the same eps, scaling 2, timed a
solve at a time after one untimed warm solve, its solves/s beside the
row's.  Not carried over: the timed repetitions over perturbed problem
sets, and the reference's round pipelining (the kernel of round k+1
overlapping the polish of round k), which is later work.

    python -m qpalm_tpu_torch.sweep [--rows randomQP:352 lasso:50 ...]
                                    [--batch B] [--device cuda|cpu]
                                    [--baseline-sample 8]

prints one JSON line of rows.  Times on the card: `k1_ms` by the CUDA
events fused_palm records around its launches, the rest by the host clock.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import baseline_c, referee
from .batch import solve_batch, stack_problems
from .finish_np import palm_finish_np
from .polish import polish_batch_np
from .precision import full_f32_matmul
from .solver import fused as F
from .types import QPData, Settings
from .workloads import lasso, portfolio, random_qp

EPS = 1e-6
S32 = Settings(dtype="float32", eps_abs=1e-4, eps_rel=1e-4, max_iter=400,
               scaling=2, max_refine=0, delta=10.0)
GENERATORS = {
    "randomQP": lambda n, i: random_qp(n, n, seed=10 * n + i),
    "lasso": lambda n, i: lasso(n, seed=3 * n + i),
    "portfolio": lambda n, i: portfolio(n, seed=7 * n + i),
}
ROWS = (
    *(("randomQP", n) for n in (20, 40, 60, 80, 100, 128, 160, 224, 256,
                                320, 352)),
    ("lasso", 20), ("lasso", 50), ("portfolio", 60), ("portfolio", 120),
)


def bsize(n_vars: int) -> int:
    """The reference's batch schedule (bench_workloads.py:64-77), keyed on
    the problem's variable count (lasso(20) builds an n=80 QP)."""
    if n_vars <= 20:
        return 2048
    if n_vars <= 80:
        return 1024
    if n_vars <= 100:
        return 256
    return 128


def row_problems(family: str, size: int, batch: int = 0):
    """The row's problems: `batch` of them, or the reference's schedule."""
    gen = GENERATORS[family]
    B = batch or bsize(gen(size, 0)[0].shape[0])
    return [gen(size, i) for i in range(B)]


def _take(data: QPData, idx) -> QPData:
    return QPData(*(a[idx] for a in data))


def retry_rejected(d64: QPData, x0, y0, ok, x, y) -> int:
    """The row's retry of the lanes the first polish rejected (`ok` False):
    polish_batch_np(rounds=3) from the solve's x0, y0, then the finisher
    and a last polish on the lanes still rejected.  Updates ok, x and y in
    place; returns how many lanes went to the finisher."""
    bad = np.flatnonzero(~ok)
    if not len(bad):
        return 0
    pol2 = polish_batch_np(_take(d64, bad), x0[bad], y0[bad], eps_abs=EPS,
                           eps_rel=EPS, rounds=3)
    ok[bad], x[bad], y[bad] = pol2.ok, pol2.x, pol2.y
    still = bad[~pol2.ok]
    if len(still):
        sub = _take(d64, still)
        fin = palm_finish_np(sub, pol2.x[~pol2.ok], pol2.y[~pol2.ok],
                             eps_abs=EPS, eps_rel=EPS)
        pol3 = polish_batch_np(sub, fin.x, fin.y, eps_abs=EPS, eps_rel=EPS,
                               rounds=1, refine_steps=0)
        ok[still], x[still], y[still] = pol3.ok, pol3.x, pol3.y
    return len(still)


def baseline_column(probs, sample: int = 8) -> dict:
    """The C baseline on the first `sample` problems (bench_workloads.py:
    221-251): one untimed warm solve, then each solved once at EPS,
    scaling 2; its solves/s and how many it solved."""
    sample = list(probs[:sample])
    if not sample:
        return dict(baseline_solves_per_s=None, baseline_solved=0,
                    baseline_sample=0)
    baseline_c.solve(*sample[0], eps_abs=EPS, eps_rel=EPS, scaling=2)
    t0 = time.perf_counter()
    solved = sum(baseline_c.solve(*p, eps_abs=EPS, eps_rel=EPS,
                                  scaling=2)["status"] == 1 for p in sample)
    dt = time.perf_counter() - t0
    return dict(baseline_solves_per_s=len(sample) / dt,
                baseline_solved=int(solved), baseline_sample=len(sample))


def run_row(family: str, size: int, device="cuda", batch: int = 0,
            baseline_sample: int = 8) -> dict:
    """One row of the sweep; returns its numbers.  `certified` counts the
    lanes whose final polish check passed at 1e-6, `referee_disagreements`
    those of them the f64 referee rejects; `speedup` divides the row's
    solves/s (its lanes over `wall_s`) by the C baseline's
    (`baseline_column`; none with `baseline_sample` 0)."""
    probs = row_problems(family, size, batch)
    B = len(probs)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    full_f32_matmul()
    d64 = stack_problems(probs, np.float64)  # host numpy stack, f64
    d64 = QPData(*(a.numpy() for a in d64))

    if cuda:
        torch.cuda.synchronize()
    F.fused_palm.events = [] if cuda else None
    t0 = time.perf_counter()
    try:
        res = solve_batch(probs, S32, device=dev)
        if cuda:
            torch.cuda.synchronize()
        events = F.fused_palm.events
    finally:
        F.fused_palm.events = None
    t1 = time.perf_counter()
    x32, y32 = res.x.cpu().numpy(), res.y.cpu().numpy()
    status, iters = res.status.cpu().numpy(), res.iterations.cpu().numpy()
    t2 = time.perf_counter()
    n_pad, m_pad = x32.shape[1], y32.shape[1]

    pol = polish_batch_np(d64, x32, y32, eps_abs=EPS, eps_rel=EPS, rounds=1,
                          refine_steps=0)
    ok = pol.ok.copy()
    x, y = pol.x.copy(), pol.y.copy()
    t3 = time.perf_counter()
    bad = np.flatnonzero(~ok)
    n_finish = retry_rejected(d64, x32, y32, ok, x, y)
    t4 = time.perf_counter()

    viol = referee.check(*d64, x, y, EPS, EPS)[0]
    base = baseline_column(probs, baseline_sample)
    return dict(
        family=family, size=f"n={size}", batch=B, n_pad=n_pad, m_pad=m_pad,
        tier=F.pick_tier(n_pad, m_pad), device=str(dev),
        certified=int(ok.sum()),
        polish1_ok=int(pol.ok.sum()), retried=int(len(bad)),
        finished=n_finish, referee_disagreements=int((ok & ~(viol <= 1.0))
                                                     .sum()),
        solved_f32=int((status == 1).sum()),
        mean_iterations=float(iters.mean()), max_iterations=int(iters.max()),
        wall_s=t4 - t0, solve_s=t1 - t0,
        k1_ms=sum(a.elapsed_time(b) for a, b in events) if cuda else None,
        copy_s=t2 - t1, polish_s=t3 - t2, retry_finish_s=t4 - t3,
        solves_per_s=B / (t4 - t0), **base,
        speedup=(B / (t4 - t0) / base["baseline_solves_per_s"]
                 if base["baseline_solves_per_s"] else None))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", nargs="*", default=None,
                    help="family:size pairs (default: the 15 rows)")
    ap.add_argument("--batch", type=int, default=0,
                    help="problems per row (0: the reference's schedule)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--baseline-sample", type=int, default=8,
                    help="problems a row the C baseline solves (0: none)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain twin on the host")
    rows = ROWS if args.rows is None else [
        (r.split(":")[0], int(r.split(":")[1])) for r in args.rows]
    out = [run_row(f, n, args.device, args.batch, args.baseline_sample)
           for f, n in rows]
    print(json.dumps({"rows": out}))


if __name__ == "__main__":
    main()
