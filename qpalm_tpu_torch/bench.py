"""The headline benchmark on the card: certified QP solves/s at 1e-6, the
port of bench.py's GPU worker (bench.py:142-166, 173-524).

    python -m qpalm_tpu_torch.bench [--device cuda|cpu] [--rounds K]
                                    [--reps R] [--batch B]

prints one JSON line with bench.py's metric name.  Protocol (bench.py:66-85,
186-197, 364-413): a rep solves K rounds (8) of B (512) distinct problems,
round k of rep r from workloads.make_problems(B, 64, 96, seed=7 + 1000
(r K + k)), made before the rep's window.  Each round, all of it charged
from the rep's problem lists on:

    stack      batch.stack_problems in f64 (host numpy, page-locked on a
               card)
    copy       the stack to the card, and its f32 cast there
    k1         solver.fused.solve_batch_fused: scaling, kernel K1 at eps
               5e-5, max_iter 96, scaling 2, delta 10, unscaling
    polish     polish_device.polish_batch at 1e-6 (kernels K2a, K2b):
               refine_iters 2, second_round_k 64, seed_guard "norm", f64
               residuals, accept_viol 1; from m n^2 >= 2^24 it ends
               by correcting its rejected lanes (`correct_rejected`)
    flag_fetch the ok flags to the host (the wait for the round's device
               work)

and the lanes the device polish rejects go to `rescue_round` in one
background thread, which overlaps the next rounds; the rep ends when the
rescue is joined ("rescue_join").  Rounds run in order: the reference's
tunnel workarounds (one packed transfer, a fetch thread, two rounds in
flight; bench.py:219-267, 364) are not ported.  K1 and polish are CUDA
event times of the round's device work (no synchronisation is added for
them); the other phases are host-clock times.

The value is the median rep's certified lanes over its wall time; every
rep is disclosed.  A lane counts when its polish check passed (on the card,
or on the host for rescued lanes) and the untimed f64 referee, run on
every rep, agrees.  The divisor is `measure_baseline`: the native C
baseline on the same host.

`--device cpu` runs the kernels' plain twins on the host and prints no
device metric (value null).  Without a card and without `--device cpu` it
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from . import baseline_c, referee, trace
from .batch import stack_problems
from .finish_np import palm_finish_np
from .polish import polish_batch_np
from .polish_device import polish_batch
from .precision import full_f32_matmul
from .solver import fused as F
from .types import QPData, Settings
from .workloads import make_problems

METRIC = "qp_solves_per_sec_per_chip_at_1e-6"
K_ROUNDS, REPS, BATCH = 8, 5, 512
N_DIM, M_DIM = 64, 96
EPS_TARGET = 1e-6
S32 = Settings(dtype="float32", eps_abs=5e-5, eps_rel=5e-5, max_iter=96,
               scaling=2, max_refine=0, delta=10.0)  # bench.py:194-197
POLISH = dict(eps_abs=EPS_TARGET, eps_rel=EPS_TARGET, refine_iters=2,
              second_round_k=64, seed_guard="norm", residual32=False,
              accept_viol=1.0)
SAMPLE_BASELINE = 32
BASELINE_DELTAS = (100.0, 10.0, 100.0, 10.0)


def measure_baseline(probs, deltas=BASELINE_DELTAS):
    """The C baseline solving `probs` one after another at eps 1e-6
    (bench.py:142-166), one pass per delta.  Returns (best solves/s of the
    passes that solved every problem, the divisor; every pass as a dict of
    its delta, solved count and solves/s)."""
    baseline_c.solve(*probs[0], eps_abs=EPS_TARGET, eps_rel=EPS_TARGET,
                     scaling=2, delta=100.0)  # loads the library
    best, passes = 0.0, []
    for delta in deltas:
        t0 = time.perf_counter()
        solved = 0
        for p in probs:
            r = baseline_c.solve(*p, eps_abs=EPS_TARGET, eps_rel=EPS_TARGET,
                                 scaling=2, delta=delta)
            solved += r["status"] == 1
        rate = len(probs) / (time.perf_counter() - t0)
        passes.append(dict(delta=delta, solved=solved, solves_per_s=rate))
        if solved == len(probs):
            best = max(best, rate)
    return best, passes


class RescueResult(NamedTuple):
    ok: np.ndarray    # (L,) bool: the host polish check passed
    x: np.ndarray     # (L, n) the lanes' final points
    y: np.ndarray     # (L, m)
    by_c: int         # lanes certified after the C solve
    by_finish: int    # lanes certified after finish_np


def rescue_round(data: QPData, rid: int | None = None) -> RescueResult:
    """The host rescue of the lanes a device polish rejected
    (bench.py:289-347), on host numpy float64 stacks of those lanes only:

      a fresh C/LAPACK solve per lane at eps 0.5e-6, scaling 2, delta 10
      -> polish_batch_np(rounds=1) checks (and polishes) it at 1e-6
      -> the lanes still failing: palm_finish_np warm-started from that
         polished point, then polish_batch_np(rounds=1, refine_steps=0).

    A lane counts only where a host polish check passed.  Uses no torch:
    it runs beside the card's work in a thread (the C solve and LAPACK
    release the interpreter lock).  `rid`: the request id of the round
    whose lanes these are, for the trace's spans (trace.py)."""
    if not len(data[2]):
        return _rescue_lanes(data)
    with trace.span("rescue", request=rid):
        trace.count("rescue.lanes", len(data[2]))
        return _rescue_lanes(data)


def _rescue_lanes(data: QPData) -> RescueResult:
    """`rescue_round`'s work, with its spans "rescue.c_solve" (a lane) and
    "rescue.polish"."""
    Q, A, q, bmin, bmax = (np.asarray(a, np.float64) for a in data[:5])
    lanes, n = q.shape
    if not lanes:
        return RescueResult(np.zeros(0, bool), q.copy(), bmin.copy(), 0, 0)
    xs, ys = np.zeros((lanes, n)), np.zeros((lanes, bmin.shape[1]))
    for j in range(lanes):
        with trace.span("rescue.c_solve"):
            r = baseline_c.solve(Q[j], A[j], q[j], bmin[j], bmax[j],
                                 eps_abs=0.5 * EPS_TARGET,
                                 eps_rel=0.5 * EPS_TARGET, scaling=2,
                                 delta=10.0)
        xs[j], ys[j] = r["x"], r["y"]
    with trace.span("rescue.polish"):
        pol = polish_batch_np(data, xs, ys, eps_abs=EPS_TARGET,
                              eps_rel=EPS_TARGET, rounds=1)
    ok, x, y = pol.ok.copy(), pol.x.copy(), pol.y.copy()
    by_c = int(ok.sum())
    still = np.flatnonzero(~ok)
    if still.size:
        sub = QPData(*(np.asarray(a)[still] for a in data))
        fin = palm_finish_np(sub, pol.x[still], pol.y[still],
                             eps_abs=EPS_TARGET, eps_rel=EPS_TARGET)
        pol2 = polish_batch_np(sub, fin.x, fin.y, eps_abs=EPS_TARGET,
                               eps_rel=EPS_TARGET, rounds=1, refine_steps=0)
        ok[still], x[still], y[still] = pol2.ok, pol2.x, pol2.y
    return RescueResult(ok, x, y, by_c, int(ok.sum()) - by_c)


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi printed nothing"


def _round(probs, dev, cuda, rid=None):
    """One round up to the device polish's flags.  Returns (ok flags,
    the polish result on the device, the host f64 stack, host-clock phases
    in seconds, the round's CUDA events: K1's launches and the polish's).
    The trace's spans (trace.py) cover the phases under a root span
    "round" of request id `rid` (a new one if None)."""
    with trace.span("round", request=rid):
        return _round_phases(probs, dev, cuda)


def _round_phases(probs, dev, cuda):
    """`_round`'s work, a span for each phase."""
    t0 = time.perf_counter()
    with trace.span("stack"):
        h64 = stack_problems(probs, np.float64, pin_memory=cuda)
    t1 = time.perf_counter()
    with trace.span("copy"):
        d64 = QPData(*(t.to(dev) for t in h64))
        d32 = QPData(*(t.float() for t in d64))
    t2 = time.perf_counter()
    with trace.span("enqueue.k1"):
        F.fused_palm.events = [] if cuda else None
        try:
            x, y = F.solve_batch_fused(d32, S32)[:2]
            k1_events = F.fused_palm.events
        finally:
            F.fused_palm.events = None
    with trace.span("enqueue.polish"):
        pol_events = None
        if cuda:
            pol_events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
            pol_events[0].record()
        pol = polish_batch(d64, x, y, **POLISH)
        if cuda:
            pol_events[1].record()
    t3 = time.perf_counter()
    with trace.span("flag_fetch"):
        ok = pol.ok.cpu().numpy()
    t4 = time.perf_counter()
    phases = dict(stack=t1 - t0, copy=t2 - t1, enqueue=t3 - t2,
                  flag_fetch=t4 - t3)
    return ok, pol, QPData(*(t.numpy() for t in h64)), phases, \
        (k1_events, pol_events)


def _rep(rounds, dev, cuda, pool):
    """One timed rep over its problem lists, then the untimed referee.
    Returns the rep's numbers."""
    t0 = time.perf_counter()
    outs, futures = [], []
    for probs in rounds:
        rid = trace.new_request()
        ok, pol, h64, phases, events = _round(probs, dev, cuda, rid)
        bad = np.flatnonzero(~ok)
        futures.append((bad, pool.submit(
            rescue_round, QPData(*(a[bad] for a in h64)), rid)))
        outs.append((ok, pol, h64, phases, events))
    tj = time.perf_counter()
    rescues = [(bad, fut.result()) for bad, fut in futures]
    t_end = time.perf_counter()

    # untimed: device times from the events, the referee on every lane
    # certified on the card or by the rescue
    checked = agree = by_c = by_finish = lanes = 0
    per_round = []
    for (ok, pol, h64, phases, (k1_ev, pol_ev)), (bad, res) in zip(outs,
                                                                  rescues):
        x, y = pol.x.cpu().numpy(), pol.y.cpu().numpy()
        ok = ok.copy()
        ok[bad], x[bad], y[bad] = res.ok, res.x, res.y
        by_c, by_finish = by_c + res.by_c, by_finish + res.by_finish
        lanes += bad.size
        if cuda:
            phases["k1"] = sum(a.elapsed_time(b) for a, b in k1_ev) / 1e3
            phases["polish"] = pol_ev[0].elapsed_time(pol_ev[1]) / 1e3
        per_round.append(phases)
        ref_ok = referee.check(*h64, x, y, EPS_TARGET, EPS_TARGET)[0] <= 1.0
        checked += int(ok.sum())
        agree += int((ok & ref_ok).sum())
    # a lane the referee rejects leaves the rep's count
    return dict(seconds=t_end - t0, rescue_join=t_end - tj, solved=agree,
                total=sum(len(p) for p in rounds),
                referee=dict(checked=checked, agree=agree),
                rescue=dict(lanes=lanes, by_c=by_c, by_finish=by_finish),
                rounds=per_round)


def _median_p90(values):
    ms = sorted(1e3 * v for v in values)
    return statistics.median(ms), ms[int(0.9 * (len(ms) - 1))]


def run(device="cuda", rounds=K_ROUNDS, reps=REPS, batch=BATCH) -> dict:
    """The benchmark on `device`; returns the dict main prints."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if baseline_c.load_library() is None:
        raise RuntimeError("the C baseline is needed for the rescue and the "
                           "divisor: " + baseline_c.unavailable_reason())
    full_f32_matmul()

    def problems(r):
        return [make_problems(batch, N_DIM, M_DIM, seed=7 + 1000 * (r * rounds
                                                                  + k))
                for k in range(rounds)]

    with ThreadPoolExecutor(max_workers=1) as pool:
        # untimed warm-up: builds the kernels, warms the allocator, the
        # numpy and LAPACK thread pools and the rescue
        first = problems(0)
        ok, _, h64, _, _ = _round(first[0], dev, cuda)
        bad = np.flatnonzero(~ok)
        rescue_round(QPData(*(a[bad] for a in h64)))
        results = [_rep(problems(r), dev, cuda, pool) for r in range(reps)]

    times = [r["seconds"] for r in results]
    med = statistics.median(times)
    mi = min(range(reps), key=lambda i: abs(times[i] - med))
    median_rep = results[mi]
    base, passes = measure_baseline(first[0][:SAMPLE_BASELINE])
    value = median_rep["solved"] / median_rep["seconds"] if cuda else None
    phase_rounds = {k: [p[k] for r in results for p in r["rounds"]]
                    for k in results[0]["rounds"][0]}
    phase_rounds["rescue_join"] = [r["rescue_join"] for r in results]
    split = {k: _median_p90(v) for k, v in phase_rounds.items()}
    return {
        "metric": METRIC,
        "value": value,
        "unit": "solves/s",
        "vs_baseline": value / base if value is not None and base else None,
        "detail": {
            "path": "K1 on chip" if F.pick_tier(N_DIM, M_DIM) == "smem"
                    else "K1 streaming",
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "card": card() if cuda else None,
            "rounds": rounds, "batch": batch, "n": N_DIM, "m": M_DIM,
            "eps_certified": EPS_TARGET, "eps_f32_pass": S32.eps_abs,
            "solved": median_rep["solved"], "total": median_rep["total"],
            "solved_all_reps": sum(r["solved"] for r in results),
            "total_all_reps": sum(r["total"] for r in results),
            "solved_reps": [r["solved"] for r in results],
            "pipeline_s": median_rep["seconds"],
            "pipeline_s_reps": times,
            "headline_estimator": "median_of_reps",
            "rescue_reps": [r["rescue"] for r in results],
            "referee_reps": [r["referee"] for r in results],
            "phase_ms_median": {k: v[0] for k, v in split.items()},
            "phase_ms_p90": {k: v[1] for k, v in split.items()},
            "phase_note": "per round: stack, copy, enqueue, flag_fetch "
                          "(host clock), k1, polish (CUDA events); per rep: "
                          "rescue_join (host clock)",
            "polish": "f64 residuals, accept_viol 1.0; bench.py used "
                      "residual32=True, accept_viol=0.5 (bench.py:254-259) "
                      "because f64 is emulated on the TPU; the H100 has "
                      "native f64 (polish_device.py:15-19)",
            "charged": "all wall clock of a round from the rep's problem "
                       "lists on: stacking (f64), copy, scaling, K1, "
                       "unscaling, device polish, flag fetch, and the wait "
                       "for the rescue; bench.py staged its stacks before "
                       "its window (bench.py:198-217), so the value is not "
                       "comparable with BENCH_r05.json",
            "baseline": "native C/LAPACK single thread "
                        "(native/qpalm_baseline.cpp), first "
                        f"{min(SAMPLE_BASELINE, batch)} problems of rep 0",
            "baseline_blas": baseline_c.linked_blas(),
            "baseline_solves_per_s": base,
            "baseline_passes": passes,
            "baseline_estimator": "best of the passes that solved all",
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=K_ROUNDS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain twins on the host")
    print(json.dumps(run(args.device, args.rounds, args.reps, args.batch)))


if __name__ == "__main__":
    main()
