"""Entry driver: the program's certified batch pipeline
(qpalm_tpu_torch.bench): per request, `bench._round` (stack, copy, K1,
the device polish, the flag fetch) and `bench.rescue_round` of the lanes
the device polish rejected on one background thread, joined every
`rounds_per_join` requests, as `bench.run` composes them.

One client hands in the next batch as soon as the flags of the last are
on the host, from a pool of distinct batches made from the seed in
set-up and cycled, each handed in as a fresh list of problems.  The
batches come from the generator the configuration names
(reference/generators/<generator>.py, `problems(cfg, batch, seed)`), at
the configuration's sizes.  A
request is complete when every lane is decided: its flags fetched and,
where the device polish rejected lanes, the rescue returned them.

The reference (portbench/reference/kkt.py) judges every lane of every
request of the window on the problems this driver made.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench.reference.kkt import kkt_ratio


class _Request:
    __slots__ = ("batch", "t_in", "t_flags", "ok", "pol", "bad", "future",
                 "phases", "events")


def _check_settings(cfg, bench):
    """The configuration file states what the program runs: refuse to run
    if the program's pipeline has other settings."""
    f32, cert = cfg["settings_f32"], cfg["certify"]
    s = bench.S32
    for k, v in f32.items():
        if getattr(s, k) != v:
            raise SystemExit(f"the program's f32 pass has {k}="
                             f"{getattr(s, k)!r}, the configuration {v!r}")
    for k, v in cert["polish"].items():
        if bench.POLISH[k] != v:
            raise SystemExit(f"the program's polish has {k}="
                             f"{bench.POLISH[k]!r}, the configuration {v!r}")
    if bench.EPS_TARGET != cert["eps"]:
        raise SystemExit(f"the program certifies at {bench.EPS_TARGET}, "
                         f"the configuration at {cert['eps']}")


def _rescue(rescue_round, data):
    """The program's rescue, with the time it returned."""
    res = rescue_round(data)
    return res, time.perf_counter()


def setup(cfg, traffic, seed, device, tracer, gen):
    import torch

    from qpalm_tpu_torch import baseline_c, bench
    from qpalm_tpu_torch.solver import fused as F
    from qpalm_tpu_torch.types import QPData

    _check_settings(cfg, bench)
    if baseline_c.load_library() is None:
        raise SystemExit("the rescue needs the C baseline: "
                         + baseline_c.unavailable_reason())
    B = int(traffic["batch"])
    pool = [gen.problems(cfg, B, [seed, k])
            for k in range(int(traffic["pool"]))]
    dev = torch.device(device)
    st = dict(cfg=cfg, traffic=traffic, pool=pool, dev=dev,
              cuda=dev.type == "cuda", bench=bench, F=F, QPData=QPData,
              pool_exec=ThreadPoolExecutor(max_workers=1), tracer=tracer)
    # warm-up, untimed by the window: the kernels' build and first
    # launches, the allocator, the rescue's library and thread
    for k in range(int(traffic["warmup_rounds"])):
        ok, _, h64, _, _ = bench._round(pool[k % len(pool)], dev, st["cuda"])
        bad = np.flatnonzero(~ok)
        st["pool_exec"].submit(bench.rescue_round,
                               QPData(*(a[bad] for a in h64))).result()
    if tracer.enabled:
        _instrument(st)
    return st


def _instrument(st):
    """Spans around the pipeline's calls into each layer, and K1's
    iteration counts (a traced run only)."""
    bench, F, tracer = st["bench"], st["F"], st["tracer"]
    st["k1_iters_log"] = []
    solve = F.solve_batch_fused

    def k1(*a, **k):
        out = tracer.span("enqueue.k1", solve, *a, **k)
        st["k1_iters_log"].append(out[3])
        return out

    st.setdefault("restore", []).extend(
        [(bench, "stack_problems", bench.stack_problems),
         (bench, "polish_batch", bench.polish_batch),
         (F, "solve_batch_fused", solve)])
    bench.stack_problems = tracer.wrap("stack", bench.stack_problems)
    bench.polish_batch = tracer.wrap("enqueue.polish", bench.polish_batch)
    F.solve_batch_fused = k1


def use_control(st):
    """The control of `correct`: the program's f32 path in place of the
    f64 certification.  Each lane is served with K1's float32 answer and
    flagged certified where K1's own float32 convergence test (at the f32
    pass's eps) passed; the rest go to the rescue as usual."""
    import torch

    from qpalm_tpu_torch import constants as C
    from qpalm_tpu_torch.polish_device import DevicePolishResult

    bench, F = st["bench"], st["F"]

    solve = F.solve_batch_fused
    status = []

    def k1(*a, **k):
        out = solve(*a, **k)
        status.append(out[2])
        return out

    def f32_answer(data, x, y, **kwargs):
        ok = status.pop() == C.QPALM_SOLVED
        nan = torch.full_like(ok, float("nan"), dtype=torch.float64)
        return DevicePolishResult(x=x.double(), y=y.double(), ok=ok,
                                  pri_res=nan, dua_res=nan, objective=nan)

    st.setdefault("restore", []).extend(
        [(F, "solve_batch_fused", solve),
         (bench, "polish_batch", bench.polish_batch)])
    F.solve_batch_fused = k1
    bench.polish_batch = f32_answer


def window(st, seconds, tracer):
    bench, QPData = st["bench"], st["QPData"]
    pool, dev, cuda = st["pool"], st["dev"], st["cuda"]
    per_join = int(st["traffic"]["rounds_per_join"])
    reqs = []
    t0 = time.perf_counter()
    k = 0
    try:
        while time.perf_counter() - t0 < seconds:
            group = []
            for _ in range(per_join):
                r = _Request()
                r.batch = k % len(pool)
                r.t_in = time.perf_counter()
                r.ok, r.pol, h64, r.phases, r.events = tracer.span(
                    "round", bench._round, pool[r.batch], dev, cuda)
                r.t_flags = time.perf_counter()
                r.bad = np.flatnonzero(~r.ok)
                r.future = st["pool_exec"].submit(
                    _rescue, bench.rescue_round,
                    QPData(*(a[r.bad] for a in h64)))
                group.append(r)
                k += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            tracer.span("join", lambda: [r.future.result() for r in group])
            reqs.extend(group)
    finally:
        for mod, name, fn in reversed(st.pop("restore", [])):
            setattr(mod, name, fn)
    t_end = max(max(r.t_flags, r.future.result()[1]) for r in reqs)
    return dict(reqs=reqs, t0=t0, t_end=t_end)


def collect(st, out):
    """Everything the judge and the readers need, on the host; frees the
    program's device state."""
    reqs = out["reqs"]
    st["pool_exec"].shutdown()
    answers = []
    latency, phases = [], []
    k1_ms = polish_ms = 0.0
    for r in reqs:
        res, t_done = r.future.result()
        x = r.pol.x.cpu().numpy()
        y = r.pol.y.cpu().numpy()
        ok = r.ok.copy()
        ok[r.bad], x[r.bad], y[r.bad] = res.ok, res.x, res.y
        answers.append((r.batch, ok, x, y))
        latency.append(max(r.t_flags, t_done) - r.t_in)
        phases.append(r.phases)
        k1_ev, pol_ev = r.events
        if st["cuda"]:
            k1_ms += sum(a.elapsed_time(b) for a, b in k1_ev)
            polish_ms += pol_ev[0].elapsed_time(pol_ev[1])
        r.pol = r.events = None
    lanes = sum(len(a[1]) for a in answers)
    rec = dict(answers=answers, pool=st["pool"], latency_s=latency,
               window_s=out["t_end"] - out["t0"], requests=len(reqs),
               lanes=lanes, batch=int(st["traffic"]["batch"]),
               rescued_lanes=sum(int(r.bad.size) for r in reqs),
               phases_s={k: sum(p[k] for p in phases) for k in phases[0]},
               n=st["cfg"]["n"], m=st["cfg"]["m"])
    if st["cuda"]:
        rec["k1_ms_total"] = k1_ms
        rec["polish_ms_total"] = polish_ms
    if "k1_iters_log" in st:
        rec["k1_iterations"] = int(sum(int(t.sum()) for t in
                                       st["k1_iters_log"]))
        st["k1_iters_log"].clear()
    return rec


def judge(cfg, rec):
    """Every lane of every request: a lane flagged certified has to meet
    the configuration's tolerance on the reference's own check."""
    eps, limit = cfg["certify"]["eps"], cfg["certify"]["limit"]
    n, m = cfg["n"], cfg["m"]
    stacks = {}
    worst = 0.0
    certified = uncertified = 0
    for b, ok, x, y in rec["answers"]:
        if b not in stacks:
            stacks[b] = [np.stack([p[i] for p in rec["pool"][b]])
                         for i in range(5)]
        ratio = kkt_ratio(*stacks[b], x[:, :n], y[:, :m], eps, eps)
        if ok.any():
            worst = max(worst, float(ratio[ok].max()))
        certified += int((ok & (ratio <= limit)).sum())
        uncertified += int((~ok).sum())
    return dict(attempted=rec["lanes"], failed=uncertified,
                certified=certified,
                checks={"worst_kkt_ratio": {"value": worst,
                                            "limit": limit}})
