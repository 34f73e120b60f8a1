#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (qpalm_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases, each asserting, any failure exiting non-zero:
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build: nvcc compiles the kernels under qpalm_tpu_torch/csrc/;
  3. kernel K2 (batched Cholesky factor and solve) against its plain twin
     on a (512, 64, 64) SPD batch, and the identity right-hand-side solve;
  4. kernel K1 (the fused P-ALM loop) against its plain twin on one
     headline round (512 problems, n=64, m=96), plus a bit-identical rerun;
  5. the slice: 4 headline rounds, each stack -> scale -> K1 -> unscale ->
     device polish (K2 inside) at 1e-6, then the host f64 referee on every
     certified lane.  The launch counters are zeroed just before and read
     just after, so they show which kernels the main path ran;
  6. the nonconvex front end: batch.solve_batch on the BOXQP-d rows of
     scripts/bench_nonconvex.py (n=64, m=80, B=256 and n=16, m=20, B=512,
     its f32 settings): LOBPCG gamma pins held against the f64 spectrum of
     the scaled Q, K1's nonconvex tier against its twin, stationarity of
     every solved lane;
  7. dual-objective termination at the headline shape, the limit at the
     median of phase 4's objectives: K1 against its twin, some lanes
     dual-terminated and some solved;
  8. host chunking (chunk=16 bit-identical to one launch) and a warm start
     (q scaled by 1.01, from phase 4's x and y; fewer iterations than cold)
     at the headline shape, K1 against its twin.
  Phases 6-8 each zero the counters before their solve_batch calls and
  read them after.

It prints a JSON line of the kernels' numbers, the nvidia-smi line, and as
its last line {"ok": true, "device": {...}} only when every phase passed.
There is no CPU fallback: without a CUDA device it exits non-zero.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROUNDS = 4
B, N, M = 512, 64, 96  # the headline configuration (bench.py:74-76)
EPS_TARGET = 1e-6
# BOXQP-d rows (n, m, B) of scripts/bench_nonconvex.py:118, m = n + n/4,
# and its f32 settings (:119-121)
NC_ROWS = ((64, 80, 256), (16, 20, 512))
S_NC = dict(dtype="float32", nonconvex=True, eps_abs=1e-4, eps_rel=1e-4,
            max_iter=400, scaling=2, max_refine=0, verbose=False)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def require(cond, msg):
    if not cond:
        fail(msg)


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps calls, after a warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(fn(), device milliseconds of that one call)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def kernel_vs_plain(F, sd, scal, st, s, label):
    """K1 and its plain twin from the same state, held at phase 4's bars
    (statuses on all but 1%, iteration counts on all but 5%, |dx| < 1e-3
    where both agree).  Returns (kernel outputs, twin outputs) as numpy and
    the numbers of the kernels line."""
    import numpy as np

    T = s.max_iter
    out_k = F._finish(sd, scal, F.fused_palm(sd, scal, st, T, s))
    out_p, plain_ms = timed(lambda: F._finish(
        sd, scal, F.fused_palm_plain(sd, scal, st, T, s)))
    k_np = [a.cpu().numpy() for a in out_k]
    p_np = [a.cpu().numpy() for a in out_p]
    nb = len(k_np[2])
    st_eq = k_np[2] == p_np[2]
    it_eq = k_np[3] == p_np[3]
    both = st_eq & it_eq
    dx = float(np.abs(k_np[0] - p_np[0])[both].max())
    require(st_eq.sum() >= nb - -(-5 * nb // 512),
            f"{label}: K1 status equal on {st_eq.sum()}/{nb}")
    require(it_eq.sum() >= nb - -(-26 * nb // 512),
            f"{label}: K1 iterations equal on {it_eq.sum()}/{nb}")
    require(dx < 1e-3, f"{label}: K1 max|dx| {dx:.3e} on agreeing lanes")
    ms = cuda_ms(lambda: F.fused_palm(sd, scal, st, T, s), 3)
    say(f"[{label}] K1 vs twin: status equal {st_eq.sum()}/{nb}, iterations "
        f"equal {it_eq.sum()}/{nb}, max|dx| {dx:.2e}; K1 {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms ({T} iterations)")
    return k_np, p_np, dict(max_abs_err=dx, ms=ms, plain_ms=plain_ms)


def stationary(p, x, y, tol=5e-3):
    """tests/test_fused.py:225-239 on the unscaled problem in f64:
    Qx + q + A'y ~ 0, y_j > 0 only at the upper bound, < 0 only at the
    lower one."""
    import numpy as np

    Q, A, q, bl, bu = p
    x = x[:Q.shape[0]].astype(np.float64)
    y = y[:A.shape[0]].astype(np.float64)
    ax = A @ x
    return bool(np.max(np.abs(Q @ x + q + A.T @ y)) < tol
                and np.all((y <= 1e-3) | (ax > bu - 1e-3))
                and np.all((y >= -1e-3) | (ax < bl + 1e-3)))


def phase_nonconvex(dev):
    """Phase 6: the nonconvex front end on the BOXQP-d rows."""
    import numpy as np
    import torch

    from qpalm_tpu_torch import constants as C
    from qpalm_tpu_torch.batch import solve_batch, stack_problems
    from qpalm_tpu_torch.solver import fused as F
    from qpalm_tpu_torch.solver.nonconvex import batch_gamma_pins
    from qpalm_tpu_torch.types import Settings
    from qpalm_tpu_torch.workloads import boxqp

    s = Settings(**S_NC)
    launches, numbers = 0, None
    for n, m, nb in NC_ROWS:
        label = f"nonconvex n={n} m={m} B={nb}"
        probs = [boxqp(n, seed=1000 * n + i) for i in range(nb)]
        torch.cuda.synchronize()
        F.fused_palm.launches = 0
        t0 = time.perf_counter()
        res = solve_batch(probs, s, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches += F.fused_palm.launches
        require(F.fused_palm.launches > 0, f"{label}: K1 was not launched")

        d32 = stack_problems(probs, np.float32, device=dev)
        (gi, gm), lob_ms = timed(lambda: batch_gamma_pins(d32, s))
        sp = s.replace(proximal=True)
        sd, scal, st = F._prepare(d32, sp, gamma_init=gi, gamma_max=gm)
        k_np, _, num = kernel_vs_plain(F, sd, scal, st, sp, label)
        # times of the first (full-width) row, the largest error of both
        if numbers is None:
            numbers = num
        numbers["max_abs_err"] = max(numbers["max_abs_err"],
                                     num["max_abs_err"])
        status = res.status.cpu().numpy()
        require(np.array_equal(status, k_np[2]),
                f"{label}: solve_batch and K1 statuses differ")

        # pins: every lane the f64 spectrum of the scaled Q finds indefinite
        # is pinned, and Q_s + I/gamma is PSD to 1e-4
        lam = np.linalg.eigvalsh(sd.Q.double().cpu().numpy())[:, 0]
        gmax = gm.double().cpu().numpy()
        indef = lam < 0
        margin = lam + 1.0 / gmax
        require(np.all(gmax[indef] < s.gamma_max),
                f"{label}: {int((gmax[indef] >= s.gamma_max).sum())} "
                "indefinite lanes unpinned")
        require(np.all(margin[indef]
                       >= -1e-4 * np.maximum(1.0, np.abs(lam[indef]))),
                f"{label}: pin margin {margin[indef].min():.3e}")

        x, y = res.x.cpu().numpy(), res.y.cpu().numpy()
        require(np.isfinite(x).all() and np.isfinite(y).all(),
                f"{label}: non-finite x or y")
        solved = np.where(status == C.QPALM_SOLVED)[0]
        bad = [i for i in solved if not stationary(probs[i], x[i], y[i])]
        require(not bad, f"{label}: solved lanes not stationary: {bad[:8]}")
        say(f"[{label}] solved {len(solved)}/{nb} (all stationary), "
            f"indefinite {int(indef.sum())}, pinned "
            f"{int((gmax < s.gamma_max).sum())}, min pin margin "
            f"{margin[indef].min() if indef.any() else 0.0:.2e}; LOBPCG "
            f"{lob_ms:.1f} ms, solve_batch {wall:.3f} s, "
            f"mean iterations {res.iterations.float().mean().item():.1f}")
    return numbers, launches


def phase_dual(dev, probs, s32, x_cold):
    """Phase 7: dual-objective termination, the limit at the median of the
    cold solve's unscaled objectives."""
    import numpy as np
    import torch

    from qpalm_tpu_torch import constants as C
    from qpalm_tpu_torch.batch import solve_batch, stack_problems
    from qpalm_tpu_torch.solver import fused as F

    obj = np.array([0.5 * x @ Q @ x + q @ x for (Q, _, q, _, _), x in
                    zip(probs, x_cold[:, :probs[0][0].shape[0]]
                        .astype(np.float64))])
    limit = float(np.median(obj))
    s = s32.replace(enable_dual_termination=True, dual_objective_limit=limit)
    label = f"dual B={len(probs)}"
    torch.cuda.synchronize()
    F.fused_palm.launches = 0
    res = solve_batch(probs, s, device=dev)
    torch.cuda.synchronize()
    launches = F.fused_palm.launches
    require(launches > 0, f"{label}: K1 was not launched")
    sd, scal, st = F._prepare(stack_problems(probs, np.float32, device=dev), s)
    k_np, _, numbers = kernel_vs_plain(F, sd, scal, st, s, label)
    status = res.status.cpu().numpy()
    require(np.array_equal(status, k_np[2]),
            f"{label}: solve_batch and K1 statuses differ")
    n_dual = int((status == C.QPALM_DUAL_TERMINATED).sum())
    n_sol = int((status == C.QPALM_SOLVED).sum())
    require(n_dual > 0 and n_sol > 0,
            f"{label}: dual-terminated {n_dual}, solved {n_sol}")
    say(f"[{label}] limit {limit:.4f} (median objective): dual-terminated "
        f"{n_dual}, solved {n_sol}, other {len(status) - n_dual - n_sol}; "
        f"mean iterations {res.iterations.float().mean().item():.2f}")
    return numbers, launches


def phase_chunk_warm(dev, probs, s32, x_cold, y_cold):
    """Phase 8: host chunking against one launch, and a warm start."""
    import numpy as np
    import torch

    from qpalm_tpu_torch.batch import solve_batch, stack_problems
    from qpalm_tpu_torch.solver import fused as F

    torch.cuda.synchronize()
    F.fused_palm.launches = 0
    chunked = solve_batch(probs, s32, device=dev, chunk=16)
    torch.cuda.synchronize()
    n_chunk = F.fused_palm.launches
    single = solve_batch(probs, s32, device=dev)
    for name in ("x", "y", "status", "iterations"):
        require(torch.equal(getattr(chunked, name), getattr(single, name)),
                f"chunk=16: {name} differs from one launch")
    require(n_chunk > 1, f"chunk=16 made {n_chunk} launches")

    warm = [(Q, A, 1.01 * q, bl, bu) for Q, A, q, bl, bu in probs]
    cold = solve_batch(warm, s32, device=dev)
    # phase 4's solutions without their padding, and padded again with
    # zeros as solve_batch pads warm starts
    n, m = probs[0][0].shape[0], probs[0][1].shape[0]
    x_ws, y_ws = np.zeros_like(x_cold), np.zeros_like(y_cold)
    x_ws[:, :n], y_ws[:, :m] = x_cold[:, :n], y_cold[:, :m]
    torch.cuda.synchronize()
    F.fused_palm.launches = 0
    res = solve_batch(warm, s32, x0=list(x_ws[:, :n]), y0=list(y_ws[:, :m]),
                      device=dev)
    torch.cuda.synchronize()
    n_warm = F.fused_palm.launches
    require(n_warm > 0, "warm start: K1 was not launched")
    sd, scal, st = F._prepare(stack_problems(warm, np.float32, device=dev),
                              s32, x_ws=x_ws, y_ws=y_ws)
    k_np, _, _ = kernel_vs_plain(F, sd, scal, st, s32, "warm start")
    require(np.array_equal(res.status.cpu().numpy(), k_np[2]),
            "warm start: solve_batch and K1 statuses differ")
    it_w = res.iterations.float().mean().item()
    it_c = cold.iterations.float().mean().item()
    require(it_w < it_c, f"warm start: mean iterations {it_w:.2f} not below "
            f"cold {it_c:.2f}")
    say(f"[chunk] chunk=16: {n_chunk} launches, statuses, iterations, x and "
        f"y bit-identical to one launch; [warm] q*1.01 warm-started: mean "
        f"iterations {it_w:.2f} vs cold {it_c:.2f}, solved "
        f"{int((res.status == 1).sum())}/{len(warm)}, launches {n_warm}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA card")
    root = Path(__file__).resolve().parent
    if not (root / "qpalm_tpu_torch" / "__init__.py").exists():
        fail(f"qpalm_tpu_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(root))

    import numpy as np

    from qpalm_tpu_torch import _build
    from qpalm_tpu_torch.batch import stack_problems
    from qpalm_tpu_torch.linalg import chol
    from qpalm_tpu_torch.polish_device import polish_batch
    from qpalm_tpu_torch.precision import full_f32_matmul
    from qpalm_tpu_torch.referee import referee
    from qpalm_tpu_torch.solver import fused as F
    from qpalm_tpu_torch.types import Settings
    from qpalm_tpu_torch.workloads import make_problems

    dev = torch.device("cuda")
    full_f32_matmul()

    # ---- 1. environment ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    require(smi, "nvidia-smi printed nothing")
    smi_line = smi[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    say(f"[env] nvcc: {nvcc[-1] if nvcc else 'unknown'}")
    say(f"[env] nvidia-smi: {smi_line}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib_path, log = _build.build(verbose=True)
    _build.kernels()
    say(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            say(f"[build] {line.strip()}")

    numbers = {}

    # ---- 3. K2 against its plain twin ----
    rng = np.random.default_rng(0)
    G = rng.standard_normal((B, N, N)).astype(np.float32)
    M_spd = torch.from_numpy(
        G @ np.transpose(G, (0, 2, 1)) + N * np.eye(N, dtype=np.float32)
    ).to(dev)
    R = chol.cholesky_upper(M_spd)
    Rp = chol.cholesky_upper_plain(M_spd)
    torch.cuda.synchronize()
    R64 = R.double()
    rel = ((R64.transpose(1, 2) @ R64 - M_spd.double()).abs().max()
           / M_spd.double().abs().max()).item()
    diff = ((R - Rp).abs().max() / Rp.abs().max()).item()
    require(torch.equal(R, torch.triu(R)), "K2 factor is not upper")
    require(rel < 1e-5, f"K2 max|R'R-M|/max|M| = {rel:.3e}")
    require(diff < 1e-4, f"K2 kernel vs plain rel diff {diff:.3e}")
    eye = torch.eye(N, device=dev).expand(B, N, N).contiguous()
    X = chol.cholesky_solve(R, eye)
    Xp = chol.cholesky_solve_plain(R, eye)
    torch.cuda.synchronize()
    res = (M_spd.double() @ X.double() - eye.double()).abs().max().item()
    sdiff = ((X - Xp).abs().max() / Xp.abs().max()).item()
    require(res < 1e-4, f"K2 solve residual {res:.3e}")
    require(sdiff < 1e-4, f"K2 solve kernel vs plain rel diff {sdiff:.3e}")
    numbers["chol"] = dict(
        max_abs_err=(R - Rp).abs().max().item(),
        ms=cuda_ms(lambda: chol.cholesky_upper(M_spd), 20),
        plain_ms=cuda_ms(lambda: chol.cholesky_upper_plain(M_spd), 3))
    numbers["chol_solve"] = dict(
        max_abs_err=(X - Xp).abs().max().item(),
        ms=cuda_ms(lambda: chol.cholesky_solve(R, eye), 20),
        plain_ms=cuda_ms(lambda: chol.cholesky_solve_plain(R, eye), 3))
    say(f"[K2] factor rel {rel:.2e}, vs plain {diff:.2e}; identity solve "
        f"residual {res:.2e}, vs plain {sdiff:.2e}; factor "
        f"{numbers['chol']['ms']:.4f} ms (plain "
        f"{numbers['chol']['plain_ms']:.3f}), solve "
        f"{numbers['chol_solve']['ms']:.4f} ms (plain "
        f"{numbers['chol_solve']['plain_ms']:.3f}) at ({B}, {N}, {N})")

    # ---- 4. K1 against its plain twin ----
    s32 = Settings(dtype="float32", eps_abs=5e-5, eps_rel=5e-5, max_iter=96,
                   scaling=2, max_refine=0, delta=10.0)  # bench.py:194-197
    probs = make_problems(B, N, M, seed=7)
    d32 = stack_problems(probs, np.float32, device=dev)
    sd, scal, st = F._prepare(d32, s32)
    T = s32.max_iter
    out_k = F._finish(sd, scal, F.fused_palm(sd, scal, st, T, s32))
    out_k2 = F._finish(sd, scal, F.fused_palm(sd, scal, st, T, s32))
    out_p = F._finish(sd, scal, F.fused_palm_plain(sd, scal, st, T, s32))
    torch.cuda.synchronize()
    k_np = [a.cpu().numpy() for a in out_k]
    p_np = [a.cpu().numpy() for a in out_p]
    require(all(np.array_equal(a.cpu().numpy(), b, equal_nan=True)
                for a, b in zip(out_k2, k_np)), "K1 rerun not bit-identical")
    st_eq = k_np[2] == p_np[2]
    it_eq = k_np[3] == p_np[3]
    both = st_eq & it_eq
    dx = float(np.abs(k_np[0] - p_np[0])[both].max())
    require(st_eq.sum() >= B - 5, f"K1 status equal on {st_eq.sum()}/{B}")
    require(it_eq.sum() >= B - 26, f"K1 iterations equal on {it_eq.sum()}/{B}")
    require(dx < 1e-3, f"K1 max|dx| {dx:.3e} on agreeing lanes")
    numbers["fused_palm"] = dict(
        max_abs_err=dx,
        ms=cuda_ms(lambda: F.fused_palm(sd, scal, st, T, s32), 5),
        plain_ms=cuda_ms(lambda: F.fused_palm_plain(sd, scal, st, T, s32),
                         1))
    solved = int((k_np[2] == 1).sum())
    say(f"[K1] status equal {st_eq.sum()}/{B}, iterations equal "
        f"{it_eq.sum()}/{B}, max|dx| {dx:.2e}; kernel solved {solved}/{B}, "
        f"mean iterations {k_np[3].mean():.2f}, max {k_np[3].max()}; kernel "
        f"{numbers['fused_palm']['ms']:.3f} ms, plain "
        f"{numbers['fused_palm']['plain_ms']:.1f} ms")

    # ---- 5. the slice ----
    rounds = [make_problems(B, N, M, seed=7 + 1000 * k) for k in range(ROUNDS)]
    counters = (F.fused_palm, chol.cholesky_upper, chol.cholesky_solve)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    n_cert = n_disagree = 0
    for k, probs in enumerate(rounds):
        t0 = time.perf_counter()
        d32 = stack_problems(probs, np.float32, device=dev)
        d64 = stack_problems(probs, np.float64, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x, y, status, iters = F.solve_batch_fused(d32, s32)[:4]
        pol = polish_batch(d64, x, y, eps_abs=EPS_TARGET, eps_rel=EPS_TARGET,
                           refine_iters=2, second_round_k=64,
                           seed_guard="norm", residual32=False,
                           accept_viol=1.0)
        ok = pol.ok.cpu().numpy()
        t2 = time.perf_counter()
        require(tuple(pol.x.shape) == (B, N) and tuple(pol.y.shape) == (B, M),
                f"round {k}: polished shapes {tuple(pol.x.shape)}, "
                f"{tuple(pol.y.shape)}")
        require(bool(torch.isfinite(pol.x[pol.ok]).all())
                and bool(torch.isfinite(pol.y[pol.ok]).all()),
                f"round {k}: non-finite certified solutions")
        ref_ok = referee(d64, pol.x, pol.y, EPS_TARGET, EPS_TARGET)
        n_cert += int(ok.sum())
        n_disagree += int((ok & ~ref_ok).sum())
        say(f"[slice] round {k}: certified {int(ok.sum())}/{B}, referee "
            f"agrees on {int((ok & ref_ok).sum())}, kernel solved "
            f"{int((status == 1).sum())}, stack+copy {t1 - t0:.3f} s, "
            f"solve+polish {t2 - t1:.3f} s, round {t2 - t0:.3f} s")
    launches = {c.__name__: c.launches for c in counters}
    say(f"[slice] certified {n_cert}/{ROUNDS * B}, all re-checked by the "
        f"referee: disagreements {n_disagree}; launches {launches}")
    require(n_cert >= 0.95 * ROUNDS * B, f"certified {n_cert}/{ROUNDS * B}")
    require(n_disagree == 0, f"{n_disagree} referee disagreements")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")

    # ---- 6-8. the front end on K1's other tiers ----
    t0 = time.perf_counter()
    numbers["fused_palm_nonconvex"], launches["fused_palm_nonconvex"] = \
        phase_nonconvex(dev)
    t1 = time.perf_counter()
    probs = make_problems(B, N, M, seed=7)
    numbers["fused_palm_dual"], launches["fused_palm_dual"] = \
        phase_dual(dev, probs, s32, k_np[0])
    t2 = time.perf_counter()
    phase_chunk_warm(dev, probs, s32, k_np[0], k_np[1])
    say(f"[time] phase 6 {t1 - t0:.1f} s, phase 7 {t2 - t1:.1f} s, phase 8 "
        f"{time.perf_counter() - t2:.1f} s")

    csrc = "qpalm_tpu_torch/csrc/"
    table = [
        ("fused_palm", "fused_palm", csrc + "fused_palm.cu",
         "qpalm_tpu/solver/fused.py:186"),
        ("fused_palm_nonconvex", "fused_palm_nonconvex",
         csrc + "fused_palm.cu", "qpalm_tpu/solver/fused.py:186"),
        ("fused_palm_dual", "fused_palm_dual", csrc + "fused_palm.cu",
         "qpalm_tpu/solver/fused.py:186"),
        ("chol", "cholesky_upper", csrc + "chol.cu",
         "qpalm_tpu/linalg/pallas_chol.py:98"),
        ("chol_solve", "cholesky_solve", csrc + "chol.cu",
         "qpalm_tpu/linalg/pallas_chol.py:123"),
    ]
    say(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[counter], **numbers[name])
        for name, counter, src, rep in table]}))
    say(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
