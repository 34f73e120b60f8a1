"""Time K1, or K2's factor or solve, in one or more copies of the port, on
the card.

    python tools/stream_ab.py [--tier stream|smem]
                              [--kernel k1|chol|chol_solve|chol_solve_stage|
                                        chol_wide|general]
                              [DIR ...]

Each DIR holds a `qpalm_tpu_torch` package (default: this checkout's).
Each copy is built and timed in a process of its own, in the order given,
so two versions compare within one run on one card (A B B A).  Each launch
is timed as the mean of 3 launches after a warm-up by CUDA events, from
the same state, and split by the kernel's cycle counters
(`fused.profile_split`) where the copy has them.  One JSON line per copy,
with a hash of the final state: copies that keep the kernel's arithmetic
print the same one.

`--tier stream` (the default): the streaming kernel at randomQP n=352,
B=128, the workloads sweep's settings, 30 iterations.

`--tier smem`: the on-chip kernel at the headline round (B=512, n=64,
m=96, bench.py's f32 settings, max_iter 96) and at BOXQP-d n=64, m=80,
B=256 under its gamma pins (scripts/bench_nonconvex.py's f32 settings, 400
iterations, which every lane runs).  A copy from before the on-chip
counters is timed with no split.

`--kernel chol_solve`: K2b (`linalg.chol.cholesky_solve`) with identity
right-hand sides, as the polish calls it, at (512, 64, 64) and at the
second round's (64, 64, 64), each the mean of 100 launches by CUDA events
after 0.3 s of warm-up, queued behind a device sleep so that the host's
time per call is not counted, from the factor of chip_smoke.py phase 3's
SPD batch, and the f64 solve of one vector a matrix at (512, 64).  Then
the global plan (`chol_solve_global_kernel`) on the factors of the SPD
batch below: one vector a matrix at (64, 480) in f32 and f64, as the
general loop solves randomQP n=480, and the identity at f32 (64, 480,
480), as the device polish calls it there.
`--kernel chol_solve_stage`: K2b at f64 at chip_smoke.py phase 18's
stage shapes, (B, nb, k) = (1, 119, 1), (1, 119, 119), (8, 119, 119),
(8, 119, 239), (1, 29, 1), (1, 29, 29) (one vector for k = 1, as block
Thomas passes it), on G G' + nb I from `default_rng(18)`, each the mean of
20 launches queued as above, with a hash of its output (since PR 16 the
warp solve; before it PR 6's entry plan).
`--kernel chol`: K2a (`linalg.chol.cholesky_upper`) on phase 3's batch,
and the cluster factor at (64, 480, 480) in f32 and f64 on an SPD batch
from `default_rng(1)`, timed the same way.
`--kernel chol_wide`: K2's wide plans at chip_smoke.py phase 15's sizes:
the solve (`linalg.chol.cholesky_solve`; the stripe solve since PR 12),
one vector, at f64 n = 14536 and f32 n = 16392 (R a random upper
triangle with a dominant diagonal from a seeded CUDA generator), and the
factor (`linalg.chol.cholesky_upper`; the grid factor since PR 12) at f64
(1, 3640, 3640) and f32 (1, 7272, 7272) (G G' + n I, G from a seeded
CUDA generator), each the mean of 5 launches, queued as above, with a
hash of its output.
`--kernel general`: the general loop end to end, `batch.solve_batch` of the
sweep's randomQP n=480 row (B=64) at the default `Settings()` (f64), as
chip_smoke.py phase 14 runs it: the host wall of two solves after one
warm-up, each synchronised, with the K2 launches of the last by kernel and
a hash of its x.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from qpalm_tpu_torch.batch import stack_problems
from qpalm_tpu_torch.solver import fused as F

def timed(sd, scal, st, T, s):
    F.fused_palm(sd, scal, st, T, s)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        out = F.fused_palm(sd, scal, st, T, s)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 3
    F.fused_palm.profile = []
    F.fused_palm(sd, scal, st, T, s)
    profs, F.fused_palm.profile = F.fused_palm.profile, None
    split = F.profile_split(profs[0], ms) if profs else None
    sha = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in out))
    return dict(ms=ms, iterations=int(out.sc[:, F._ITER].sum()),
                max_iterations=int(out.sc[:, F._ITER].max()),
                state_sha256=sha.hexdigest()[:16], split_ms=split)

def queued(fn, reps=100):
    # fn()'s output and its mean milliseconds over reps launches
    out = fn()
    warm_until = time.perf_counter() + 0.3  # the card raises its clock
    while time.perf_counter() < warm_until:
        fn()
        torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # the host queues the launches behind a device sleep, so that they
    # run back to back and the wrapper's host time is not counted
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    sha = hashlib.sha256(out.cpu().numpy().tobytes())
    return dict(ms=start.elapsed_time(end) / reps,
                out_sha256=sha.hexdigest()[:16])

def wide_spd(dt):
    # the general loop's matrices past shared memory (randomQP n=480)
    G = np.random.default_rng(1).standard_normal((64, 480, 480))
    return torch.from_numpy((G @ np.transpose(G, (0, 2, 1))
                             + 480 * np.eye(480)).astype(dt)).cuda()

runs = {}
if sys.argv[2] in ("chol", "chol_solve"):
    from qpalm_tpu_torch.linalg import chol
    G = np.random.default_rng(0).standard_normal((512, 64, 64)).astype(
        np.float32)
    M = torch.from_numpy(G @ np.transpose(G, (0, 2, 1))
                         + 64 * np.eye(64, dtype=np.float32)).cuda()
    R = chol.cholesky_upper(M)
    for B in (512, 64):
        Rb = R[:B].contiguous()
        if sys.argv[2] == "chol":
            Mb = M[:B].contiguous()
            runs[f"({B}, 64, 64)"] = queued(lambda: chol.cholesky_upper(Mb))
            continue
        eye = torch.eye(64, device="cuda").expand(B, 64, 64).contiguous()
        runs[f"({B}, 64, 64)"] = queued(lambda: chol.cholesky_solve(Rb, eye))
    if sys.argv[2] == "chol":
        for dt in (np.float32, np.float64):
            Mw = wide_spd(dt)
            runs[f"{dt.__name__} (64, 480, 480)"] = queued(
                lambda: chol.cholesky_upper(Mw))
    else:
        # the general loop's f64 solve, one vector a matrix
        M64, b64 = M.double(), torch.from_numpy(
            np.random.default_rng(2).standard_normal((512, 64))).cuda()
        R64 = chol.cholesky_upper(M64)
        runs["float64 (512, 64)"] = queued(
            lambda: chol.cholesky_solve(R64, b64))
        # the global plan: one vector a matrix, then the polish's identity
        for dt in (np.float32, np.float64):
            Rw = chol.cholesky_upper(wide_spd(dt))
            bw = torch.from_numpy(np.random.default_rng(2).standard_normal(
                (64, 480)).astype(dt)).cuda()
            runs[f"{dt.__name__} (64, 480)"] = queued(
                lambda: chol.cholesky_solve(Rw, bw))
            if dt is np.float32:
                eye = torch.eye(480, device="cuda").expand(64, 480,
                                                           480).contiguous()
                runs["float32 (64, 480, 480) identity"] = queued(
                    lambda: chol.cholesky_solve(Rw, eye))
elif sys.argv[2] == "chol_solve_stage":
    from qpalm_tpu_torch.linalg import chol
    rng = np.random.default_rng(18)
    for B, nb, k in ((1, 119, 1), (1, 119, 119), (8, 119, 119),
                     (8, 119, 239), (1, 29, 1), (1, 29, 29)):
        G = rng.standard_normal((B, nb, nb))
        Rs = chol.cholesky_upper(torch.from_numpy(
            G @ np.transpose(G, (0, 2, 1)) + nb * np.eye(nb)).cuda())
        bs = torch.from_numpy(rng.standard_normal(
            (B, nb) if k == 1 else (B, nb, k))).cuda()
        runs[f"float64 ({B}, {nb}, {k})"] = queued(
            lambda: chol.cholesky_solve(Rs, bs), 20)
elif sys.argv[2] == "chol_wide":
    from qpalm_tpu_torch.linalg import chol
    for n, dt in ((14536, torch.float64), (16392, torch.float32)):
        g = torch.Generator(device="cuda").manual_seed(150)
        Rw = torch.triu(torch.rand((1, n, n), generator=g, device="cuda",
                                   dtype=dt) - 0.5)
        Rw.diagonal(dim1=1, dim2=2).fill_(n)
        bw = torch.randn((1, n), generator=g, device="cuda", dtype=dt)
        runs[f"{dt} (1, {n})"] = queued(lambda: chol.cholesky_solve(Rw, bw),
                                        5)
        del Rw
    for n, dt in ((3640, torch.float64), (7272, torch.float32)):
        g = torch.Generator(device="cuda").manual_seed(15)
        G = torch.randn((1, n, n), generator=g, device="cuda", dtype=dt)
        Mw = G @ G.transpose(1, 2) + n * torch.eye(n, device="cuda",
                                                   dtype=dt)
        del G
        runs[f"{dt} (1, {n}, {n})"] = queued(
            lambda: chol.cholesky_upper(Mw), 5)
        del Mw
elif sys.argv[2] == "general":
    from qpalm_tpu_torch import sweep
    from qpalm_tpu_torch.batch import solve_batch
    from qpalm_tpu_torch.linalg import chol
    from qpalm_tpu_torch.types import Settings
    probs = sweep.row_problems("randomQP", 480, batch=64)
    solve_batch(probs, Settings(), device="cuda")
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        chol.KERNEL_LAUNCHES.clear()
        t0 = time.perf_counter()
        res = solve_batch(probs, Settings(), device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    sha = hashlib.sha256(res.x.cpu().numpy().tobytes())
    runs["randomQP 480 Settings()"] = dict(
        wall_s=walls, launches=dict(chol.KERNEL_LAUNCHES),
        x_sha256=sha.hexdigest()[:16])
elif sys.argv[2] == "stream":
    from qpalm_tpu_torch import sweep
    s = sweep.S32
    data = stack_problems(sweep.row_problems("randomQP", 352), np.float32,
                          device="cuda")
    runs["randomQP 352"] = timed(*F._prepare(data, s), 30, s)
else:
    from qpalm_tpu_torch.solver.nonconvex import batch_gamma_pins
    from qpalm_tpu_torch.types import Settings
    from qpalm_tpu_torch.workloads import boxqp, make_problems
    s = Settings(dtype="float32", eps_abs=5e-5, eps_rel=5e-5, max_iter=96,
                 scaling=2, max_refine=0, delta=10.0)
    data = stack_problems(make_problems(512, 64, 96, seed=7), np.float32,
                          device="cuda")
    runs["headline"] = timed(*F._prepare(data, s), 96, s)
    s = Settings(dtype="float32", nonconvex=True, eps_abs=1e-4,
                 eps_rel=1e-4, max_iter=400, scaling=2, max_refine=0,
                 verbose=False)
    data = stack_problems([boxqp(64, seed=64000 + i) for i in range(256)],
                          np.float32, device="cuda")
    gi, gm = batch_gamma_pins(data, s)
    s = s.replace(proximal=True)
    runs["boxqp 64"] = timed(*F._prepare(data, s, gamma_init=gi,
                                         gamma_max=gm), 400, s)
print(json.dumps({"dir": sys.argv[1], "device": torch.cuda.get_device_name(0),
                  "mode": sys.argv[2], "runs": runs}))
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tier", choices=("stream", "smem"), default="stream")
    ap.add_argument("--kernel", choices=("k1", "chol", "chol_solve",
                                         "chol_solve_stage", "chol_wide",
                                         "general"),
                    default="k1")
    ap.add_argument("dirs", nargs="*")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    mode = args.tier if args.kernel == "k1" else args.kernel
    for d in args.dirs or [str(ROOT)]:
        proc = subprocess.run([sys.executable, "-c", CHILD,
                               str(Path(d).resolve()), mode],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{d}: exit {proc.returncode}\n{proc.stderr}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
