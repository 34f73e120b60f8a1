"""Time every shape of K2's factor past shared memory on the card: the
cluster factor (csrc/chol.cu, chol_cluster_kernel) in every cluster and
panel whose panel fits a CTA's shared memory, and the grid factor
(chol_grid_kernel) in each of its panel sizes; hold each to the plain
twin bit for bit.

    python tools/chol_plans.py [f32:64:480 f64:1:3640 ...]
    python tools/chol_plans.py --solve [f64:1:3640 ...]

Each argument is dtype:B:n (default: the general loop's randomQP n=480
at B=64, f32 and f64, f64 (128, 224), B = 1 at f64 n = 1024 and 2048,
and the wide plan's first sizes, f64 (1, 3640) and f32 (1, 7272)).  For
each: an SPD batch G G' + n I (G from numpy seed 14, the product on the
card), then every cluster (cluster 1, 2, 4, 8, b 8, 16, 32 where the
panel fits) and every grid plan (the card's CTAs, b in chol.GRID_BS), its
milliseconds (chip_smoke.cuda_ms, 5 launches) and whether R equals the
twin's; the plan `linalg.chol.global_plan` picks is marked; the three
fastest and the picked one are split by their profiled instantiation's
cycle counters (the time in ms shared out by the mean cycles of a CTA's
thread 0 in each of `chol.CLUSTER_SECTIONS` or `chol.GRID_SECTIONS`).
Where the picked plan is a cluster factor, the grid factor is then timed
against it A B B A (`abba_ms`, with whether the two R are equal).  One
JSON line a shape, after nvidia-smi's name and power limit.

`--solve`: the one-vector solve of each shape (default SOLVES: the wide
sizes, the solve_batch shape of chip_smoke.py phase 15 and the shapes
around the stripe solve's thresholds in linalg/chol.py) in the stripe
solve at every width (chol.STRIPE_WS) and in the global solve where its
limits take n, each held to the twin bit for bit, beside
torch.cholesky_solve; R the factor of the SPD batch above (or, past f64 n
= 8192, a random upper triangle with a dominant diagonal), b from numpy
seed 15.  The plan `solve_plan` picks is named.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DEFAULT = ("f32:64:480", "f64:64:480", "f64:128:224", "f64:1:1024",
           "f64:1:2048", "f64:1:3640", "f32:1:7272")
SOLVES = ("f64:1:14536", "f32:1:16392", "f64:1:3640", "f64:4:3640",
          "f64:16:3640", "f32:1:7272", "f64:1:480", "f64:64:480",
          "f32:64:480", "f32:1:1024", "f32:1:4096")


def solves(specs):
    """The --solve table (module docstring)."""
    import numpy as np
    import torch

    from chip_smoke import cuda_ms
    from qpalm_tpu_torch._build import check_launch, kernels
    from qpalm_tpu_torch.linalg import chol

    lib = kernels()
    st = torch.cuda.current_stream().cuda_stream
    for spec in specs or SOLVES:
        name, nb, n = spec.split(":")
        nb, n = int(nb), int(n)
        dt = {"f32": torch.float32, "f64": torch.float64}[name]
        es, f64 = (4 if dt == torch.float32 else 8), int(dt == torch.float64)
        if n <= 8192:
            G = torch.from_numpy(np.random.default_rng(14).standard_normal(
                (nb, n, n))).to("cuda", dt)
            R = chol.cholesky_upper(G @ G.transpose(1, 2) + n * torch.eye(
                n, dtype=dt, device="cuda"))
            del G
        else:
            g = torch.Generator(device="cuda").manual_seed(150)
            R = torch.triu(torch.rand((nb, n, n), generator=g, device="cuda",
                                      dtype=dt) - 0.5)
            R.diagonal(dim1=1, dim2=2).fill_(n)
        b = torch.from_numpy(np.random.default_rng(15).standard_normal(
            (nb, n))).to("cuda", dt)
        want = chol.cholesky_solve_plain(R, b)
        torch.cuda.synchronize()

        def stripe(w):
            x = torch.empty_like(b)
            sync = torch.zeros(chol.stripe_sync_ints(nb, n, 1, w),
                               dtype=torch.int32, device="cuda")
            check_launch("stripe", lib.qp_chol_solve_stripe(
                R.data_ptr(), b.data_ptr(), x.data_ptr(), nb, n, 1, w,
                sync.data_ptr(), f64, st))
            return x

        def glob():
            x = torch.empty_like(b)
            check_launch("global", lib.qp_chol_solve_global(
                R.data_ptr(), b.data_ptr(), x.data_ptr(), nb, n, 1,
                *chol.global_solve_shape(n, dt), f64, st))
            return x

        fns = {f"stripe{w}": (lambda w=w: stripe(w)) for w in chol.STRIPE_WS}
        if 2 * n * es <= chol.SMEM_LIMIT and n <= chol.GS_N_MAX:
            fns["global"] = glob
        out = {"shape": spec, "device": torch.cuda.get_device_name(0),
               "plan": list(chol.solve_plan(nb, n, 1, dt)),
               "stripe_w": chol.STRIPE_W[dt]}
        for key, fn in fns.items():
            same = bool(torch.equal(fn(), want))
            out[key] = dict(ms=cuda_ms(fn, 5), bit_identical=same)
        out["library_ms"] = cuda_ms(lambda: torch.cholesky_solve(
            b[..., None], R, upper=True), 5)
        print(json.dumps(out), flush=True)
        del R


def main(argv=None):
    import numpy as np
    import torch

    from chip_smoke import cuda_ms
    from qpalm_tpu_torch._build import check_launch
    from qpalm_tpu_torch.linalg import chol

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    args = list(argv if argv is not None else sys.argv[1:])
    if args[:1] == ["--solve"]:
        return solves(args[1:])
    for spec in args or DEFAULT:
        name, nb, n = spec.split(":")
        nb, n = int(nb), int(n)
        dt = {"f32": np.float32, "f64": np.float64}[name]
        G = torch.from_numpy(np.random.default_rng(14).standard_normal(
            (nb, n, n)).astype(dt)).cuda()
        M = G @ G.transpose(1, 2) + n * torch.eye(n, dtype=G.dtype,
                                                  device="cuda")
        del G
        want = chol.cholesky_upper_plain(M)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        picked = chol.global_plan(nb, n, M.dtype, sms)
        R = torch.empty_like(M)
        plans = [chol.GlobalPlan(C, b) for C in (1, 2, 4, chol.CLUSTER_MAX)
                 for b in (8, 16, 32)
                 if chol.global_smem_bytes(n, M.dtype, b) <= chol.SMEM_LIMIT]
        plans += [chol.GridPlan(sms, b) for b in chol.GRID_BS]
        rows = []
        for plan in plans:
            grid = isinstance(plan, chol.GridPlan)
            row = dict(kernel="grid" if grid else "cluster",
                       **plan._asdict(), picked=plan == picked)
            if not grid:
                row["panel_bytes"] = chol.global_smem_bytes(n, M.dtype,
                                                            plan.b)
            R.fill_(float("nan"))
            rc = chol._launch_global(M, R, plan)
            if rc:
                row["refused"] = rc
                rows.append(row)
                continue
            torch.cuda.synchronize()
            row["bit_identical"] = bool(torch.equal(R, want))
            row["ms"] = cuda_ms(lambda: chol._launch_global(M, R, plan), 5)
            rows.append((plan, row))
            print(json.dumps(row), file=sys.stderr, flush=True)
        timed = sorted((r for r in rows if isinstance(r, tuple)),
                       key=lambda r: r[1]["ms"])
        split = {}
        for plan, r in timed[:3] + [t for t in timed[3:] if t[1]["picked"]]:
            prof = torch.zeros((chol.prof_ctas(nb, plan), 8),
                               dtype=torch.int64, device="cuda")
            check_launch("factor", chol._launch_global(M, R, plan, prof))
            mean = prof.double().mean(0).tolist()
            secs = (chol.GRID_SECTIONS if isinstance(plan, chol.GridPlan)
                    else chol.CLUSTER_SECTIONS)
            total = sum(mean[:len(secs)])
            split[f"{r['kernel']} {tuple(plan)}"] = {
                sec: round(r["ms"] * c / total, 4)
                for sec, c in zip(secs, mean)}
        out = {"shape": spec, "device": torch.cuda.get_device_name(0),
               "plans": [r[1] if isinstance(r, tuple) else r for r in rows],
               "split_ms": split}
        if isinstance(picked, chol.GlobalPlan):
            forced = chol.GridPlan(sms, chol.GRID_B)
            R0, R1 = torch.empty_like(M), torch.empty_like(M)
            abba = []
            for plan, Rx in ((picked, R0), (forced, R1), (forced, R1),
                             (picked, R0)):
                abba.append([type(plan).__name__, cuda_ms(
                    lambda: chol._launch_global(M, Rx, plan), 20)])
            torch.cuda.synchronize()
            out["abba_ms"] = abba
            out["abba_equal"] = bool(torch.equal(R0, R1))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
