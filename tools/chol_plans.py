"""Time every shape of K2's cluster factor (csrc/chol.cu,
chol_cluster_kernel) on the card, with each CTA's panel in its shared
memory where it fits and in a global scratch (the wide plan), and hold
each to the plain twin bit for bit.

    python tools/chol_plans.py [f32:64:480 f64:1:3640 ...]

Each argument is dtype:B:n (default: the general loop's randomQP n=480
at B=64, f32 and f64, f64 (128, 224), and the wide plan's first sizes,
f64 (1, 3640) and f32 (1, 7272)). For each: an SPD batch G G' + n I (G
from numpy seed 14, the product on the card), then every (cluster, b,
panel) with cluster 1, 2, 4, 8, b 8, 16, 32 (and 64 for a panel in
global memory) whose shared memory fits, its milliseconds
(chip_smoke.cuda_ms, 5 launches) and whether R equals the twin's; the
shape `linalg.chol.global_plan` picks is marked; the three fastest and
the picked one are split by the profiled instantiation's cycle counters
(the time in ms shared out by the mean cycles of a CTA's thread 0 in
each of `chol.CLUSTER_SECTIONS`). Where the picked plan keeps its panel
in shared memory, the same shape with its panel in global memory is then
timed against it A B B A (`abba_ms`, with whether the two R are equal).
One JSON line a shape, after nvidia-smi's name and power limit.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DEFAULT = ("f32:64:480", "f64:64:480", "f64:128:224", "f64:1:3640",
           "f32:1:7272")


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
    for spec in (argv if argv is not None else sys.argv[1:]) or DEFAULT:
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
        rows = []
        for C in (1, 2, 4, chol.CLUSTER_MAX):
            for panel, bs in (("smem", (8, 16, 32)),
                              ("global", (8, 16, 32, 64))):
                for b in bs:
                    smem = chol.global_smem_bytes(n, M.dtype, b)
                    if panel == "smem" and smem > chol.SMEM_LIMIT:
                        continue
                    plan = chol.GlobalPlan(C, b, panel)
                    row = dict(cluster=C, b=b, panel=panel, panel_bytes=smem,
                               picked=plan == picked)
                    R.fill_(float("nan"))
                    rc = chol._launch_global(M, R, plan)
                    if rc:
                        row["refused"] = rc
                        rows.append(row)
                        continue
                    torch.cuda.synchronize()
                    row["bit_identical"] = bool(torch.equal(R, want))
                    row["ms"] = cuda_ms(
                        lambda: chol._launch_global(M, R, plan), 5)
                    rows.append(row)
                    print(json.dumps(row), file=sys.stderr, flush=True)
        timed = sorted((r for r in rows if "ms" in r), key=lambda r: r["ms"])
        split = {}
        for r in timed[:3] + [r for r in timed[3:] if r["picked"]]:
            plan = chol.GlobalPlan(r["cluster"], r["b"], r["panel"])
            prof = torch.zeros((nb * plan.cluster, 8), dtype=torch.int64,
                               device="cuda")
            check_launch("qp_chol_global",
                         chol._launch_global(M, R, plan, prof))
            mean = prof.double().mean(0).tolist()
            total = sum(mean[:len(chol.CLUSTER_SECTIONS)])
            split[f"{r['cluster']},{r['b']},{r['panel']}"] = {
                sec: round(r["ms"] * c / total, 4)
                for sec, c in zip(chol.CLUSTER_SECTIONS, mean)}
        out = {"shape": spec, "device": torch.cuda.get_device_name(0),
               "plans": rows, "split_ms": split}
        if picked.panel == "smem":
            forced = picked._replace(panel="global")
            R0, R1 = torch.empty_like(M), torch.empty_like(M)
            abba = []
            for plan, Rx in ((picked, R0), (forced, R1), (forced, R1),
                             (picked, R0)):
                abba.append([plan.panel, cuda_ms(
                    lambda: chol._launch_global(M, Rx, plan), 20)])
            torch.cuda.synchronize()
            out["abba_ms"] = abba
            out["abba_equal"] = bool(torch.equal(R0, R1))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
