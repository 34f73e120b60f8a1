"""Time every shape of K2's cluster factor (csrc/chol.cu,
chol_cluster_kernel) that fits a CTA, on the card, and hold each to the
plain twin bit for bit.

    python tools/chol_plans.py [f32:64:480 f64:64:480 ...]

Each argument is dtype:B:n (default: the general loop's randomQP n=480 at
B=64, f32 and f64, and f64 (128, 224)).  For each: an SPD batch G G' + n I
(numpy seed 14), then every (cluster, b) with cluster 1, 2, 4, 8 and b 8,
16, 32 whose shared memory fits, its milliseconds (chip_smoke.cuda_ms, 5
launches) and whether R equals the twin's; the shape
`linalg.chol.global_plan` picks is marked; the three fastest and the
picked one are split by the profiled instantiation's cycle counters (the
time in ms shared out by the mean cycles of a CTA's thread 0 in each of
`chol.CLUSTER_SECTIONS`).  One JSON line a shape, after nvidia-smi's name
and power limit.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DEFAULT = ("f32:64:480", "f64:64:480", "f64:128:224")


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
        G = np.random.default_rng(14).standard_normal((nb, n, n)).astype(dt)
        M = torch.from_numpy(G @ np.transpose(G, (0, 2, 1))
                             + n * np.eye(n, dtype=dt)).cuda()
        want = chol.cholesky_upper_plain(M)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        picked = chol.global_plan(nb, n, M.dtype, sms)
        R = torch.empty_like(M)
        rows = []
        for C in (1, 2, 4, chol.CLUSTER_MAX):
            for b in (8, 16, 32):
                smem = chol.global_smem_bytes(n, M.dtype, b)
                if smem > chol.SMEM_LIMIT:
                    continue
                plan = chol.GlobalPlan(C, b)
                row = dict(cluster=C, b=b, smem=smem, picked=plan == picked)
                R.fill_(float("nan"))
                rc = chol._launch_global(M, R, plan)
                if rc:
                    row["refused"] = rc
                    rows.append(row)
                    continue
                torch.cuda.synchronize()
                row["bit_identical"] = bool(torch.equal(R, want))
                row["ms"] = cuda_ms(lambda: chol._launch_global(M, R, plan),
                                    5)
                rows.append(row)
                print(json.dumps(row), file=sys.stderr, flush=True)
        timed = sorted((r for r in rows if "ms" in r), key=lambda r: r["ms"])
        split = {}
        for r in timed[:3] + [r for r in timed[3:] if r["picked"]]:
            plan = chol.GlobalPlan(r["cluster"], r["b"])
            prof = torch.zeros((nb * plan.cluster, 8), dtype=torch.int64,
                               device="cuda")
            check_launch("qp_chol_global",
                         chol._launch_global(M, R, plan, prof))
            mean = prof.double().mean(0).tolist()
            total = sum(mean[:len(chol.CLUSTER_SECTIONS)])
            split[f"{r['cluster']},{r['b']}"] = {
                sec: round(r["ms"] * c / total, 4)
                for sec, c in zip(chol.CLUSTER_SECTIONS, mean)}
        print(json.dumps({"shape": spec, "device": torch.cuda.get_device_name(
            0), "plans": rows, "split_ms": split}), flush=True)


if __name__ == "__main__":
    main()
