"""Time K1's streaming kernel in one or more copies of the port, on the card.

    python tools/stream_ab.py [DIR ...]

Each DIR holds a `qpalm_tpu_torch` package (default: this checkout's).
Each copy is built and timed in a process of its own, in the order given,
so two versions compare within one run on one card (A B B A): randomQP
n=352, B=128, the workloads sweep's settings, 30 iterations from the same
state, the mean of 3 launches after a warm-up by CUDA events, and the
split of one launch by the kernel's cycle counters
(`fused.profile_split`).  One JSON line per copy.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
T = 30

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from qpalm_tpu_torch import sweep
from qpalm_tpu_torch.batch import stack_problems
from qpalm_tpu_torch.solver import fused as F

T = int(sys.argv[2])
s = sweep.S32
data = stack_problems(sweep.row_problems("randomQP", 352), np.float32,
                      device="cuda")
sd, scal, st = F._prepare(data, s)
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
prof = F.fused_palm.profile[0]
if hasattr(F, "profile_split"):
    split = F.profile_split(prof, ms)
else:  # a copy from before the six sections
    tot = prof.double().sum(0).cpu()
    names = ("assembly", "gershgorin_q", "cholesky", "solves")
    split = {k: float(ms * tot[i] / tot[-1]) for i, k in enumerate(names)}
    split["rest"] = ms - sum(split.values())
print(json.dumps({"dir": sys.argv[1], "device": torch.cuda.get_device_name(0),
                  "ms": ms, "iterations": int(out.sc[:, F._ITER].sum()),
                  "split_ms": split}))
"""


def main(argv=None):
    dirs = (argv if argv is not None else sys.argv[1:]) or [str(ROOT)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    for d in dirs:
        proc = subprocess.run([sys.executable, "-c", CHILD,
                               str(Path(d).resolve()), str(T)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{d}: exit {proc.returncode}\n{proc.stderr}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
