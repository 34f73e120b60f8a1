#!/usr/bin/env python
"""How far K1's two memory tiers, and K1 and the general loop, drift
apart at the headline shape, in the JAX package and in the PyTorch port,
on the CPU.

The on-chip and streaming tiers assemble the Schur matrix in different
orders and so round apart, and the general loop (solver/core.py) rounds
apart from both.  This runs the headline problems
(workloads.make_problems(B, 64, 96, seed=7), bench.py's f32 settings)
through both tiers of the reference kernel (interpret mode) and of the
port's plain twin (bit-identical to the CUDA kernel at this shape), and
through each package's general loop (use_fused="never"), and prints how
many statuses and iteration counts each pair shares.

    python tools/tier_drift.py [B]     (B = 128 by default; 512 takes
                                        several minutes)
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import qpalm_tpu  # noqa: E402
from qpalm_tpu.batch import solve_batch as jgeneral  # noqa: E402
from qpalm_tpu.batch import stack_problems as jstack  # noqa: E402
from qpalm_tpu.solver.fused import solve_batch_fused as jsolve  # noqa: E402
from qpalm_tpu_torch.batch import solve_batch, stack_problems  # noqa: E402
from qpalm_tpu_torch.solver import fused as F  # noqa: E402
from qpalm_tpu_torch.types import Settings  # noqa: E402
from qpalm_tpu_torch.workloads import make_problems  # noqa: E402

S32 = dict(dtype="float32", eps_abs=5e-5, eps_rel=5e-5, max_iter=96,
           scaling=2, max_refine=0, delta=10.0)  # bench.py:194-197


def main():
    nb = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    probs = make_problems(nb, 64, 96, seed=7)
    out = {}
    for panel in (0, 8):
        out[f"port qa_panel={panel}"] = [a.numpy() for a in F.solve_batch_fused(
            stack_problems(probs, np.float32), Settings(**S32),
            qa_panel=panel)]
        out[f"reference qa_panel={panel}"] = [np.asarray(a) for a in jsolve(
            jstack(probs, np.float32), qpalm_tpu.Settings(**S32),
            interpret=True, qa_panel=panel)]
    # on the CPU the reference's solve_batch runs its general loop
    never = dict(S32, use_fused="never")
    out["reference general"] = [np.asarray(a) for a in jgeneral(
        probs, qpalm_tpu.Settings(**never))]
    out["port general"] = [a.numpy() for a in solve_batch(
        probs, Settings(**never), device="cpu")]
    for a, b in (("reference qa_panel=0", "reference qa_panel=8"),
                 ("port qa_panel=0", "port qa_panel=8"),
                 ("port qa_panel=0", "reference qa_panel=0"),
                 ("port qa_panel=8", "reference qa_panel=8"),
                 ("reference qa_panel=0", "reference general"),
                 ("port qa_panel=0", "port general"),
                 ("port general", "reference general")):
        u, v = out[a], out[b]
        print(f"{a} vs {b}: statuses equal {(u[2] == v[2]).sum()}/{nb}, "
              f"iteration counts equal {(u[3] == v[3]).sum()}/{nb}, "
              f"max|dx| {np.abs(u[0] - v[0]).max():.2e}", flush=True)


if __name__ == "__main__":
    main()
