#!/usr/bin/env python
"""How far a solve at the default Settings() (f64, eps_abs = eps_rel =
1e-4, max_refine 3) sits from the headline problems' solutions, in the
JAX package and in the PyTorch port, on the CPU.

The headline problems (workloads.make_problems(B, 64, 96, seed=7)) go
through each package's general loop at Settings(), at eps 1e-6 and at
eps 1e-10; the reference's eps-1e-10 solve stands for the solutions.
Prints, for each solve, the lanes solved and max|x - x_tight|, and how far
the port's x sits from the reference's at the same settings.  This is the
yardstick of chip_smoke.py phase 14's bars on x.

    python tools/default_gap.py [B]     (B = 512 by default)
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import qpalm_tpu  # noqa: E402
from qpalm_tpu.batch import solve_batch as jsolve  # noqa: E402
from qpalm_tpu_torch.batch import solve_batch  # noqa: E402
from qpalm_tpu_torch.types import Settings  # noqa: E402
from qpalm_tpu_torch.workloads import make_problems  # noqa: E402


def main():
    nb = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    probs = make_problems(nb, 64, 96, seed=7)
    tight = np.asarray(jsolve(probs, qpalm_tpu.Settings(
        eps_abs=1e-10, eps_rel=1e-10))[0])
    for eps in (1e-4, 1e-6):
        kw = {} if eps == 1e-4 else dict(eps_abs=eps, eps_rel=eps)
        ref = jsolve(probs, qpalm_tpu.Settings(**kw))
        port = solve_batch(probs, Settings(**kw), device="cpu")
        xr, xp = np.asarray(ref[0]), port.x.numpy()
        print(f"eps {eps:.0e}: reference solved "
              f"{int((np.asarray(ref[2]) == 1).sum())}/{nb}, max|x - "
              f"x_tight| {np.abs(xr - tight).max():.3e}; port solved "
              f"{int((port.status.numpy() == 1).sum())}/{nb}, max|x - "
              f"x_tight| {np.abs(xp - tight).max():.3e}; max|x_port - "
              f"x_reference| {np.abs(xp - xr).max():.3e}", flush=True)


if __name__ == "__main__":
    main()
