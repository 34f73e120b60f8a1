#!/usr/bin/env python
"""Where an iteration of the stage-sharded loop spends its time on the
card: `torch.profiler` over a few iterations of solve_mpc_stage_sharded
on mpc_chain_stage_data(40, 256) (nb 119, S 256; chip_smoke.py phase
18 (c)'s problem), one table sorted by device time and one by host time
for each mesh size, and the wall of the profiled run.

    python tools/stage_profile.py [--mesh 8 1] [--iters 8] [--qr]

--qr swaps the interface's LU solves (parallel/block_tridiag.py `_solve`)
for the reference's QR solve (torch.linalg.qr, then solve_triangular),
the port's first version, to set the two side by side.
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from qpalm_tpu_torch import Settings, _build  # noqa: E402
from qpalm_tpu_torch.parallel import LocalMesh  # noqa: E402
from qpalm_tpu_torch.parallel import block_tridiag  # noqa: E402
from qpalm_tpu_torch.parallel.mpc_loop import (  # noqa: E402
    mpc_chain_stage_data, solve_mpc_stage_sharded)


def _qr_solve(B, X):
    Qf, Rf = torch.linalg.qr(B)
    return torch.linalg.solve_triangular(Rf, Qf.transpose(-1, -2) @ X,
                                         upper=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", type=int, nargs="+", default=[8, 1])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--qr", action="store_true")
    args = ap.parse_args()
    if args.qr:
        block_tridiag._solve = _qr_solve
    _build.build()
    _build.kernels()
    data = mpc_chain_stage_data(40, 256, seed=0)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, scaling=2)
    for nd in args.mesh:
        mesh = LocalMesh(nd, device="cuda")
        solve_mpc_stage_sharded(data, s.replace(max_iter=2), mesh)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve_mpc_stage_sharded(data, s.replace(max_iter=args.iters),
                                    mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"LocalMesh({nd}){' QR' if args.qr else ''}: {args.iters} "
              f"iterations {wall:.3f} s")
        for key in ("cuda_time_total", "cpu_time_total"):
            print(prof.key_averages().table(sort_by=key, row_limit=20,
                                            max_name_column_width=50))


if __name__ == "__main__":
    main()
