"""A B B A of the host polish's two routes on the card machine's host: the
native batched Bunch-Kaufman (libqpalm_ldl, `polish._bkkt_lib`) against
numpy's batched LU (the route the port took before it had the native one,
and the reference's fallback), on the same f32 solutions.

    python tools/polish_route_ab.py [--large 2048:3072:3] [--rows 320 352]

Inputs, each f32 pass run once on the card:
  * phase 16 (d) of chip_smoke.py: `--large` n:m:count randomQPs (density
    0.15, seeds 0..count-1) through large.solve_large_dense's f32 pass,
    then `polish_batch_np(rounds=3)` as large.py calls it;
  * the workloads sweep's randomQP rows (`--rows`, B = 128): the sweep's
    f32 pass, then its first polish (rounds=1, refine_steps=0) and the
    retry polish (rounds=3) of the lanes it rejects.
Each polish is timed by the host clock on both routes in the order native,
LU, LU, native, and the two routes' certified lanes compared.  Prints one
line a run and one JSON line of medians; names the card and its power
limit.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _timed_polish(route, fn):
    from qpalm_tpu_torch import polish

    saved = polish._bkkt_lib
    if route == "LU":
        polish._bkkt_lib = lambda: None
    try:
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    finally:
        polish._bkkt_lib = saved


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--large", default="2048:3072:3")
    ap.add_argument("--rows", nargs="*", type=int, default=[320, 352])
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal of the tool on the twins")
    args = ap.parse_args(argv)
    import torch

    from qpalm_tpu_torch import polish, sweep
    from qpalm_tpu_torch.batch import solve_batch, stack_problems
    from qpalm_tpu_torch.types import QPData, Settings
    from qpalm_tpu_torch.workloads import random_qp

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool measures on the card")
    if polish._bkkt_lib() is None:
        raise SystemExit("the native library does not load")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip() \
        if dev.type == "cuda" else "cpu"
    print(f"[card] {smi}", flush=True)
    cases = {}
    n, m, count = (int(v) for v in args.large.split(":"))
    probs = [random_qp(n, m, density=0.15, seed=s) for s in range(count)]
    s32 = Settings(dtype="float32", eps_abs=1e-4, eps_rel=1e-4,
                   max_iter=2000, scaling=10, max_refine=2, delta=10.0,
                   verbose=False)  # large.py's f32 pass
    res = solve_batch(probs, s32, device=dev)
    d64 = QPData(*(a.numpy() for a in stack_problems(probs, np.float64)))
    x32, y32 = res.x.cpu().numpy(), res.y.cpu().numpy()
    cases[f"large n={n} m={m} x{count}, rounds=3"] = lambda d=d64, x=x32, \
        y=y32: polish.polish_batch_np(d, x, y, eps_abs=1e-6, eps_rel=1e-6,
                                      rounds=3)
    for size in args.rows:
        rp = sweep.row_problems("randomQP", size, 128)
        res = solve_batch(rp, sweep.S32, device=dev)
        d = QPData(*(a.numpy() for a in stack_problems(rp, np.float64)))
        x, y = res.x.cpu().numpy(), res.y.cpu().numpy()

        def row(d=d, x=x, y=y):
            p1 = polish.polish_batch_np(d, x, y, eps_abs=1e-6, eps_rel=1e-6,
                                        rounds=1, refine_steps=0)
            bad = np.flatnonzero(~p1.ok)
            ok = p1.ok.copy()
            if len(bad):
                p2 = polish.polish_batch_np(
                    QPData(*(a[bad] for a in d)), x[bad], y[bad],
                    eps_abs=1e-6, eps_rel=1e-6, rounds=3)
                ok[bad] = p2.ok
            return ok
        cases[f"sweep randomQP n={size} B=128, polish + retry polish"] = row

    out = {}
    for label, fn in cases.items():
        times = {"native BK": [], "LU": []}
        oks = {}
        for route in ("native BK", "LU", "LU", "native BK"):
            r, dt = _timed_polish(route, fn)
            ok = r.ok if hasattr(r, "ok") else r
            times[route].append(dt)
            oks.setdefault(route, np.asarray(ok).copy())
            print(f"[{label}] {route}: {dt:.3f} s, ok {int(np.sum(ok))}"
                  f"/{len(ok)}", flush=True)
        med = {k: statistics.median(v) for k, v in times.items()}
        out[label] = dict(native_s=times["native BK"], lu_s=times["LU"],
                          speedup=med["LU"] / med["native BK"],
                          same_ok=bool(np.array_equal(oks["native BK"],
                                                      oks["LU"])))
        print(f"[{label}] median native {med['native BK']:.3f} s, LU "
              f"{med['LU']:.3f} s: {out[label]['speedup']:.2f}x; the same "
              f"lanes certified: {out[label]['same_ok']}", flush=True)
    print(json.dumps({"card": smi, "cases": out}))


if __name__ == "__main__":
    main()
