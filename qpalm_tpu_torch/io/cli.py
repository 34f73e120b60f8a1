"""Command-line QPS driver (the port's copy of qpalm_tpu/io/cli.py), the
equivalent of the reference `qpalm_qps` executable (reference:
interfaces/qps/src/qpalm_qps.c:694-806):

    python -m qpalm_tpu_torch.io.cli [--device cuda|cpu] problem.qps [settings.txt]
    python -m qpalm_tpu_torch.io.cli [--device cuda|cpu] --mtx A Q q bmin bmax [settings.txt]

Prints the problem name, iterations, status, objective and runtime.  The
solve runs on `--device` (default cuda; cpu runs the kernels' plain
twins); a large sparse problem goes through `api.solve`'s route to the
host sparse solvers, whose CG fallback runs on the same device.
"""

from __future__ import annotations

import sys

USAGE = ("Usage: python -m qpalm_tpu_torch.io.cli [--device cuda|cpu] "
         "problem.qps [settings.txt]\n"
         "       python -m qpalm_tpu_torch.io.cli [--device cuda|cpu] "
         "--mtx A Q q bmin bmax [settings.txt]")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i: i + 2]
    if not argv:
        print(USAGE, file=sys.stderr)
        return 1

    from .mtx import load_mtx
    from .qps import load_qps
    from .settings_io import read_settings_file

    settings_path = None
    if argv[0] == "--mtx":
        if len(argv) < 6:
            print("--mtx needs 5 files: A Q q bmin bmax", file=sys.stderr)
            return 1
        prob = load_mtx(*argv[1:6])
        if len(argv) > 6:
            settings_path = argv[6]
    else:
        prob = load_qps(argv[0])
        if len(argv) > 1:
            settings_path = argv[1]
    print(f"Reading problem {prob.name or argv[0]}")
    print(f"n = {prob.n}, m = {prob.m}")

    from ..api import solve
    from ..types import Settings

    settings = Settings()
    if settings_path is not None:
        settings = read_settings_file(settings_path, settings)

    res = solve(prob.Q, prob.A, prob.q, prob.bmin, prob.bmax, c=prob.c,
                settings=settings, device=device)
    print(f"Iter: {int(res.info.iter)}")
    print(f"Status: {res.info.status}")
    print(f"Objective: {float(res.info.objective):.6e}")
    print(f"Runtime: {res.info.run_time:.6f} seconds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
