"""The control of `correct`: a cell run with the program's lower-precision
path switched on in place of what the configuration states (each driver's
`use_control`), which has to come out as not correct.

    python3 portbench/control.py --workload <cell> --seconds <s>
                                 --seed <n> [<n> ...]

prints one JSON line a seed: the numbers compared, their limits and
`correct`.  The benchmark's own runs never run it; it needs the card,
as they do."""

import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import argparse  # noqa: E402
import json  # noqa: E402

from portbench import harness  # noqa: E402


def run_control(cell, seed, seconds, device="cuda"):
    """harness.run with the driver's control switched on after set-up."""
    setup = cell.driver.setup

    def setup_with_control(*args):
        st = setup(*args)
        cell.driver.use_control(st)
        return st

    cell.driver.setup = setup_with_control
    try:
        return harness.run(cell, seed, seconds, False, device)
    finally:
        cell.driver.setup = setup


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)
    harness.check_card(int(cell.entry["chips"]))
    for seed in args.seed:
        t0 = time.perf_counter()
        r = run_control(cell, seed, args.seconds)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              control=True, correct=r["correct"],
                              attempted=r["attempted"], failed=r["failed"],
                              checks=r["checks"],
                              seconds=time.perf_counter() - t0)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
