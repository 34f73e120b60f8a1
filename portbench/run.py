"""The port's benchmark, one cell a run:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the JSON result; the numbers
compared for `correct` are the last lines of standard error.  See
portbench/README.md."""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One BLAS thread: the host's BLAS work is the rescue's LAPACK on systems
# of a few hundred rows, which threads do not speed up, and idle BLAS
# threads spin against the main thread's stacking (PERF.md, section 2).
os.environ["OPENBLAS_NUM_THREADS"] = "1"
os.environ["OMP_NUM_THREADS"] = "1"

# the checkout's root, so that the program and this package import from it
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_process=T_PROCESS))
