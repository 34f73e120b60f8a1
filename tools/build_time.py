#!/usr/bin/env python
"""Wall time of the port's kernel build two ways, on a machine with nvcc:
qpalm_tpu_torch._build.build() (one nvcc per source, all started together,
then a link) and one `nvcc -shared` call over every source with the same
flags.  Each build goes to a fresh directory under qpalm_tpu_torch/_build/,
so nothing is cached; the two ways alternate, twice each.

    python tools/build_time.py      prints one JSON line
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from qpalm_tpu_torch import _build  # noqa: E402


def main():
    cu, _ = _build._sources()
    times = dict(one_call_s=[], parallel_s=[])
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for k in range(2):
            t0 = time.perf_counter()
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                            "-o", str(Path(tmp) / f"one{k}.so"),
                            *map(str, cu)], check=True, capture_output=True)
            times["one_call_s"].append(time.perf_counter() - t0)
            _build.BUILD_DIR = Path(tmp) / f"parallel{k}"
            t0 = time.perf_counter()
            _build.build()
            times["parallel_s"].append(time.perf_counter() - t0)
    print(json.dumps(dict(sources=len(cu), **times)))


if __name__ == "__main__":
    main()
