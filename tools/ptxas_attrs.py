"""ptxas' registers and spills of the f64 warp solve (csrc/chol.cu,
chol_solve_warp_kernel) under other attributes, on a machine with nvcc.

    python tools/ptxas_attrs.py [ATTRIBUTE ...]

Each ATTRIBUTE (default: the kernel's own, and __launch_bounds__ without
its blocks an SM, `__launch_bounds__(32 * WARP_W_MAX)`) replaces the
kernel's in a copy of csrc/ under tree_check/ptxas_attrs/ (gitignored);
the copies compile in parallel with the build's flags and `-Xptxas -v`,
and each instantiation's registers and spills print, one line each."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from qpalm_tpu_torch import _build  # noqa: E402

SRC = ROOT / "qpalm_tpu_torch" / "csrc"
OUT = ROOT / "tree_check" / "ptxas_attrs"
OWN = "__launch_bounds__(32 * WARP_W_MAX, 1)"


def main(argv=None):
    attrs = (argv if argv is not None else sys.argv[1:]) \
        or [OWN, "__launch_bounds__(32 * WARP_W_MAX)"]
    text = (SRC / "chol.cu").read_text()
    own = f"{OWN}\nchol_solve_warp_kernel"
    assert own in text
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = []
    for i, attr in enumerate(attrs):
        d = OUT / str(i)
        d.mkdir(parents=True)
        for f in SRC.glob("*.cuh"):
            shutil.copy(f, d / f.name)
        (d / "chol.cu").write_text(
            text.replace(own, f"{attr}\nchol_solve_warp_kernel"))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
               "-o", str(d / "chol.o"), str(d / "chol.cu")]
        jobs.append((attr, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    for attr, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{attr}: nvcc exit {proc.returncode}\n{log}")
        e = None
        for line in log.splitlines():
            if "Compiling entry" in line:
                hit = re.search(r"chol_solve_warp_kernelIdLi(\d)E", line)
                e = hit[1] if hit else None
            elif e and "spill stores" in line:
                spill = line.split(":")[-1].strip()
            elif e and "Used" in line:
                regs = re.search(r"Used (\d+) registers", line)[1]
                print(f"{attr}: E = {e}, {regs} registers, {spill}",
                      flush=True)
                e = None


if __name__ == "__main__":
    main()
