"""Build and load the port's CUDA kernels.

`kernels()` compiles every csrc/*.cu source of this package with nvcc, one
nvcc per source, all started together, and links them into one shared
library with a plain C interface, for Hopper (sm_90a), which it loads with
ctypes.  The library goes to qpalm_tpu_torch/_build/, named by a hash of
the sources, so an edited source builds anew and an unchanged one is built
once.  Nothing is built or loaded at import.

Each C entry point launches on the stream it is given, allocates nothing,
synchronises nothing, and returns cudaGetLastError(); `check_launch` turns
a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# --fmad=false: no contraction of a*b+c into one rounding, so the kernels
# round as their plain PyTorch twins do (fmaf() calls stay fused)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argument types (pointers and the stream as void*)
_SIGNATURES = {
    "qp_chol": [_P, _P, _I, _I, _P],
    "qp_chol_solve": [_P, _P, _P, _I, _I, _I, _I, _P],
    "qp_fused_palm": [_P] * 8 + [_P] * 6 + [_I] * 11 + [_P],
    "qp_fused_smem_bytes": [_I, _I],
    "qp_fused_stream_smem_bytes": [_I, _I],
    "qp_fused_stream_plan": [_I, _I, _P],
    "qp_scratch_probe": [_P, _P, _P, _I, _I, _P],
    "qp_assembly_probe": [_P, _P, _P, _P, _I, _I, _I, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return str(path)


def _library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libqpalm_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the kernels unless the library for these sources exists.
    Returns (library path, nvcc's diagnostics; with `verbose` this holds
    ptxas' register and shared-memory report)."""
    out = _library_path()
    if out.exists() and not verbose:
        return out, ""
    cu, _ = _sources()
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    nvcc = _nvcc()
    jobs = []
    for src, obj in zip(cu, objs):
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    try:
        for cmd, proc in jobs:
            text = proc.communicate()[0]
            log.append(text)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{text}")
        tmp = BUILD_DIR / f"{tag}.tmp"
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out, "".join(log)


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
