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

`build_baseline()`, `build_ldl()` and `build_io()` compile the native C++
libraries of native/ (native/Makefile's sources and flags) with g++ into
the same directory: the C/LAPACK baseline solvers (the bench's divisor,
the headline's rescue and `solve_sparse_auto`'s native engine,
baseline_c.py), the sparse LDL' backend (linalg/sparse_direct.py) and the
QPS reader (io/native.py).  Each links the first BLAS/LAPACK of
`blas_routes()` that builds and loads.

Spans and counters (trace.py): "build", one library's hash, compiles and
load; "build.compile", one compiler step (the nvcc runs of the sources,
which run together, their link, or one g++ run); `build.compiles`, the
compiler processes run; `build.compile_failures`, those that failed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.util
import os
import shutil
import subprocess
from pathlib import Path

from . import trace

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
    "qp_chol": [_P, _P, _I, _I, _I, _P],
    "qp_chol_solve": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "qp_chol_global": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    "qp_chol_grid": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    "qp_chol_solve_global": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "qp_chol_solve_stripe": [_P, _P, _P, _I, _I, _I, _I, _P, _I, _P],
    "qp_fused_palm": [_P] * 8 + [_P] * 6 + [_I] * 11 + [_P],
    "qp_fused_smem_bytes": [_I, _I],
    "qp_fused_stream_smem_bytes": [_I, _I],
    "qp_fused_stream_plan": [_I, _I, _P],
    "qp_scratch_probe": [_P, _P, _I, _I, _P],
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
    log = []
    try:
        with trace.span("build.compile"):
            for src, obj in zip(cu, objs):
                cmd = [nvcc, *NVCC_FLAGS,
                       *(["-Xptxas", "-v"] if verbose else []),
                       "-c", "-o", str(obj), str(src)]
                jobs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            trace.count("build.compiles", len(jobs))
            for cmd, proc in jobs:
                text = proc.communicate()[0]
                log.append(text)
                if proc.returncode != 0:
                    trace.count("build.compile_failures")
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                       f"{' '.join(cmd)}\n{text}")
        tmp = BUILD_DIR / f"{tag}.tmp"
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        with trace.span("build.compile"):
            trace.count("build.compiles")
            proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            trace.count("build.compile_failures")
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
    with trace.span("build"):
        lib = ctypes.CDLL(str(build()[0]))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


NATIVE = _PKG.parent / "native"
# native/Makefile's sources and flags for each library it builds
BASELINE_SRCS = ("qpalm_baseline.cpp", "qpalm_sparse_baseline.cpp",
                 "sparse_ldl.cpp", "amd_order.cpp")
LDL_SRCS = ("sparse_ldl.cpp", "sparse_ldl_sn.cpp", "amd_order.cpp",
            "batch_kkt.cpp")
IO_SRCS = ("qps_reader.cpp",)
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-O3",
             "-shared"]
IO_CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
# the BLAS and LAPACK routines qpalm_baseline.cpp calls, and those of the
# sparse LDL' library (sparse_ldl_sn.cpp's panels, batch_kkt.cpp's
# Bunch-Kaufman)
BLAS_ROUTINES = ("dgemv_", "dsymv_", "dsyrk_", "dpotrf_", "dpotrs_")
LDL_ROUTINES = ("dgemm_", "dgemv_", "dtrsv_", "daxpy_", "dsytrf_",
                "dsytrs_", "ssytrf_", "ssytrs_")


def _scipy_openblas() -> Path | None:
    """The OpenBLAS that scipy's wheel bundles (scipy.libs/), if any."""
    spec = importlib.util.find_spec("scipy")
    if spec is None or spec.origin is None:
        return None
    found = sorted((Path(spec.origin).parent.parent / "scipy.libs")
                   .glob("libscipy_openblas*.so"))
    return found[0] if found else None


def blas_routes(routines=BLAS_ROUTINES) -> list[tuple[str, list[str]]]:
    """(name, g++ link arguments) of each way to link BLAS and LAPACK, in
    the order the builds try them: the system's liblapack.so.3 and
    libblas.so.3 (native/Makefile's link line), then scipy's bundled
    OpenBLAS, which exports `routines` under a `scipy_` prefix."""
    routes = [("system liblapack.so.3 + libblas.so.3",
               ["-l:liblapack.so.3", "-l:libblas.so.3"])]
    ob = _scipy_openblas()
    if ob is not None:
        routes.append((f"scipy's bundled OpenBLAS ({ob.name})",
                       [*(f"-D{r}=scipy_{r}" for r in routines),
                        str(ob), f"-Wl,-rpath,{ob.parent}"]))
    return routes


def build_native(stem: str, sources, flags, routes) -> tuple[ctypes.CDLL,
                                                               str]:
    """Compile native/`sources` with g++ into _build/`stem`_<hash>.so
    unless the library for these sources, flags and route exists, and load
    it, trying `routes` ((name, link arguments), see `blas_routes`) in
    order: a route counts when its library builds and loads (a host may
    link against a LAPACK that its loader cannot find).  Returns (the
    loaded library, the route's name); raises RuntimeError with every
    route's error when none does."""
    with trace.span("build"):
        return _build_native(stem, sources, flags, routes)


def _build_native(stem, sources, flags, routes):
    """`build_native`'s work, a span "build.compile" a g++ run."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    paths = [NATIVE / s for s in sources]
    errors = []
    for name, link in routes:
        h = hashlib.sha256()
        for f in paths + sorted(NATIVE.glob("*.h")):
            h.update(f.read_bytes())
        h.update(" ".join(flags + link).encode())
        out = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
            cmd = [cxx, *flags, "-o", str(tmp), *map(str, paths), *link]
            with trace.span("build.compile"):
                trace.count("build.compiles")
                proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                trace.count("build.compile_failures")
                tmp.unlink(missing_ok=True)
                errors.append(f"{name}: {' '.join(cmd)}\n"
                              f"{proc.stderr.strip()}")
                continue
            os.replace(tmp, out)
        try:
            return ctypes.CDLL(str(out)), name
        except OSError as err:
            errors.append(f"{name}: built, but does not load: {err}")
    raise RuntimeError(f"{stem} does not build and load:\n"
                       + "\n".join(errors))


def build_baseline() -> tuple[ctypes.CDLL, str]:
    """The C/LAPACK baseline solvers, dense and sparse
    (native/qpalm_baseline.cpp, qpalm_sparse_baseline.cpp): (library,
    BLAS route)."""
    return build_native("libqpalm_baseline", BASELINE_SRCS, CXX_FLAGS,
                        blas_routes())


def build_ldl() -> tuple[ctypes.CDLL, str]:
    """The sparse LDL' library (native/sparse_ldl.cpp, sparse_ldl_sn.cpp,
    amd_order.cpp, batch_kkt.cpp): (library, BLAS route)."""
    return build_native("libqpalm_ldl", LDL_SRCS, CXX_FLAGS,
                        [(name, link + ["-ldl"]) for name, link
                         in blas_routes(LDL_ROUTINES)])


def build_io() -> tuple[ctypes.CDLL, str]:
    """The native QPS reader (native/qps_reader.cpp): (library, route)."""
    return build_native("libqpalm_io", IO_SRCS, IO_CXX_FLAGS,
                        [("no BLAS", [])])
