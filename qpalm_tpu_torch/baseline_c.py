"""ctypes binding to the native C/LAPACK baseline solver
(native/qpalm_baseline.cpp), the port's copy of `load_library` and `solve`
of qpalm_tpu/baseline_c.py:33-112.

The baseline is a single-threaded dense float64 P-ALM + semismooth-Newton
solver over LAPACK dpotrf/dpotrs and BLAS dgemv/dsymv/dsyrk, with the
iteration semantics and stopping protocol of the reference C solver
(reference: src/qpalm.c:401-736).  The bench uses it twice: as the divisor
of its headline (`bench.measure_baseline`) and as the first step of the
host rescue (`bench.rescue_round`).

The library is built from the repository's own source by
`_build.build_baseline` at first use, into qpalm_tpu_torch/_build/, linking
the system's LAPACK where the host has it and scipy's bundled OpenBLAS
where it does not.  `solve_sparse` (the sparse comparator) is not copied.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from . import _build

_DP = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


@functools.cache
def _load() -> tuple[Optional[ctypes.CDLL], str, str]:
    """(library or None, the BLAS route it links, why it is missing)."""
    try:
        lib, route = _build.build_baseline()
    except RuntimeError as err:
        return None, "", str(err)
    lib.qpalm_baseline_solve.restype = ctypes.c_int
    lib.qpalm_baseline_solve.argtypes = [
        ctypes.c_int, ctypes.c_int,          # n, m
        _DP, _DP, _DP, _DP, _DP,             # Q, A, q, bmin, bmax
        ctypes.c_double, ctypes.c_double,    # eps_abs, eps_rel
        ctypes.c_int, ctypes.c_int,          # max_iter, scaling
        ctypes.c_double,                     # delta
        _DP, _DP,                            # x_out, y_out
        ctypes.POINTER(ctypes.c_int),        # iter_out
        ctypes.POINTER(ctypes.c_double),     # obj_out
    ]
    return lib, route, ""


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the baseline library; None if unavailable
    (`unavailable_reason()` says why)."""
    return _load()[0]


def linked_blas() -> str:
    """The BLAS/LAPACK the loaded library links ("" when it is missing)."""
    return _load()[1]


def unavailable_reason() -> str:
    return _load()[2]


def solve(Q, A, q, bmin, bmax, eps_abs=1e-6, eps_rel=1e-6,
          max_iter=10000, scaling=10, delta=100.0):
    """Solve one dense QP with the native baseline.

    Returns dict(status, x, y, iter, objective).  Raises RuntimeError if the
    native library cannot be built or loaded."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native baseline library unavailable: "
                           + unavailable_reason())
    Q = np.ascontiguousarray(Q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    bmin = np.ascontiguousarray(bmin, np.float64)
    bmax = np.ascontiguousarray(bmax, np.float64)
    m, n = A.shape
    x = np.zeros(n)
    y = np.zeros(m)
    it = ctypes.c_int(0)
    obj = ctypes.c_double(0.0)
    status = lib.qpalm_baseline_solve(
        n, m, Q, A, q, bmin, bmax, float(eps_abs), float(eps_rel),
        int(max_iter), int(scaling), float(delta),
        x, y, ctypes.byref(it), ctypes.byref(obj),
    )
    return {
        "status": int(status), "x": x, "y": y,
        "iter": int(it.value), "objective": float(obj.value),
    }
