"""ctypes binding to the native C/LAPACK baseline solvers
(native/qpalm_baseline.cpp and qpalm_sparse_baseline.cpp), the port's copy
of qpalm_tpu/baseline_c.py.

The baseline is a single-threaded dense float64 P-ALM + semismooth-Newton
solver over LAPACK dpotrf/dpotrs and BLAS dgemv/dsymv/dsyrk, with the
iteration semantics and stopping protocol of the reference C solver
(reference: src/qpalm.c:401-736).  The bench uses it twice: as the divisor
of its headline (`bench.measure_baseline`) and as the first step of the
host rescue (`bench.rescue_round`).  `solve_sparse` is the native sparse
engine that `host_sparse.solve_sparse_auto` takes for light-fill patterns.

The library is built from the repository's own source by
`_build.build_baseline` at first use, into qpalm_tpu_torch/_build/, linking
the system's LAPACK where the host has it and scipy's bundled OpenBLAS
where it does not.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from . import _build

_DP = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_IP = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


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
    lib.qpalm_sparse_baseline_solve.restype = ctypes.c_int
    lib.qpalm_sparse_baseline_solve.argtypes = [
        ctypes.c_int, ctypes.c_int,          # n, m
        _IP, _IP, _DP, ctypes.c_int,         # Qp, Qi, Qx, Qnnz
        _IP, _IP, _DP, ctypes.c_int,         # Ap, Ai, Ax, Annz
        _DP, _DP, _DP,                       # q, bmin, bmax
        ctypes.c_double, ctypes.c_double,    # eps_abs, eps_rel
        ctypes.c_int, ctypes.c_int,          # max_iter, scaling
        ctypes.c_double,                     # delta
        ctypes.c_int, ctypes.c_double,       # flags, time_limit
        _DP, _DP,                            # x_out, y_out
        ctypes.POINTER(ctypes.c_int),        # iter_out
        ctypes.POINTER(ctypes.c_double),     # obj_out
        _DP, _DP,                            # dy_out, dx_out (certs)
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


def solve_sparse(Q, A, q, bmin, bmax, eps_abs=1e-6, eps_rel=1e-6,
                 max_iter=50000, scaling=10, delta=100.0, rescue=False,
                 time_limit=0.0, rescue_window=0):
    """Solve one sparse QP with the native single-threaded sparse solver
    (native/qpalm_sparse_baseline.cpp): reference C-QPALM semantics over a
    sparse LDL' with AMD ordering, Schur form.  `Q`, `A` are scipy sparse
    (any format); returns dict(status, x, y, iter, objective, delta_y,
    delta_x).  `rescue=True` enables the stagnation rescue that
    host_sparse.solve_sparse_direct also runs; `time_limit` (s): status -3
    when hit."""
    import scipy.sparse as sp

    lib = load_library()
    if lib is None:
        raise RuntimeError("native baseline library unavailable: "
                           + unavailable_reason())
    Q = sp.csc_matrix(Q)
    A = sp.csc_matrix(A)
    Q.sort_indices()
    A.sort_indices()
    n = Q.shape[0]
    m = A.shape[0]
    q = np.ascontiguousarray(q, np.float64).ravel()
    bmin = np.ascontiguousarray(bmin, np.float64).ravel()
    bmax = np.ascontiguousarray(bmax, np.float64).ravel()
    x = np.zeros(n)
    y = np.zeros(m)
    dy = np.zeros(m)
    dx = np.zeros(n)
    it = ctypes.c_int(0)
    obj = ctypes.c_double(0.0)
    status = lib.qpalm_sparse_baseline_solve(
        n, m,
        np.ascontiguousarray(Q.indptr, np.int32),
        np.ascontiguousarray(Q.indices, np.int32),
        np.ascontiguousarray(Q.data, np.float64), int(Q.nnz),
        np.ascontiguousarray(A.indptr, np.int32),
        np.ascontiguousarray(A.indices, np.int32),
        np.ascontiguousarray(A.data, np.float64), int(A.nnz),
        q, bmin, bmax, float(eps_abs), float(eps_rel),
        int(max_iter), int(scaling), float(delta),
        int(bool(rescue)) | (int(rescue_window) & 0x7F) << 1,
        float(time_limit),
        x, y, ctypes.byref(it), ctypes.byref(obj), dy, dx,
    )
    status = int(status)
    return {
        "status": status, "x": x, "y": y,
        "iter": int(it.value), "objective": float(obj.value),
        "delta_y": dy if status == -3 else None,
        "delta_x": dx if status == -4 else None,
    }
