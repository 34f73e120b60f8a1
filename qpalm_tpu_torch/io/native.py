"""ctypes binding to the native C++ QPS reader (native/qps_reader.cpp), the
port's copy of qpalm_tpu/io/native.py.

The reference's data loader is native C (interfaces/qps/src/qpalm_qps.c);
this is its native equivalent, with io/qps.py as the pure-Python fallback
and differential-test oracle.  The shared library is built from the
repository's source by `_build.build_io` at first use, into
qpalm_tpu_torch/_build/ (g++ only, no extra dependencies).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .. import _build

_why = ""


@functools.cache
def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native IO library; None if unavailable
    (`unavailable_reason()` says why)."""
    global _why
    try:
        lib = _build.build_io()[0]
    except RuntimeError as err:
        _why = str(err)
        return None
    lib.qps_parse.restype = ctypes.c_void_p
    lib.qps_parse.argtypes = [ctypes.c_char_p]
    lib.qps_error.restype = ctypes.c_char_p
    lib.qps_error.argtypes = [ctypes.c_void_p]
    lib.qps_get_name.restype = ctypes.c_char_p
    lib.qps_get_name.argtypes = [ctypes.c_void_p]
    lib.qps_sizes.restype = None
    lib.qps_sizes.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_int64)
    ] * 4
    lib.qps_constant.restype = ctypes.c_double
    lib.qps_constant.argtypes = [ctypes.c_void_p]
    lib.qps_fill.restype = None
    lib.qps_fill.argtypes = [ctypes.c_void_p] + [
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    lib.qps_free.restype = None
    lib.qps_free.argtypes = [ctypes.c_void_p]
    return lib


def unavailable_reason() -> str:
    return _why


def load_qps_native(path: str):
    """Parse a QPS file with the native reader; returns a QPProblem or raises
    if the native library is unavailable or the parse fails."""
    from .qps import QPProblem

    lib = load_library()
    if lib is None:
        raise RuntimeError("native QPS reader unavailable: " + _why)
    handle = lib.qps_parse(path.encode())
    try:
        err = lib.qps_error(handle)
        if err:
            raise ValueError(f"QPS parse error: {err.decode()}")
        n = ctypes.c_int64()
        m = ctypes.c_int64()
        annz = ctypes.c_int64()
        qnnz = ctypes.c_int64()
        lib.qps_sizes(
            handle, ctypes.byref(n), ctypes.byref(m),
            ctypes.byref(annz), ctypes.byref(qnnz),
        )
        Ar = np.empty(annz.value, np.int64)
        Ac = np.empty(annz.value, np.int64)
        Av = np.empty(annz.value, np.float64)
        Qr = np.empty(qnnz.value, np.int64)
        Qc = np.empty(qnnz.value, np.int64)
        Qv = np.empty(qnnz.value, np.float64)
        q = np.empty(n.value, np.float64)
        bmin = np.empty(m.value, np.float64)
        bmax = np.empty(m.value, np.float64)
        lib.qps_fill(handle, Ar, Ac, Av, Qr, Qc, Qv, q, bmin, bmax)
        name = lib.qps_get_name(handle).decode()
        c = lib.qps_constant(handle)
    finally:
        lib.qps_free(handle)

    A = sp.csc_matrix((Av, (Ar, Ac)), shape=(m.value, n.value))
    Q = sp.csc_matrix((Qv, (Qr, Qc)), shape=(n.value, n.value))
    return QPProblem(name=name, Q=Q, A=A, q=q, bmin=bmin, bmax=bmax, c=c)
