"""MatrixMarket-style problem loader (the port's copy of
qpalm_tpu/io/mtx.py).

Mirrors the reference MTX driver (reference: interfaces/mtx/qpalm_mtx.c:12-130,
invocation run_mtx.sh:3): five files — A, Q, q, bmin, bmax — where matrices
are 1-indexed `row col value` triplet files with a size header line, and
vectors are `value` per line after the header.  Values beyond +-QPALM_INFTY
are clipped (qpalm_mtx.c:52-57).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .qps import QPS_INFTY, QPProblem


def _load_mtx_matrix(path: str,
                     symmetric_default: bool = False) -> sp.csc_matrix:
    """Triplet loader.  Off-diagonals are mirrored ONLY when the banner
    declares `symmetric` (one-triangle storage) — a `general` file that
    stores both triangles must not be mirrored or scipy's duplicate
    summing doubles every off-diagonal.  `symmetric_default` applies when
    the banner is absent/unrecognized (the reference's Q convention).
    Standard MatrixMarket '%' comment lines are skipped."""
    with open(path) as f:
        header = f.readline()
        hl = header.lower()
        if "general" in hl:
            mirror = False
        elif "symmetric" in hl:
            mirror = True
        else:
            mirror = symmetric_default
        # skip comment lines before the size line (SuiteSparse exports
        # put a '%'-comment block after the banner)
        line = f.readline()
        while line and line.lstrip().startswith("%"):
            line = f.readline()
        nrow, ncol, nnz = (int(t) for t in line.split()[:3])
        rows, cols, vals = [], [], []
        for line in f:
            toks = line.split()
            if not toks or toks[0].startswith("%"):
                continue
            r, c = int(toks[0]) - 1, int(toks[1]) - 1
            v = max(min(float(toks[2]), QPS_INFTY), -QPS_INFTY)
            rows.append(r)
            cols.append(c)
            vals.append(v)
            if mirror and r != c:
                rows.append(c)
                cols.append(r)
                vals.append(v)
    return sp.csc_matrix(
        (np.asarray(vals), (np.asarray(rows), np.asarray(cols))),
        shape=(nrow, ncol),
    )


def _load_mtx_vector(path: str) -> np.ndarray:
    with open(path) as f:
        f.readline()  # banner
        line = f.readline()
        while line and line.lstrip().startswith("%"):
            line = f.readline()
        size = int(line.split()[0])
        vals = []
        for line in f:
            toks = line.split()
            if toks and not toks[0].startswith("%"):
                v = float(toks[-1])
                vals.append(max(min(v, QPS_INFTY), -QPS_INFTY))
    out = np.asarray(vals)
    if out.shape[0] != size:
        raise ValueError(f"{path}: expected {size} entries, got {out.shape[0]}")
    return out


def load_mtx(a_file, q_file, g_file, bmin_file, bmax_file) -> QPProblem:
    """Load a QP from five MatrixMarket-ish files (A, Q, q, bmin, bmax) —
    the argument order of the reference CLI (run_mtx.sh:3)."""
    A = _load_mtx_matrix(a_file)
    Q = _load_mtx_matrix(q_file, symmetric_default=True)
    q = _load_mtx_vector(g_file)
    bmin = _load_mtx_vector(bmin_file)
    bmax = _load_mtx_vector(bmax_file)
    return QPProblem(name="mtx", Q=Q, A=A, q=q, bmin=bmin, bmax=bmax)
