"""QPS/MPS problem reader (the port's copy of
qpalm_tpu/io/qps.py).

A from-scratch Python implementation matching the behavior of the reference's
two-pass C parser (reference: interfaces/qps/src/qpalm_qps.c:71-540):

* ROWS: the `N` row names the objective; `L`/`G`/`E` rows become constraints
  with bounds (-inf, 0], [0, inf), [0, 0] until RHS overrides them
  (qpalm_qps.c:280-296).
* COLUMNS: entries for the objective row fill q; others fill A. Column order
  defines variable indices.
* Variable bounds are folded into A as an appended identity block — one row
  per non-FR variable with default bounds [0, inf) (qpalm_qps.c:145-148,
  298-301); `FR` variables get no row (qpalm_qps.c:179-186).
* RHS: objective-row entry sets the constant term c = -rhs
  (qpalm_qps.c:396-397); otherwise overrides the row bound by its sign.
  Unnamed RHS sections (2/4 tokens) are auto-detected (qpalm_qps.c:152-158).
* RANGES: L rows get bmin = bmax - r, G rows bmax = bmin + r
  (qpalm_qps.c:440-470); E rows follow standard MPS (r >= 0: [rhs, rhs+r],
  r < 0: [rhs+r, rhs]) — a superset of the reference, which ignores E here.
* BOUNDS: UP/LO/FX set the identity-row bounds (qpalm_qps.c:475-507); FR is
  handled in pass 1; MI/PL/BV are accepted as standard MPS extensions
  (superset of the reference).
* QUADOBJ/QMATRIX: lower-triangle entries of Q for the 0.5 x'Qx objective,
  mirrored to the upper triangle.

Returns scipy CSC matrices so large sparse problems survive the parse; the
solver densifies on device transfer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

QPS_INFTY = 1e20


@dataclasses.dataclass
class QPProblem:
    """A parsed QP: minimize 0.5 x'Qx + q'x + c  s.t.  bmin <= Ax <= bmax.

    `A` includes the appended identity block for variable bounds, matching
    the reference's convention (qpalm_qps.c:145-148) and the MATLAB harness
    (`A_combined = [A; speye(n)]`, compare_QP_solvers.m:86-99).
    """

    name: str
    Q: sp.csc_matrix  # (n, n) symmetric
    A: sp.csc_matrix  # (m, n)
    q: np.ndarray  # (n,)
    bmin: np.ndarray  # (m,)
    bmax: np.ndarray  # (m,)
    c: float = 0.0

    @property
    def n(self) -> int:
        return self.Q.shape[0]

    @property
    def m(self) -> int:
        return self.A.shape[0]


def _clip_inf(v: float) -> float:
    return max(min(v, QPS_INFTY), -QPS_INFTY)


class _Sections:
    """Split a QPS file into named sections of data lines."""

    def __init__(self, text: str):
        self.name = ""
        self.order: List[str] = []
        self.lines: Dict[str, List[str]] = {}
        current: Optional[str] = None
        for raw in text.splitlines():
            if not raw.strip() or raw.lstrip().startswith(("*", "#")):
                continue
            if raw[0] not in (" ", "\t"):
                toks = raw.split()
                head = toks[0].upper()
                if head == "NAME":
                    self.name = toks[1] if len(toks) > 1 else ""
                    continue
                if head == "ENDATA":
                    break
                current = head
                self.order.append(head)
                self.lines.setdefault(head, [])
            elif current is not None:
                self.lines[current].append(raw)

    def get(self, key: str) -> List[str]:
        return self.lines.get(key, [])


def save_qps(path: str, Q, A, q, bmin, bmax, c: float = 0.0,
             name: str = "QP", lvar=None, uvar=None) -> None:
    """Write a QP as a new-format QPS file (round-trips through load_qps).

    General two-sided rows become G rows with a RANGES entry.  Variable
    bounds: with `lvar`/`uvar` given, per-variable BOUNDS entries are
    emitted (LO/UP/FX/FR/MI; the parser folds them back into identity rows
    of A, the reference convention, qpalm_qps.c:145-148); without them
    every variable is declared FR (fold bounds into A yourself if needed).
    Q and A may be dense or scipy sparse — sparse inputs never densify, so
    10^5-nonzero Maros-Meszaros-scale instances write in seconds.  No
    reference equivalent (the reference only reads QPS); used by the test
    suite and the benchmark harness to materialize synthetic problem sets.
    """
    Qs = sp.csc_matrix(Q) if not sp.issparse(Q) else Q.tocsc()
    As = sp.csc_matrix(A) if not sp.issparse(A) else A.tocsc()
    q = np.asarray(q, float).ravel()
    bmin = np.asarray(bmin, float).ravel()
    bmax = np.asarray(bmax, float).ravel()
    n = Qs.shape[0]
    m = As.shape[0]
    lines = [f"NAME          {name}", "ROWS", " N  obj"]
    ranges = []
    for i in range(m):
        lo, hi = bmin[i], bmax[i]
        if lo == hi:
            lines.append(f" E  r{i}")
        elif lo <= -QPS_INFTY:
            lines.append(f" L  r{i}")
        else:
            lines.append(f" G  r{i}")
            if hi < QPS_INFTY:
                ranges.append((i, hi - lo))
    lines.append("COLUMNS")
    indptr, indices, data = As.indptr, As.indices, As.data
    for j in range(n):
        if q[j] != 0.0:
            lines.append(f"    x{j}  obj  {q[j]:.17g}")
        lo, hi = indptr[j], indptr[j + 1]
        for k in range(lo, hi):
            if data[k] != 0.0:
                lines.append(f"    x{j}  r{indices[k]}  {data[k]:.17g}")
        if q[j] == 0.0 and lo == hi:
            lines.append(f"    x{j}  obj  0.0")
    lines.append("RHS")
    if c != 0.0:
        lines.append(f"    rhs  obj  {-c:.17g}")
    for i in range(m):
        lo, hi = bmin[i], bmax[i]
        rhs = hi if (lo <= -QPS_INFTY and lo != hi) else lo
        if lo <= -QPS_INFTY and hi >= QPS_INFTY:
            # fully-free row (written as L): the RHS entry must be emitted
            # even though it is "infinite" — the parser clips it back to
            # QPS_INFTY and recovers bmax = +inf; omitting it would parse
            # back with the L-row default bmax = 0, silently tightening
            # the constraint on round-trip
            lines.append(f"    rhs  r{i}  {QPS_INFTY:.17g}")
        elif rhs != 0.0 and (abs(rhs) < QPS_INFTY):
            lines.append(f"    rhs  r{i}  {rhs:.17g}")
    if ranges:
        lines.append("RANGES")
        for i, r in ranges:
            lines.append(f"    rng  r{i}  {r:.17g}")
    lines.append("BOUNDS")
    if lvar is None and uvar is None:
        for j in range(n):
            lines.append(f" FR bnd  x{j}")
    else:
        lv = (np.full(n, -np.inf) if lvar is None
              else np.asarray(lvar, float).ravel())
        uv = (np.full(n, np.inf) if uvar is None
              else np.asarray(uvar, float).ravel())
        for j in range(n):
            lo, hi = lv[j], uv[j]
            lo_inf, hi_inf = lo <= -QPS_INFTY, hi >= QPS_INFTY
            if lo_inf and hi_inf:
                lines.append(f" FR bnd  x{j}")
            elif lo == hi:
                lines.append(f" FX bnd  x{j}  {lo:.17g}")
            elif lo_inf:
                lines.append(f" MI bnd  x{j}")
                lines.append(f" UP bnd  x{j}  {hi:.17g}")
            else:
                # MPS default for a mentioned-or-not column is [0, +inf):
                # emit only what deviates
                if lo != 0.0:
                    lines.append(f" LO bnd  x{j}  {lo:.17g}")
                if not hi_inf:
                    lines.append(f" UP bnd  x{j}  {hi:.17g}")
    Ql = sp.tril(Qs, format="coo")
    if Ql.nnz:
        lines.append("QUADOBJ")
        for i, j, v in zip(Ql.row, Ql.col, Ql.data):
            if v != 0.0:
                # QUADOBJ entry (col, row) of the lower triangle
                lines.append(f"    x{j}  x{i}  {v:.17g}")
    lines.append("ENDATA")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_qps(path: str, native: Optional[bool] = None) -> QPProblem:
    """Parse a QPS/MPS file (new whitespace-separated format, as produced by
    the reference's old-format converter, qps_conversion.c).

    `native=None` uses the C++ reader (native/qps_reader.cpp) when it is
    available and silently falls back to this Python parser; True forces
    native (raising if unavailable); False forces Python.
    """
    if native is not False:
        try:
            from .native import load_qps_native

            return load_qps_native(path)
        except Exception:
            # fall through to Python on any failure (including parse errors:
            # old fixed-column files are converted there) unless native was
            # explicitly requested
            if native:
                raise
    return load_qps_python(path)


def convert_old_format(text: str) -> str:
    """Convert an old fixed-column QPS/MPS file (names may contain spaces)
    to the new whitespace-separated format (reference:
    qps_conversion.c:37-160 — spaces inside name fields are removed).

    Fields follow the classic MPS columns (1-indexed): 2-3, 5-12, 15-22,
    25-36, 40-47, 50-61; parsed leniently (fields are stripped and internal
    spaces deleted).
    """
    def f(line, a, b):
        return line[a:b].replace(" ", "").replace("\t", "")

    out = []
    section = None
    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        if raw[0] not in (" ", "\t"):
            toks = raw.split()
            section = toks[0].upper()
            out.append(raw.rstrip())
            continue
        if section == "ROWS":
            out.append(f" {f(raw, 1, 3)}  {f(raw, 3, 13)}")
        elif section in ("COLUMNS", "RHS", "RANGES"):
            toks = [f(raw, 1, 13), f(raw, 13, 23), f(raw, 23, 38)]
            if len(raw.rstrip()) > 39:
                toks += [f(raw, 38, 49), f(raw, 49, 62)]
            out.append("    " + "  ".join(t for t in toks if t))
        elif section == "BOUNDS":
            toks = [f(raw, 1, 4), f(raw, 4, 13), f(raw, 13, 23),
                    f(raw, 23, 38)]
            out.append(" " + "  ".join(t for t in toks if t))
        elif section == "QUADOBJ":
            toks = [f(raw, 1, 13), f(raw, 13, 23), f(raw, 23, 38)]
            out.append("    " + "  ".join(t for t in toks if t))
        else:
            out.append(raw.rstrip())
    return "\n".join(out) + "\n"


def load_qps_python(path: str) -> QPProblem:
    """The pure-Python QPS parser (fallback + differential-test oracle).
    Old fixed-column files (reference: qps_conversion.c) are auto-converted
    on a failed new-format parse."""
    with open(path, "r") as f:
        text = f.read()
    try:
        return _parse_qps_text(text)
    except (ValueError, KeyError):
        # mangled old-format tokens surface as either unparseable floats
        # (ValueError) or unknown row/column names (KeyError)
        return _parse_qps_text(convert_old_format(text))


def _parse_qps_text(text: str) -> QPProblem:
    secs = _Sections(text)

    # ---- ROWS ------------------------------------------------------------
    objective = ""
    free_rows = set()  # N rows beyond the objective: unconstrained, ignored
    row_names: List[str] = []
    row_sign: Dict[str, str] = {}
    for line in secs.get("ROWS"):
        toks = line.split()
        if len(toks) != 2:
            raise ValueError(f"ROWS line not in new QPS format: {line!r}")
        sign, rname = toks[0].upper(), toks[1]
        if sign == "N":
            if not objective:
                objective = rname
            else:
                free_rows.add(rname)
            continue
        if sign not in ("L", "G", "E"):
            raise ValueError(f"Unknown row sense {sign!r}")
        row_sign[rname] = sign
        row_names.append(rname)
    row_idx = {rn: i for i, rn in enumerate(row_names)}
    m_rows = len(row_names)

    # ---- COLUMNS ----------------------------------------------------------
    col_names: List[str] = []
    col_idx: Dict[str, int] = {}
    A_r: List[int] = []
    A_c: List[int] = []
    A_v: List[float] = []
    q_entries: Dict[int, float] = {}
    for line in secs.get("COLUMNS"):
        toks = line.split()
        if len(toks) >= 3 and toks[1].upper() == "'MARKER'":
            raise ValueError("Integer MARKER sections are not supported")
        cname = toks[0]
        if cname not in col_idx:
            col_idx[cname] = len(col_names)
            col_names.append(cname)
        j = col_idx[cname]
        pairs = toks[1:]
        if len(pairs) % 2:
            raise ValueError(f"Malformed COLUMNS line: {line!r}")
        for k in range(0, len(pairs), 2):
            rname, val = pairs[k], _clip_inf(float(pairs[k + 1]))
            if rname == objective:
                q_entries[j] = val
            elif rname in free_rows:
                pass  # standard MPS free row: no constraint
            else:
                A_r.append(row_idx[rname])
                A_c.append(j)
                A_v.append(val)
    n = len(col_names)

    # ---- BOUNDS (pass 1: find FR variables) -------------------------------
    bounds_lines = secs.get("BOUNDS")
    no_name_bounds = False
    for line in bounds_lines:
        toks = line.split()
        bt = toks[0].upper()
        # named format: TYPE BNDNAME COL [VAL]; unnamed: TYPE COL [VAL]
        # detection mirrors qpalm_qps.c:164-176
        if bt in ("FR", "MI", "PL", "BV"):
            if len(toks) == 2:
                no_name_bounds = True
        else:
            if len(toks) == 3:
                no_name_bounds = True

    def _bound_col_and_val(toks) -> Tuple[str, float]:
        bt = toks[0].upper()
        has_val = bt not in ("FR", "MI", "PL", "BV")
        if no_name_bounds:
            cname = toks[1]
            val = float(toks[2]) if has_val and len(toks) > 2 else 0.0
        else:
            cname = toks[2] if len(toks) > 2 else toks[1]
            val = float(toks[3]) if has_val and len(toks) > 3 else 0.0
        return cname, val

    free_cols = set()
    rebounded = set()  # FR then a later tightening bound line
    for line in bounds_lines:
        toks = line.split()
        cname, _ = _bound_col_and_val(toks)
        j = col_idx[cname]
        if toks[0].upper() == "FR":
            free_cols.add(j)
        elif j in free_cols:
            rebounded.add(j)
    free_cols -= rebounded

    bounded_cols = [j for j in range(n) if j not in free_cols]
    bound_row = {j: m_rows + i for i, j in enumerate(bounded_cols)}
    m = m_rows + len(bounded_cols)

    # ---- assemble bounds ---------------------------------------------------
    bmin = np.zeros(m)
    bmax = np.zeros(m)
    for rn in row_names:
        i = row_idx[rn]
        s = row_sign[rn]
        if s == "L":
            bmin[i], bmax[i] = -QPS_INFTY, 0.0
        elif s == "G":
            bmin[i], bmax[i] = 0.0, QPS_INFTY
        else:
            bmin[i], bmax[i] = 0.0, 0.0
    for j in bounded_cols:
        bmin[bound_row[j]], bmax[bound_row[j]] = 0.0, QPS_INFTY

    # identity rows for variable bounds
    for j in bounded_cols:
        A_r.append(bound_row[j])
        A_c.append(j)
        A_v.append(1.0)

    # ---- RHS ---------------------------------------------------------------
    c_const = 0.0
    rhs_lines = secs.get("RHS")
    no_name_rhs = any(len(l.split()) in (2, 4) for l in rhs_lines)

    def _pairs(line: str, unnamed: bool):
        toks = line.split()
        if not unnamed:
            toks = toks[1:]
        for k in range(0, len(toks) - 1, 2):
            yield toks[k], float(toks[k + 1])

    for line in rhs_lines:
        for rname, val in _pairs(line, no_name_rhs):
            if rname == objective:
                c_const = -val
                continue
            if rname in free_rows:
                continue
            i = row_idx[rname]
            s = row_sign[rname]
            if s == "L":
                bmax[i], bmin[i] = val, -QPS_INFTY
            elif s == "G":
                bmin[i] = val
            else:
                bmin[i] = bmax[i] = val

    # ---- RANGES ------------------------------------------------------------
    ranges_lines = secs.get("RANGES")
    no_name_ranges = any(len(l.split()) in (2, 4) for l in ranges_lines)
    for line in ranges_lines:
        for rname, val in _pairs(line, no_name_ranges):
            if rname in free_rows:
                continue
            i = row_idx[rname]
            s = row_sign[rname]
            if s == "L":
                bmin[i] = bmax[i] - abs(val)
            elif s == "G":
                bmax[i] = bmin[i] + abs(val)
            else:  # E rows: standard MPS semantics (reference skips these)
                if val >= 0:
                    bmax[i] = bmin[i] + val
                else:
                    bmin[i] = bmax[i] + val

    # ---- BOUNDS (pass 2: apply) --------------------------------------------
    for line in bounds_lines:
        toks = line.split()
        bt = toks[0].upper()
        cname, val = _bound_col_and_val(toks)
        j = col_idx[cname]
        if bt == "FR":
            if j in bound_row:  # re-bounded later: open the row for now
                bmin[bound_row[j]] = -QPS_INFTY
                bmax[bound_row[j]] = QPS_INFTY
            continue
        i = bound_row[j]
        if bt == "UP":
            bmax[i] = val
        elif bt == "LO":
            bmin[i] = val
        elif bt == "FX":
            bmin[i] = bmax[i] = val
        elif bt == "MI":
            bmin[i] = -QPS_INFTY
        elif bt == "PL":
            bmax[i] = QPS_INFTY
        elif bt == "BV":
            bmin[i], bmax[i] = 0.0, 1.0
        else:
            raise ValueError(f"Unknown bound type {bt!r}")

    # ---- QUADOBJ / QMATRIX ---------------------------------------------------
    Q_r: List[int] = []
    Q_c: List[int] = []
    Q_v: List[float] = []
    quad_lines = secs.get("QUADOBJ") or secs.get("QMATRIX")
    qmatrix = "QMATRIX" in secs.lines and "QUADOBJ" not in secs.lines
    for line in quad_lines:
        toks = line.split()
        cj, ri, val = col_idx[toks[0]], col_idx[toks[1]], _clip_inf(float(toks[2]))
        Q_r.append(ri)
        Q_c.append(cj)
        Q_v.append(val)
        if ri != cj and not qmatrix:
            # QUADOBJ gives one triangle; mirror it (QMATRIX gives both)
            Q_r.append(cj)
            Q_c.append(ri)
            Q_v.append(val)

    q = np.zeros(n)
    for j, val in q_entries.items():
        q[j] = val

    A = sp.csc_matrix(
        (np.asarray(A_v), (np.asarray(A_r, int), np.asarray(A_c, int))),
        shape=(m, n),
    )
    Q = sp.csc_matrix(
        (np.asarray(Q_v), (np.asarray(Q_r, int), np.asarray(Q_c, int))),
        shape=(n, n),
    )
    return QPProblem(
        name=secs.name, Q=Q, A=A, q=q, bmin=bmin, bmax=bmax, c=c_const
    )
