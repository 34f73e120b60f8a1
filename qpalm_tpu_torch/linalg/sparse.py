"""Sparse matrices for the large-problem path (counterpart of
qpalm_tpu/linalg/sparse.py).

The reference's whole linear-system layer is sparse (LADEL/CHOLMOD CSC,
SURVEY §2.2); the dense path covers small and medium problems, and this
module gives the large sparse path what it needs without ever forming an
n x n dense matrix:

  * scipy -> `SparseMatrix` (the JAX package's BCOO): the CSR arrays of M
    and of M', built once, so that M v and M' w are both row-major
    products
  * row/column inf-norms (Ruiz scaling, reference scaling.c:49-80)
  * row/column scaling E A D without densifying
  * diag(Q), diag(A' diag(s) A): the Jacobi preconditioner of the CG
    Newton solver
  * a Gershgorin-style upper bound on lambda_max(A' diag(s) A) via
    |A|' s (|A| 1)
  * the block diagonals of M = Q + A' diag(s) A + I/gamma and their
    application through kernel K2 (the block-Jacobi preconditioner; the
    caller factors the blocks with `chol.cholesky_upper`)

Every sum here is a row reduction over CSR order (`torch.segment_reduce`
with the row offsets: one running sum a row, from 0, in column order), so
a product is the same on every run and on either device, and adds its
terms in the order the reference's BCOO product scatters them (row-major
COO).  No sum uses atomics (`index_add_`); the max-reductions of the
norms are exact in any order.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .chol import cholesky_solve


class SparseMatrix:
    """A sparse (r, c) matrix on one device: its entries in row-major order
    (`data`, `rows`, `cols`), the CSR row offsets of the matrix (`crow`) and
    of its transpose (`crow_t`, `cols_t`), and `tperm`, the order of `data`
    that lists the transpose row-major.  `with_data` gives a matrix of the
    same pattern with other values (scaling keeps the pattern); what is
    derived from the pattern alone (`_pattern`) is shared between them."""

    def __init__(self, data, rows, cols, crow, crow_t, cols_t, tperm, shape,
                 pattern_cache=None):
        self.data, self.rows, self.cols = data, rows, cols
        self.crow, self.crow_t, self.cols_t = crow, crow_t, cols_t
        self.tperm = tperm
        self.shape = tuple(shape)
        self._pattern = {} if pattern_cache is None else pattern_cache
        self._abs = self._data_t = None

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    def with_data(self, data: torch.Tensor) -> "SparseMatrix":
        return SparseMatrix(data, self.rows, self.cols, self.crow,
                            self.crow_t, self.cols_t, self.tperm, self.shape,
                            self._pattern)

    def double(self) -> "SparseMatrix":
        return self.with_data(self.data.double())

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        """M v for v (c,): row sums of data * v[cols] in CSR order."""
        return torch.segment_reduce(self.data * v[self.cols], "sum",
                                    offsets=self.crow)

    def tmv(self, w: torch.Tensor) -> torch.Tensor:
        """M' w for w (r,): the row sums of the transpose, in its CSR
        order."""
        if self._data_t is None:
            self._data_t = self.data[self.tperm]
        return torch.segment_reduce(self._data_t * w[self.cols_t], "sum",
                                    offsets=self.crow_t)

    def abs(self) -> "SparseMatrix":
        if self._abs is None:
            self._abs = self.with_data(self.data.abs())
        return self._abs

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        out[self.rows, self.cols] = self.data
        return out

    def csr(self) -> torch.Tensor:
        """The matrix as a torch CSR tensor (for comparisons with torch's
        own sparse product; the port's products are `mv` and `tmv`)."""
        with warnings.catch_warnings():  # torch's beta and invariant notes
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(self.crow, self.cols, self.data,
                                           self.shape,
                                           check_invariants=False)


def is_sparse(M) -> bool:
    return isinstance(M, SparseMatrix)


def from_scipy(M, dtype=None, device="cuda") -> SparseMatrix:
    """scipy sparse (any format) -> SparseMatrix on `device`, duplicates
    summed, entries sorted by row, then column."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(M, copy=True)
    csr.sum_duplicates()
    csr.sort_indices()
    r, c = csr.shape
    rows = np.repeat(np.arange(r, dtype=np.int64), np.diff(csr.indptr))
    cols = csr.indices.astype(np.int64)
    tperm = np.lexsort((rows, cols))  # by column, then row
    crow_t = np.zeros(c + 1, np.int64)
    np.cumsum(np.bincount(cols, minlength=c), out=crow_t[1:])
    data = np.asarray(csr.data, dtype or csr.data.dtype)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa: E731
        device)
    return SparseMatrix(t(data), t(rows), t(cols),
                        t(csr.indptr.astype(np.int64)), t(crow_t),
                        t(rows[tperm]), t(tperm), (r, c))


def row_inf_norms(A: SparseMatrix) -> torch.Tensor:
    # an empty row has inf-norm 0 (the reference's max(segment_max, 0))
    out = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    return out.scatter_reduce(0, A.rows, A.data.abs(), "amax")


def col_inf_norms(A: SparseMatrix) -> torch.Tensor:
    out = torch.zeros(A.shape[1], dtype=A.dtype, device=A.device)
    return out.scatter_reduce(0, A.cols, A.data.abs(), "amax")


def scale_rows_cols(A: SparseMatrix, E: torch.Tensor,
                    D: torch.Tensor) -> SparseMatrix:
    """E A D without densifying (reference scaling.c:66-74 semantics)."""
    return A.with_data(A.data * E[A.rows] * D[A.cols])


def scale_scalar(A: SparseMatrix, c) -> SparseMatrix:
    return A.with_data(A.data * c)


def sym_diag(Q: SparseMatrix) -> torch.Tensor:
    """diag of a symmetric SparseMatrix (each entry stored once)."""
    on = Q.rows == Q.cols
    out = torch.zeros(Q.shape[0], dtype=Q.dtype, device=Q.device)
    out[Q.rows[on]] = Q.data[on]
    return out


def ata_diag(A: SparseMatrix, s: torch.Tensor) -> torch.Tensor:
    """diag(A' diag(s) A) = sum_i s_i a_ij^2 per column j, summed over i in
    increasing order (a row reduction of the transpose)."""
    prod = (s[A.rows] * A.data * A.data)[A.tperm]
    return torch.segment_reduce(prod, "sum", offsets=A.crow_t)


def ata_gershgorin_upper(A: SparseMatrix, s: torch.Tensor) -> torch.Tensor:
    """max_j (|A|' diag(s) |A| 1)_j >= gershgorin_max(A' diag(s) A).

    Two sparse matvecs; an upper bound by the triangle inequality, used for
    the gamma boost (reference iteration.c:158-205) where a conservative
    bound only makes the boosted gamma smaller (safe)."""
    absA = A.abs()
    r = absA.mv(torch.ones(A.shape[1], dtype=A.dtype, device=A.device))
    return absA.tmv(s * r).max()


def _pad_mask(n: int, nb: int, block: int, device) -> torch.Tensor:
    """(nb, block, block): True where a block's row or column lies past n
    (those entries are the identity's)."""
    valid = (torch.arange(nb * block, device=device) < n).reshape(nb, block)
    return ~(valid[:, :, None] & valid[:, None, :])


class _BlockPlan:
    """Where the entries of Q and the products of A's entries land in the
    stacked (nblocks, block, block) diagonal blocks: made once for a
    pattern on the host, O(nnz + n block) (plus the pairs of entries of
    one row of A inside one block).

    q_src, q_dst: the entries of Q inside a diagonal block and their flat
    positions; p, q: the pairs of entries (i, j), (i, k) of A with j and k
    in one block, sorted by their flat position (then by i), and offs the
    offsets of each position's run in that order."""

    def __init__(self, Q: SparseMatrix, A: SparseMatrix, block: int):
        n = Q.shape[0]
        nb = -(-n // block)
        host = lambda t: t.cpu().numpy()  # noqa: E731
        qr, qc = host(Q.rows), host(Q.cols)
        inb = qr // block == qc // block
        q_src = np.nonzero(inb)[0]
        q_dst = ((qr // block) * block * block + (qr % block) * block
                 + qc % block)[inb]
        ar, ac = host(A.rows), host(A.cols)
        # runs of A's entries of one row inside one block (row-major order
        # keeps each run contiguous)
        key = ar * nb + ac // block
        start = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        size = np.diff(np.r_[start, len(key)])
        run = np.repeat(np.arange(len(start)), size)
        g = size[run]  # each entry's run length
        p = np.repeat(np.arange(len(key)), g)
        first = np.repeat(start[run], g)
        q = first + (np.arange(len(p)) - np.repeat(np.cumsum(g) - g, g))
        dst = ((ac[p] // block) * block * block + (ac[p] % block) * block
               + ac[q] % block)
        order = np.argsort(dst, kind="stable")
        offs = np.zeros(nb * block * block + 1, np.int64)
        np.cumsum(np.bincount(dst, minlength=nb * block * block),
                  out=offs[1:])
        dev = Q.device
        t = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, np.int64)).to(dev)
        self.nb, self.block, self.n = nb, block, n
        self.q_src, self.q_dst = t(q_src), t(q_dst)
        self.p, self.q, self.offs = t(p[order]), t(q[order]), t(offs)
        self.rows = A.rows[self.p]
        self.pad = _pad_mask(n, nb, block, dev)


def _block_plan(Q: SparseMatrix, A: SparseMatrix, block: int) -> _BlockPlan:
    """The plan of Q's and A's patterns, made once (kept with A's pattern,
    so that every scaled copy of the problem finds it)."""
    key = ("block_plan", block, id(Q.rows))
    plan = A._pattern.get(key)
    if plan is None or plan[0] is not Q.rows:
        plan = (Q.rows, _BlockPlan(Q, A, block))
        A._pattern[key] = plan
    return plan[1]


def block_diagonals(Q, A, sig_act, gamma_inv, block: int) -> torch.Tensor:
    """Stacked block diagonals of M = Q + A' diag(sig_act) A + gamma_inv I:
    (nblocks, block, block), the tail block padded by identity rows and
    columns when block does not divide n.

    The block-Jacobi preconditioner's setup (no reference equivalent: the
    reference factors the whole sparse matrix).  Q and A are
    SparseMatrix; each block's A' diag(s) A part is a row reduction over
    the pairs of A's entries that share a row and the block, so nothing
    is densified."""
    plan = _block_plan(Q, A, block)
    nb, dtype = plan.nb, sig_act.dtype
    Qblk = torch.zeros(nb * block * block, dtype=dtype, device=Q.device)
    Qblk[plan.q_dst] = Q.data[plan.q_src]
    prod = A.data[plan.p] * (sig_act[plan.rows] * A.data[plan.q])
    G = torch.segment_reduce(prod, "sum", offsets=plan.offs)
    eye = torch.eye(block, dtype=dtype, device=Q.device)
    blk = (Qblk + G).reshape(nb, block, block) + gamma_inv * eye
    return torch.where(plan.pad, eye, blk)


def block_diagonals_dense(Q, A, sig_act, gamma_inv, block: int):
    """`block_diagonals` of a dense batch: Q (B, n, n), A (B, m, n),
    sig_act (B, m), gamma_inv (B,) -> (B * nblocks, block, block)."""
    B, n = Q.shape[0], Q.shape[-1]
    nb = -(-n // block)
    pad = nb * block - n
    Qp = torch.nn.functional.pad(Q, (0, pad, 0, pad))
    Ap = torch.nn.functional.pad(A, (0, pad))
    Qblk = torch.diagonal(Qp.reshape(B, nb, block, nb, block), dim1=1,
                          dim2=3).permute(0, 3, 1, 2)
    Ab = Ap.reshape(B, -1, nb, block).permute(0, 2, 1, 3)  # (B, nb, m, b)
    G = Ab.transpose(-1, -2) @ (sig_act[:, None, :, None] * Ab)
    eye = torch.eye(block, dtype=Q.dtype, device=Q.device)
    blk = Qblk + G + gamma_inv[:, None, None, None] * eye
    padm = _pad_mask(n, nb, block, Q.device)
    return torch.where(padm, eye, blk).reshape(B * nb, block, block)


def block_jacobi_apply(chol_blocks: torch.Tensor, r: torch.Tensor):
    """Apply the factored block-Jacobi preconditioner to a batch of
    vectors.

    chol_blocks: (B * nblocks, block, block) upper factors R'R = block
    (`chol.cholesky_upper`, kernel K2a on the card); r: (B, n).  Pads r
    to nblocks * block, solves each block's system R'R z = r with one
    vector a block (kernel K2b on the card), and truncates back."""
    nbB, block, _ = chol_blocks.shape
    B, n = r.shape
    nb = nbB // B
    rp = torch.nn.functional.pad(r, (0, nb * block - n))
    z = cholesky_solve(chol_blocks, rp.reshape(nbB, block))
    return z.reshape(B, nb * block)[:, :n]
