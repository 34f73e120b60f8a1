"""Roofline arithmetic of K1's streaming tier (qpalm_tpu_torch/csrc/
stream.cuh, the template STREAM of csrc/fused_palm.cu), for shapes whose Q
and A stay in global memory.

`roofline.k1_bound` reads Q and A once a launch, which holds on chip,
where they sit in shared memory for the whole loop.  Where they do not
fit a block (A alone is 2.6 MB a lane at n = 256, m = 2560, 335 MB over
128 lanes against a 50 MB L2), an iteration has to read them from HBM
again.  The least it has to read, whatever the plan, an iteration of one
lane:

  A   m n floats, twice.  The Newton system M = Q + A' S A + I / gamma
      and the gradient's A'y need S and y, which the previous step's line
      search fixed: one pass over A gives both.  Ad needs the direction d,
      which comes from the factor of the whole of M, so it needs a second
      pass; and the line search needs all of Ad before the next S is
      known, so the next iteration's first pass cannot share it.
  Q   n^2 floats, once: M's assembly reads it, Qx comes in the same
      pass, and d'Qd follows from M d = r as d'r - (Ad)' S (Ad) - d'd /
      gamma, without Q.

M itself (its upper triangle, n (n + 1) / 2 floats) fits a block's
shared memory at these n and is not counted.  The plan K1 runs today
reads A more often than this (`stream::schur_stream` streams all of A
for each group of 256 of M's 8 x 8 tiles, ceil(tiles / 256) passes, then
A'y and Ad once each) and writes M out and back; those are the plan's
choices, and the share against this bound shows what they cost.

Besides, once a launch: the vectors and the state, as `k1_bound` counts
them without Q and A.  The operations are `k1_bound`'s."""

from __future__ import annotations

from portbench.reference.roofline import HBM_RATE, k1_bound

A_PASSES = 2  # reads of A an iteration (the module's docstring)


def k1_stream_bytes_per_iter(n, m):
    """Bytes an iteration of one problem has to read from HBM (the
    module's docstring)."""
    return 4 * (A_PASSES * m * n + n * n)


def k1_stream_bound(nb, n, m, iterations):
    """K1's streaming bound for `iterations` iterations summed over nb
    problems of shape (n, m): bound_ms and bound_by as `roofline.bound`
    gives them, with the bytes (`nbytes`).  The operations' time is
    `k1_bound`'s with no bytes (nb = 0)."""
    ops_ms = k1_bound(0, n, m, iterations)["bound_ms"]
    once = 4 * nb * (2 * n + 3 * m + 1 + 2 * (8 * n + 7 * m + 18))
    nbytes = once + k1_stream_bytes_per_iter(n, m) * float(iterations)
    bytes_ms = 1e3 * nbytes / HBM_RATE
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                nbytes=nbytes)
