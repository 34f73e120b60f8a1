"""Roofline arithmetic: the published peaks of one NVIDIA H100 SXM (dense,
outside the tensor cores) and the least time a kernel's work could take on
it.  `bound` and `k1_bound` are frozen copies of chip_smoke.py's; the
copies' test holds them to the same numbers."""

from __future__ import annotations

F32_PEAK = 67e12  # FLOP/s, float32 outside the tensor cores
F64_PEAK = 34e12  # FLOP/s, float64 outside the tensor cores
HBM_RATE = 3.35e12  # bytes/s


def bound(flops, nbytes, peak=F32_PEAK):
    """bound_ms and bound_by of work of `flops` operations at `peak`
    FLOP/s that must move `nbytes` bytes."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def k1_bound(nb, n, m, iterations):
    """Kernel K1's bound for `iterations` iterations summed over nb
    problems of shape (n, m).  Per iteration: the symmetric Schur matrix
    A'WA (m n (n + 1)), plus Q and I/gamma (n^2); its Cholesky (n^3 / 3),
    the two triangular solves, Qd and the Q x update (4 n^2), A'y and Ad
    (4 m n), the linesearch's 28 hinge sums (about 6 m each) and about
    40 (n + m) elementwise.  Bytes: Q, A, the vectors and the state read
    once, the state written once."""
    per_iter = (m * n * (n + 1) + n * n + n ** 3 / 3 + 4 * n * n + 4 * m * n
                + 168 * m + 40 * (n + m))
    nbytes = 4 * nb * (n * n + m * n + 2 * n + 3 * m + 1
                       + 2 * (8 * n + 7 * m + 18))
    return bound(per_iter * float(iterations), nbytes)
