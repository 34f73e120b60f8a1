"""Kernel K2's launches an iteration: `chol.cholesky_upper.launches` +
`chol.cholesky_solve.launches` over the window, over its iterations."""


def read(rec):
    if not rec.get("iterations"):
        return None
    return rec["k2_launches"] / rec["iterations"]
