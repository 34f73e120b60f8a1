"""The device polish's K2 kernels' share of their roofline, %: the least
time the card could take for the polish's float32 factorizations and
identity solves at (n, n) over the device time of those kernels in
torch.profiler's trace of the window.

A request's polish (qpalm_tpu_torch/polish_device.py) factors the batch's
B preconditioners once, then those of its worst k lanes twice (the second
round; k is the configuration's `certify.polish.second_round_k`, which
the driver holds to the program's), and each factor is followed by a
solve against the identity: B + 2 min(k, B) matrices.  A matrix: the
factor's n^3 / 3 operations, and the identity solve's 4 n^3 / 3 (forward
substitution gives a lower triangular result from the identity, n^3 / 6
multiply-adds, backward substitution a full one, n^3 / 2), two
operations a multiply-add; bytes: the factor reads M and writes R, the
solve reads R and the identity and writes the inverse, n^2 floats each.
At n past shared memory (f32 n > 241) the factor is the cluster factor
and the solve the global solve; KERNELS are their names as the trace
prints them."""

import json
from pathlib import Path

from portbench.reference.roofline import bound

CONFIG = Path(__file__).resolve().parent.parent / "configs" / \
    "osqp_randomqp_n256.json"
KERNELS = ("void (anonymous namespace)::chol_cluster_kernel<float",
           "void (anonymous namespace)::chol_solve_global_kernel<float")


def second_round_k():
    """The configuration's `certify.polish.second_round_k`."""
    cfg = json.loads(CONFIG.read_text())
    return int(cfg["certify"]["polish"]["second_round_k"])


def k2_polish_bound(batch, n, requests):
    """bound_ms and bound_by of `requests` polishes of `batch` lanes at n,
    with the operations (`flops`) and the bytes (`nbytes`)."""
    mats = requests * (batch + 2 * min(second_round_k(), batch))
    flops = mats * (n ** 3 / 3 + 4 * n ** 3 / 3)
    nbytes = mats * 4 * 5 * n * n
    return dict(bound(flops, nbytes), flops=flops, nbytes=nbytes)


def read(rec):
    t = rec.get("trace")
    if not t or not rec.get("requests"):
        return None
    k2_s = sum(s for name, s in t["by_name"].items()
               if name.startswith(KERNELS))
    if not k2_s:
        return None
    b = k2_polish_bound(rec["batch"], rec["n"], rec["requests"])
    return 100.0 * b["bound_ms"] / (1e3 * k2_s)
