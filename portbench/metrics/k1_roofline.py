"""K1's share of its roofline, %: the least time the card could take for
the iterations K1 returned (portbench/reference/roofline.py `k1_bound`,
a frozen copy of chip_smoke.py's) over K1's event time."""

from portbench.reference.roofline import k1_bound


def read(rec):
    iters, ms = rec.get("k1_iterations"), rec.get("k1_ms_total")
    if not iters or not ms:
        return None
    b = k1_bound(rec["batch"] * rec["requests"], rec["n"], rec["m"], iters)
    return 100.0 * b["bound_ms"] / ms
