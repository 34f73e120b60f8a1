"""K1's share of its streaming roofline, %: the least time the card could
take for the iterations K1 returned, with A read from HBM twice and Q once
every iteration (portbench/reference/roofline_stream.py
`k1_stream_bound`), over K1's event time."""

from portbench.reference.roofline_stream import k1_stream_bound


def read(rec):
    iters, ms = rec.get("k1_iterations"), rec.get("k1_ms_total")
    if not iters or not ms:
        return None
    b = k1_stream_bound(rec["batch"] * rec["requests"], rec["n"], rec["m"],
                        iters)
    return 100.0 * b["bound_ms"] / ms
