"""Kernel K1's device time, ms a batch (the program's CUDA events
around its launches, `fused_palm.events`)."""


def read(rec):
    if rec.get("k1_ms_total") is None or not rec["requests"]:
        return None
    return rec["k1_ms_total"] / rec["requests"]
