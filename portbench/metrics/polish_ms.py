"""The device polish's device time, ms a batch (the CUDA events
`_round` records around `polish_batch`)."""


def read(rec):
    if rec.get("polish_ms_total") is None or not rec["requests"]:
        return None
    return rec["polish_ms_total"] / rec["requests"]
