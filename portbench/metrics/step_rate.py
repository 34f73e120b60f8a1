"""Certified requests a second over the window's wall time: the
end-to-end rate, read per layer in the traced run, where the host's
clock spreads too widely from process to process for an end-to-end
bound (PERF.md, section 2)."""


def read(rec):
    if not rec.get("requests") or rec.get("certified") is None:
        return None
    return rec["certified"] / rec["window_s"]
