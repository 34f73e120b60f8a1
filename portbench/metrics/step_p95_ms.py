"""The 95th percentile of all the window's requests, hand-in to complete
answer, ms: the end-to-end tail, read per layer in the traced run, where
the host's clock spreads too widely from process to process for an
end-to-end bound (PERF.md, section 2)."""

from portbench.harness import percentile


def read(rec):
    if not rec.get("requests") or not rec.get("latency_s"):
        return None
    return 1e3 * percentile(rec["latency_s"], 95)
