"""The host's enqueue of scaling, K1 and the device polish, ms a
batch (`_round`'s `enqueue` phase over the window's batches)."""


def read(rec):
    p = rec.get("phases_s")
    if not p or not rec["requests"]:
        return None
    return 1e3 * p["enqueue"] / rec["requests"]
