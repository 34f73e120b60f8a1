"""The copy of the stacked batch to the card, ms a batch (`_round`'s
`copy` phase over the window's batches)."""


def read(rec):
    p = rec.get("phases_s")
    if not p or not rec["requests"]:
        return None
    return 1e3 * p["copy"] / rec["requests"]
