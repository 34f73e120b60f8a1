"""Host stacking and the copy to the card, ms a batch (`_round`'s
`stack` + `copy` phases over the window's batches)."""


def read(rec):
    p = rec.get("phases_s")
    if not p or not rec["requests"]:
        return None
    return 1e3 * (p["stack"] + p["copy"]) / rec["requests"]
