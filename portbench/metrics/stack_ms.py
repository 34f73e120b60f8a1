"""Host stacking, ms a batch (`_round`'s `stack` phase over the window's
batches): `batch.stack_problems` in f32 and f64."""


def read(rec):
    p = rec.get("phases_s")
    if not p or not rec["requests"]:
        return None
    return 1e3 * p["stack"] / rec["requests"]
