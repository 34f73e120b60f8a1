"""The general loop's iterations a control step (`Info.iter` over the
window's steps)."""


def read(rec):
    if not rec.get("requests"):
        return None
    return rec["iterations"] / rec["requests"]
