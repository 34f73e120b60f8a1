"""Wall ms an iteration of the general loop: the window's time over all
its steps' iterations."""


def read(rec):
    if not rec.get("iterations"):
        return None
    return 1e3 * rec["window_s"] / rec["iterations"]
