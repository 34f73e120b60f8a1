"""Lanes the device polish rejected, which the host rescue takes, in %
of the lanes attempted."""


def read(rec):
    if not rec.get("lanes"):
        return None
    return 100.0 * rec["rescued_lanes"] / rec["lanes"]
