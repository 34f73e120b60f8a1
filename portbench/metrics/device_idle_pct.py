"""The device's idle share of the traced window, %: time in which no
kernel, copy or memset ran (torch.profiler's device trace)."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["n_ops"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / rec["window_s_traced"])
