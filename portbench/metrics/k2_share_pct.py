"""Kernel K2's share of the traced window, %: device time of the
`chol` kernels (csrc/chol.cu) in torch.profiler's trace over the window."""


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    k2 = sum(s for name, s in t["by_name"].items() if "chol" in name)
    if not k2:
        return None
    return 100.0 * k2 / rec["window_s_traced"]
