"""Settings-file reader (the port's copy of
qpalm_tpu/io/settings_io.py).

Matches the reference QPS driver's key-value settings format (reference:
interfaces/qps/src/qpalm_qps.c:612-690, sample at
interfaces/qps/sample_settings.txt): the first five lines are a header and
ignored; each following line is `setting value`.  Unknown keys raise (the
reference prints and aborts reading).
"""

from __future__ import annotations

from ..types import Settings

_INT_KEYS = {
    "max_iter", "inner_max_iter", "scaling", "print_iter",
    "reset_newton_iter", "ordering", "factorization_method",
    "max_rank_update", "max_refine",
}
_BOOL_KEYS = {
    "proximal", "nonconvex", "verbose", "warm_start",
    "enable_dual_termination",
}
_FLOAT_KEYS = {
    "eps_abs", "eps_rel", "eps_abs_in", "eps_rel_in", "rho",
    "eps_prim_inf", "eps_dual_inf", "theta", "delta", "sigma_max",
    "sigma_init", "gamma_init", "gamma_upd", "gamma_max",
    "dual_objective_limit", "time_limit", "max_rank_update_fraction",
}
_ALL_KEYS = _INT_KEYS | _BOOL_KEYS | _FLOAT_KEYS


def read_settings_file(path: str, base: Settings | None = None) -> Settings:
    """Parse a reference-format settings file into a Settings object."""
    settings = base or Settings()
    kw = {}
    with open(path) as f:
        lines = f.readlines()[5:]  # 5-line header skipped (qpalm_qps.c:617-620)
    for line in lines:
        toks = line.split()
        if not toks or toks[0].startswith("#"):
            continue
        key = toks[0]
        if key not in _ALL_KEYS:
            raise ValueError(f"Unrecognised setting: {key}")
        val = float(toks[1])
        if key in _INT_KEYS:
            kw[key] = int(val)
        elif key in _BOOL_KEYS:
            kw[key] = bool(int(val))
        else:
            kw[key] = val
    return settings.replace(**kw)
