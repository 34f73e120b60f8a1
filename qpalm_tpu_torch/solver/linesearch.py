"""Exact piecewise-quadratic linesearch of the general solver loop
(counterpart of qpalm_tpu/solver/linesearch.py, reference
src/linesearch.c:14-120), batched: every vector is (B, m) or (B, n), every
scalar (B,).

Two forms compute the same exact minimizer tau of phi(x + tau d):
`linesearch_from_breakpoints`, the reference's sorted walk over the 2m
breakpoints (a stable sort, then prefix sums of the slope and intercept
increments), and `linesearch_bisection`, a safeguarded Newton / bisection
on the monotone piecewise-linear derivative.  `exact_linesearch` builds
the breakpoints and picks the form.

Rounding as the reference's XLA build on the CPU: it flushes denormals to
zero (so `delta * tiny` vanishes), and it contracts `a * b + c` into one
fused multiply-add.  Where the sign of such an expression decides a
branch at float32, the port evaluates it in float64, whose product of two
float32 numbers is exact: the same sign as the fused form.
"""

from __future__ import annotations

import torch


def _tiny(dtype) -> float:
    return float(torch.finfo(dtype).tiny)


def _ftz(v: torch.Tensor) -> torch.Tensor:
    """Denormals to zero, as the reference's CPU build computes them."""
    return torch.where(v.abs() < _tiny(v.dtype), torch.zeros_like(v), v)


def _fma_positive(a, b, c) -> torch.Tensor:
    """a * b + c > 0 with the product unrounded (a fused multiply-add,
    flushed to zero where it is denormal): exact at float32 through
    float64, two roundings at float64."""
    if a.dtype == torch.float32:
        v = a.double() * b.double() + c.double()
        return v >= _tiny(torch.float32)
    return a * b + c > 0


def exact_linesearch(d, Qd, Ad, df, Ax, y, sigma, sqrt_sigma, bmin, bmax,
                     mode: str = "sort") -> torch.Tensor:
    """tau (B,) minimizing phi(x + tau d) (linesearch.py:24-57).  Qd and
    Ad are the caller's (Q d [+ d/gamma] and A d); `mode` "sort" walks the
    sorted breakpoints, "bisect" bisects."""
    eta = (d * Qd).sum(-1)
    beta = (d * df).sum(-1)
    s_ad = sqrt_sigma * Ad
    delta = torch.cat([-s_ad, s_ad], -1)
    alpha_lo = (y + sigma * (Ax - bmin)) / sqrt_sigma
    alpha_hi = (-y + sigma * (bmax - Ax)) / sqrt_sigma
    alpha = torch.cat([alpha_lo, alpha_hi], -1)
    if mode == "bisect":
        return linesearch_bisection(eta, beta, delta, alpha)
    if mode != "sort":
        raise ValueError(f"linesearch mode {mode!r}: 'sort' or 'bisect'")
    return linesearch_from_breakpoints(eta, beta, delta, alpha)


def linesearch_bisection(eta, beta, delta, alpha, iters: int = 30):
    """Sort-free exact linesearch (linesearch.py:60-127): each step takes
    the exact root -b/a of the current piece when it lies inside the
    bracket, else the bracket's middle; 30 steps, then one exact Newton
    step from the piece landed in."""
    tiny = _tiny(delta.dtype)
    dd = delta * delta
    da = delta * alpha
    zero = torch.zeros((), dtype=delta.dtype, device=delta.device)

    def ab_at(tau, flush=False):
        if flush:  # tau = tiny: delta * tiny is denormal, flushed
            act = (_ftz(delta * tau[:, None]) - alpha) > 0
        else:
            act = _fma_positive(delta, tau[:, None], -alpha)
        a = eta + torch.where(act, dd, zero).sum(-1)
        b = beta - torch.where(act, da, zero).sum(-1)
        return a, b

    a0, b0 = ab_at(torch.full_like(eta, tiny), flush=True)
    s = alpha / delta
    s_valid = torch.where(s > 0, s, zero)
    s_max = torch.where(torch.isfinite(s_valid), s_valid, zero).amax(-1)
    act_fin = delta > 0
    a_fin = eta + torch.where(act_fin, dd, zero).sum(-1)
    b_fin = beta - torch.where(act_fin, da, zero).sum(-1)
    tau_fin = -b_fin / torch.clamp(a_fin, min=tiny)
    hi = torch.clamp(torch.maximum(s_max, tau_fin), min=1.0) * 1.01 + 1.0
    lo = torch.zeros_like(hi)
    tau = torch.minimum(-b0 / torch.clamp(a0, min=tiny), hi)
    tau = torch.where(tau > 0, tau, 0.5 * hi)
    for _ in range(iters):
        a, b = ab_at(tau)
        prop = -b / torch.clamp(a, min=tiny)
        mid = 0.5 * (lo + hi)
        prop = torch.where((prop > lo) & (prop < hi), prop, mid)
        pa, pb = ab_at(prop)
        pos = _fma_positive(pa, prop, pb)
        lo = torch.where(pos, lo, prop)
        hi = torch.where(pos, prop, hi)
        tau = prop
    a, b = ab_at(tau)
    tau_star = -b / torch.clamp(a, min=tiny)
    return torch.where(_ftz(a0 * tiny) + b0 > 0, -b0 / a0, tau_star)


def linesearch_from_breakpoints(eta, beta, delta, alpha):
    """The sorted walk (linesearch.py:130-176): breakpoints s = alpha /
    delta with IEEE semantics (delta = 0 gives +-inf or nan, both harmless
    there), sorted stably (jnp.argsort is stable, so tied breakpoints add
    up in the same order), prefix sums of the increments, and the first
    breakpoint where the derivative turns positive."""
    dtype = delta.dtype
    s = alpha / delta
    l_mask = s > 0
    p_mask = delta > 0
    j_mask = p_mask ^ l_mask
    dd = delta * delta
    da_raw = delta * alpha
    # a mask's product is a select (XLA rewrites convert(mask) * x so), so
    # that an infinite bound's breakpoint (alpha = inf) adds no 0 * inf
    zero = torch.zeros((), dtype=dtype, device=delta.device)
    a0 = eta + torch.where(j_mask, dd, zero).sum(-1)
    b0 = beta - torch.where(j_mask, da_raw, zero).sum(-1)
    inc_a = torch.where(p_mask, dd, -dd)
    inc_b = torch.where(p_mask, -da_raw, da_raw)

    key = torch.where(l_mask, s, torch.full_like(s, float("inf")))
    s_sorted, order = torch.sort(key, dim=-1, stable=True)
    valid = torch.gather(l_mask, -1, order)
    ca = torch.cumsum(torch.where(valid, torch.gather(inc_a, -1, order),
                                  zero), -1)
    cb = torch.cumsum(torch.where(valid, torch.gather(inc_b, -1, order),
                                  zero), -1)
    head = torch.zeros_like(ca[:, :1])
    a_k = a0[:, None] + torch.cat([head, ca[:, :-1]], -1)
    b_k = b0[:, None] + torch.cat([head, cb[:, :-1]], -1)

    crossed = valid & _fma_positive(a_k, s_sorted, b_k)
    any_crossed = crossed.any(-1)
    k = torch.argmax(crossed.to(torch.int8), -1, keepdim=True)
    a_sel = torch.where(any_crossed, torch.gather(a_k, -1, k)[:, 0],
                        a0 + ca[:, -1])
    b_sel = torch.where(any_crossed, torch.gather(b_k, -1, k)[:, 0],
                        b0 + cb[:, -1])
    return -b_sel / a_sel
