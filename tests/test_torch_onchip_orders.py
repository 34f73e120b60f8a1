"""The order of K1's on-chip tier since its redesign (csrc/fused_palm.cu,
csrc/common.cuh), held on the CPU by plain emulations of what the kernel
now does, bit for bit against the twin's functions:

  (a) block_reduce's order (thread t of 256 folds elements t, t + 256, ...,
      each warp butterflied, the 8 warps combined in order), in which the
      linesearch's sums are taken, equals the twin's `_block_sum`, signed
      zeros included, and its NaN-propagating max equals the max;
  (b) the linesearch that carries each proposal's hinge sums into the next
      step (27 evaluations after the first reduction, not 53) equals
      `_linesearch_plain`;
  (c) the left-looking Cholesky (row by row, each entry's subtractions in
      order in one thread) equals `cholesky_upper_plain`, which K2a and the
      on-chip K1 both run;
  (d) the warp solves whose forward pivot comes from lane 0's register and
      whose every lane computes x_k (lane 0's next partial taking x_{k+1}
      from it) equal `_solve_kernel_order`, every lane holding the same x.

The kernel itself is held to the twin bit for bit on a card
(tests/test_torch_fused.py, chip_smoke.py phase 4)."""

import numpy as np
import pytest
import torch

from qpalm_tpu_torch.linalg.chol import cholesky_upper_plain
from qpalm_tpu_torch.solver import fused as F
import torch_support  # noqa: F401

NT, WARPS = 256, 8


def _bits(t):
    return t.contiguous().view(torch.int32)


def _add(a, b):
    return a + b


def _nmax(a, b):
    """common.cuh:nmax, the max that propagates NaN."""
    return torch.where(torch.isnan(a) | (a > b), a, b)


def _butterfly(lanes, op):
    """warp_sum's xor butterfly over 32 per-lane values: each lane ends
    with op(own, partner) at every level; returns lane 0's, after checking
    that every lane ends with the same bits."""
    for o in (16, 8, 4, 2, 1):
        lanes = [op(lanes[p], lanes[p ^ o]) for p in range(32)]
    for p in range(1, 32):
        assert torch.equal(_bits(lanes[p]), _bits(lanes[0]))
    return lanes[0]


def _block_reduce(v, op):
    """fused_palm.cu:block_reduce: thread t of 256 folds elements t,
    t + 256, ... from 0, each warp's 32 threads are butterflied, the 8 warp
    results combined in warp order."""
    B, m = v.shape
    out = None
    for w in range(WARPS):
        lanes = []
        for p in range(32):
            acc = torch.zeros(B)
            for i in range(32 * w + p, m, NT):
                acc = op(acc, v[:, i])
            lanes.append(acc)
        part = _butterfly(lanes, op)
        out = part if w == 0 else op(out, part)
    return out


@pytest.mark.parametrize("m", [8, 24, 80, 96, 300])
def test_block_reduction_order_equals_block_sum(m):
    rng = np.random.default_rng(m)
    v = rng.standard_normal((6, m)).astype(np.float32)
    v[1, rng.random(m) < 0.5] = 0.0
    v[2] = 0.0
    v[3] = -0.0  # a sum of negative zeros is +0 in both
    v[4, rng.random(m) < 0.3] = -0.0
    v[5] *= 1e-38  # denormal partials
    v = torch.from_numpy(v)
    got = _block_reduce(v, _add)
    assert torch.equal(_bits(got), _bits(F._block_sum(v)[:, 0]))
    # the NaN-propagating max of the breakpoints (values >= 0, one NaN)
    w = torch.from_numpy(np.abs(rng.standard_normal((3, m))).astype(
        np.float32))
    w[1, m // 2] = float("nan")
    w[2] = 0.0
    got = _block_reduce(w, _nmax)
    assert torch.isnan(got[1]) and not torch.isnan(got[[0, 2]]).any()
    assert torch.equal(got[[0, 2]], w.amax(1)[[0, 2]])


def _linesearch_inputs(m, seed):
    rng = np.random.default_rng(seed)
    B = 16

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    sig = f32(10.0 ** rng.uniform(-2, 3, (B, m)))
    Ad = f32(rng.standard_normal((B, m)))
    Ax = f32(rng.standard_normal((B, m)))
    y = f32(rng.standard_normal((B, m)))
    bmin = f32(rng.standard_normal((B, m)) - 1.0)
    bmax = bmin + f32(rng.uniform(0.0, 2.0, (B, m)))
    # padded rows and one-sided rows, as stack_problems pads
    bmin[:, -2:] = -1e21
    bmax[:, -1:] = 1e21
    eta = f32(rng.uniform(0.1, 10.0, (B, 1)))
    beta = f32(-rng.uniform(0.1, 10.0, (B, 1)))
    return eta, beta, torch.sqrt(sig), Ad, Ax, y, sig, bmin, bmax


def _linesearch_carried(eta, beta, sqs, Ad, Ax, y, sig, bmin, bmax):
    """The kernel's linesearch: the hinge sums at step t's proposal are
    step t + 1's sums at tau and, after the last step, tau_star's."""
    sad = sqs * Ad
    alo = (y + sig * (Ax - bmin)) / sqs
    ahi = (-y + sig * (bmax - Ax)) / sqs
    tiny = float(np.finfo(np.float32).tiny)
    zero = torch.zeros(())
    dd = sad * sad
    calls = [0]

    def ftz(v):
        return torch.where(v.abs() < tiny, zero, v)

    def ab_at(tau):
        calls[0] += 1
        st = ftz(sad * tau)
        act1, act2 = (-st - alo) > 0, (st - ahi) > 0
        return (eta + F._block_sum(torch.where(act1, dd, zero)
                                   + torch.where(act2, dd, zero)),
                beta - F._block_sum(torch.where(act1, -sad * alo, zero)
                                    + torch.where(act2, sad * ahi, zero)))

    a0, b0 = ab_at(tiny)
    s1, s2 = alo / (-sad), ahi / sad
    smax = _nmax(
        _block_reduce(torch.where((s1 > 0) & (s1 < 1e30), s1, zero), _nmax),
        _block_reduce(torch.where((s2 > 0) & (s2 < 1e30), s2, zero),
                      _nmax))[:, None]
    f1, f2 = -sad > 0, sad > 0
    a_fin = eta + F._block_sum(torch.where(f1, dd, zero)
                               + torch.where(f2, dd, zero))
    b_fin = beta - F._block_sum(torch.where(f1, -sad * alo, zero)
                                + torch.where(f2, sad * ahi, zero))
    hi = torch.clamp(_nmax(smax, -b_fin / torch.clamp(a_fin, min=tiny)),
                     min=1.0) * 1.01 + 1.0
    lo = torch.zeros_like(hi)
    tau = torch.minimum(-b0 / torch.clamp(a0, min=tiny), hi)
    tau = torch.where(tau > 0, tau, 0.5 * hi)
    a, b = ab_at(tau)
    for _ in range(26):
        prop = -b / torch.clamp(a, min=tiny)
        prop = torch.where((prop > lo) & (prop < hi), prop, 0.5 * (lo + hi))
        a, b = ab_at(prop)
        pos = a.double() * prop.double() + b.double() > 0
        lo = torch.where(pos, lo, prop)
        hi = torch.where(pos, prop, hi)
    assert calls[0] == 28  # a0 and b0, then 27 evaluations at a tau
    tau_star = -b / torch.clamp(a, min=tiny)
    return torch.where(ftz(a0 * tiny) + b0 > 0, -b0 / a0, tau_star)


@pytest.mark.parametrize("m,seed", [(8, 1), (96, 2), (96, 3), (300, 4)])
def test_carried_linesearch_equals_the_plain_one(m, seed):
    args = _linesearch_inputs(m, seed)
    got = _linesearch_carried(*args)
    want = F._linesearch_plain(*args)
    assert torch.isfinite(want).all()
    assert torch.equal(_bits(got), _bits(want))


def _spd(n, B=4, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n)).astype(np.float32)
    M = G @ np.transpose(G, (0, 2, 1)) + n * np.eye(n, dtype=np.float32)
    return torch.from_numpy(M.astype(np.float32))


def _chol_left_looking(M):
    """common.cuh:chol_upper_inplace: the lower triangle zeroed, then row by
    row, entry (k, l >= k) less R[i][k] R[i][l] for i < k in turn (the
    pivot's sum beside it), times 1 / sqrt of the pivot so reduced, the
    diagonal pivot * inv."""
    R = torch.triu(M.clone())
    n = M.shape[-1]
    for k in range(n):
        akk, v = R[:, k, k].clone(), R[:, k, k:].clone()
        for i in range(k):
            rik = R[:, i, k]
            akk = akk - rik * rik
            v = v - rik[:, None] * R[:, i, k:]
        inv = 1.0 / torch.sqrt(akk)
        R[:, k, k:] = torch.cat([(akk * inv)[:, None], v[:, 1:] * inv[:, None]],
                                1)
    return R


@pytest.mark.parametrize("n", [1, 2, 9, 33, 64, 100])
def test_left_looking_cholesky_equals_the_plain_order(n):
    M = _spd(n, seed=n)
    assert torch.equal(_chol_left_looking(M), cholesky_upper_plain(M))


def _solve_warp(R, d):
    """fused_palm.cu:chol_solve_warp, lane by lane (lane l takes entries
    j + 1 + l, + 32, ... of step j): forward, z_j from the pivot that lane 0
    left in its register last step; backward, each lane's strided partial
    (lane 0's first term R_k,k+1 x_{k+1} from the register every lane keeps)
    butterflied as warp_sum does, and x_k computed on every lane."""
    B, n = d.shape
    d = d.clone()
    z = torch.empty_like(d)
    piv = d[:, 0].clone()
    for j in range(n):
        z[:, j] = piv / R[:, j, j]
        for lane in range(32):
            for l in range(j + 1 + lane, n, 32):
                v = d[:, l] - z[:, j] * R[:, j, l]
                d[:, l] = v
                if l == j + 1:
                    piv = v
    x = d
    xn = torch.zeros(B)
    for k in range(n - 1, -1, -1):
        lanes = []
        for lane in range(32):
            s = torch.zeros(B)
            for l in range(k + 1 + lane, n, 32):
                s = s + R[:, k, l] * (xn if l == k + 1 else x[:, l])
            lanes.append(s)
        for o in (16, 8, 4, 2, 1):
            lanes = [lanes[p] + lanes[p ^ o] for p in range(32)]
        xs = [(z[:, k] - s) / R[:, k, k] for s in lanes]
        for p in range(1, 32):
            assert torch.equal(_bits(xs[p]), _bits(xs[0]))
        xn = xs[0]
        x[:, k] = xn
    return x


@pytest.mark.parametrize("n", [1, 2, 31, 33, 64, 100])
def test_warp_solve_equals_the_kernel_order(n):
    R = cholesky_upper_plain(_spd(n, seed=100 + n))
    d = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (4, n)).astype(np.float32))
    want = F._solve_kernel_order(R, d)
    assert torch.equal(_bits(_solve_warp(R, d)), _bits(want))
