"""The order of K1's streaming tier since its blocked redesign
(qpalm_tpu_torch/csrc/stream.cuh), held on the CPU by plain emulations:

  (a) the blocked right-looking Cholesky (panels of b rows factored row by
      row, left-looking within the panel, then the trailing upper triangle
      updated tile by tile, the panel's products subtracted in order)
      equals the unblocked cholesky_upper_plain bit for bit, ragged last
      panels included;
  (b) the panelled upper-triangle Schur assembly (A in row panels of P rows,
      8x8 tiles of the upper triangle enumerated as the kernel enumerates
      them) equals the twin's loop on the upper triangle bit for bit, and
      its Gershgorin completion equals the twin's;
  (c) the memory plan with the staging panels admits exactly the shapes the
      plan without them admitted.

On a card: the plan mirrored by the library, and the assembly probe against
its plain version at the probe sizes (the streaming kernel's bit-identity
to its twin at n=352 and with ragged panels is in test_torch_stream.py)."""

import numpy as np
import pytest
import torch

from qpalm_tpu_torch import probe
from qpalm_tpu_torch.linalg.chol import SMEM_LIMIT, cholesky_upper_plain
from qpalm_tpu_torch.solver import fused as F
from qpalm_tpu_torch.sweep import ROWS, row_problems
from torch_support import _cuda

TILE = 8


def _spd(n, B=3, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n)).astype(np.float32)
    M = G @ np.transpose(G, (0, 2, 1)) + n * np.eye(n, dtype=np.float32)
    return torch.from_numpy(M.astype(np.float32))


def _upper_tiles(nb):
    """stream.cuh:upper_tile for t = 0, 1, ...: the 8x8 tiles of the upper
    triangle of an nb x nb tile grid, row by row."""
    return [(tr, tc) for tr in range(nb) for tc in range(tr, nb)]


def _chol_blocked(M, b):
    """stream.cuh:chol_blocked on a batch: panels of b rows factor in shared
    memory row by row, left-looking (row k's entries get the products of
    the panel's rows 0..k-1 subtracted in order, then are scaled by
    1 / sqrt of the diagonal so formed), go back to M, then the trailing
    upper triangle is updated tile by tile, each tile's entries getting the
    panel's products r_kj r_kl subtracted in k order."""
    M = M.clone()
    n = M.shape[-1]
    for p in range(0, n, b):
        bb = min(b, n - p)
        pan = M[:, p:p + bb, :].clone()
        for k in range(bb):
            c = p + k
            acc = pan[:, k, c:].clone()
            for i in range(k):
                acc -= pan[:, i, c, None] * pan[:, i, c:]
            akk = acc[:, 0].clone()
            inv = 1.0 / torch.sqrt(akk)
            pan[:, k, c + 1:] = acc[:, 1:] * inv[:, None]
            pan[:, k, c] = akk * inv
        M[:, p:p + bb, p:] = pan[:, :, p:]
        t0 = p + bb
        for tr, tc in _upper_tiles(-(-(n - t0) // TILE)):
            r0, c0 = t0 + TILE * tr, t0 + TILE * tc
            rows, cols = slice(r0, min(n, r0 + TILE)), slice(c0, min(n, c0 + TILE))
            acc = M[:, rows, cols].clone()
            for r in range(bb):
                acc -= pan[:, r, rows, None] * pan[:, r, None, cols]
            M[:, rows, cols] = acc
    return torch.triu(M)


@pytest.mark.parametrize("n", [16, 40, 136])
@pytest.mark.parametrize("b", [1, 8, 32])
def test_blocked_cholesky_order_is_bit_identical(n, b):
    M = _spd(n, seed=n + b)
    want = cholesky_upper_plain(M)
    got = _chol_blocked(M, b)
    assert torch.equal(got, want)
    assert torch.isfinite(got).all()


def _schur_panelled(A, w, P):
    """stream.cuh:schur_stream on a batch: A's rows come in panels of P
    rows, each upper 8x8 tile (those on the diagonal whole) sums
    (w_i A_ij) A_ik over the panels' rows in order from 0 and is stored
    once; the rest of the output is left NaN."""
    B, m, n = A.shape
    acc = torch.zeros((B, n, n), dtype=A.dtype)
    for k in range(-(-m // P)):
        for i in range(k * P, min(m, (k + 1) * P)):
            acc = acc + (w[:, i, None] * A[:, i])[:, :, None] * A[:, i, None, :]
    out = torch.full_like(acc, float("nan"))
    for tr, tc in _upper_tiles(-(-n // TILE)):
        rows = slice(TILE * tr, min(n, TILE * tr + TILE))
        cols = slice(TILE * tc, min(n, TILE * tc + TILE))
        out[:, rows, cols] = acc[:, rows, cols]
    return out


def _twin_schur(A, w):
    """fused_palm_plain's streaming assembly loop (A'WA from 0)."""
    M = torch.zeros((A.shape[0], A.shape[2], A.shape[2]), dtype=A.dtype)
    for i in range(A.shape[1]):
        M = M + (w[:, i, None] * A[:, i])[:, :, None] * A[:, i, None, :]
    return M


@pytest.mark.parametrize("P", [1, 8, 24])
@pytest.mark.parametrize("n,m", [(16, 24), (20, 13), (44, 40)])
def test_panelled_upper_assembly_is_bit_identical(n, m, P):
    """n = 20 and 44 leave 4-wide edge tiles; m = 13 and 40 ragged last
    panels."""
    rng = np.random.default_rng(100 * n + m + P)
    A = torch.from_numpy(rng.standard_normal((2, m, n)).astype(np.float32))
    w = torch.from_numpy((rng.random((2, m)) + 0.5).astype(np.float32))
    w[:, ::3] = 0.0  # inactive rows, as the kernel's w = active * sigma
    got = _schur_panelled(A, w, P)
    want = _twin_schur(A, w)
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool))
    assert torch.equal(got[:, upper], want[:, upper])
    # the Gershgorin completion reads the upper triangle only
    assert torch.equal(F.gershgorin_completion(got),
                       F.gershgorin_completion(want))
    # and bounds the rows of A'WA as the reference's full-row sum does, to
    # rounding (A'WA is symmetric only to rounding)
    full = F._lane_sum(want.abs()).amax(1, keepdim=True)
    assert torch.allclose(F.gershgorin_completion(want), full, rtol=1e-5)


def _unpanelled_tier(n, m):
    """pick_tier before the staging panels: on chip as now, streaming when
    the vectors and the reduction scratch alone fit and n <= 352."""
    if F.fused_smem_bytes(n, m) <= SMEM_LIMIT:
        return "smem"
    if n <= F.STREAM_N_MAX and 4 * (18 * n + 19 * m + 192) <= SMEM_LIMIT:
        return "stream"
    return None


def test_pick_tier_admits_the_shapes_it_admitted():
    """Every padded shape up to n_pad 360 and m_pad 4000 (the streaming
    tier's vector limit is m_pad 2712 at n_pad 352) and every sweep row."""
    for n in range(8, 361, 8):
        for m in range(8, 4001, 8):
            assert F.pick_tier(n, m) == _unpanelled_tier(n, m), (n, m)
    for family, size in ROWS:
        Q, A = row_problems(family, size, batch=1)[0][:2]
        n, m = -(-Q.shape[0] // 8) * 8, -(-A.shape[0] // 8) * 8
        assert F.pick_tier(n, m) == _unpanelled_tier(n, m)
        if F.pick_tier(n, m) == "stream":
            # the sweep's streaming rows get the full panels
            P, b, _, nbytes = F.stream_plan(n, m)
            assert (P, b) == (F.STREAM_P_MAX, F.STREAM_B_MAX)
            assert nbytes <= SMEM_LIMIT


def test_stream_plan_overlaps_only_dead_scratch():
    """The staging region starts after the 15th m-vector, 16-byte aligned,
    and holds two mbarriers, the panels and 4 floats of slack."""
    for n, m in ((352, 352), (160, 160), (352, 2712), (140, 100), (8, 8)):
        P, b, stage, nbytes = F.stream_plan(n, m)
        assert stage % 4 == 0 and stage >= 18 * n + 15 * m
        assert P >= 1 and b >= F.STREAM_B_MIN and b % 8 == 0
        assert nbytes == 4 * max(18 * n + 19 * m + 192,
                                 stage + 8 + max(2 * P * n, b * n))
        assert nbytes <= SMEM_LIMIT


@pytest.mark.cuda
def test_cuda_stream_plan_mirror_matches_library():
    _cuda()
    import ctypes

    from qpalm_tpu_torch._build import kernels

    lib = kernels()
    out = (ctypes.c_int * 3)()
    for n in range(8, 361, 16):
        for m in (8, 100, 352, 528, 1000, 2712, 2800):
            lib.qp_fused_stream_plan(n, m, out)
            P, b, stage, nbytes = F.stream_plan(n, m)
            assert tuple(out) == (P, b, stage), (n, m)
            assert lib.qp_fused_stream_smem_bytes(n, m) == nbytes


@pytest.mark.cuda
@pytest.mark.parametrize("n", probe.SIZES)
def test_cuda_assembly_probe_matches_plain(n):
    _cuda()
    m = n * 3 // 2
    _, A, w = probe.probe_inputs(n, m, B=32, seed=n)
    got = probe.assembly_probe(A, w)
    want = probe.assembly_probe_plain(A, w)
    rel = ((got.double() - want.double()).abs().max()
           / want.double().abs().max().clamp(min=1.0)).item()
    assert rel < 1e-3
