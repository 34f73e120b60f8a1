"""K2's redesigned kernels (qpalm_tpu_torch/csrc/chol.cu), held on the CPU
by plain emulations of their schedules, and their plans:

  (a) the cluster factor (chol_cluster_kernel): the trailing upper triangle
      in CLUSTER_TILE x CLUSTER_TILE tiles of R dealt to C ranks by tile
      column, each rank's tiles enumerated as its threads take them, every
      panel of b rows gathered (from M for the first panel, else from R)
      and factored left-looking, then each rank's trailing tiles updated
      with the panel's products in row order: bit for bit
      cholesky_upper_plain, ragged tiles and last panels included, at f32
      and f64;
  (b) the f64 one-vector solve (chol_solve_warp_kernel): lanes owning
      entries t, t + 32, ..., every lane forming each step's numerator
      itself, forward in saxpy form and backward in column form: bit for
      bit cholesky_solve_plain;
  (c) the global solve (chol_solve_global_kernel): threads owning entries
      t, t + nt, ..., each loading its entries of R for step s + D at step
      s into a ring of D registers, every quotient written into its entry a
      step later, no thread writing an entry another reads in that step:
      bit for bit cholesky_solve_plain;
  (c') the wide solve past it (chol_solve_wide_kernel): the column in x's
      own column, R's diagonal through a ring, each thread's entries read
      and updated in chunks, the same late writes, entry 0 written last:
      bit for bit cholesky_solve_plain;
  (d) the plans: shapes, shared memory within SMEM_LIMIT for every n they
      admit, the wide plans past it (their scratch mirrored from the C
      side), and a ValueError only for a dtype no kernel takes.

On a card: a cluster launch the card refuses raising, and the next launch
running clean; the wide plans at the sizes the other plans do not take,
and the wide factor forced at n = 480 equal to the plan it replaces there,
each against the twin run on the card bit for bit; solve_batch at f64
randomQP n = 3640 through the wide factor (the factor and the solve of
the other plans against their twins are in test_torch_chol.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qpalm_tpu_torch.linalg import chol
from qpalm_tpu_torch.linalg.chol import (CLUSTER_TILE, cholesky_solve_plain,
                                         cholesky_upper_plain)

TILE = CLUSTER_TILE


def _spd(B, n, dtype, seed):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    return torch.from_numpy((G @ np.transpose(G, (0, 2, 1))
                             + n * np.eye(n)).astype(dtype))


def _own_tiles(q, rank, C, nb, nt):
    """The tiles (tr, tc) rank `rank` updates at a panel whose trailing
    tiles start at q, in the order its nt threads take them (own_tiles:
    thread g takes the g-th, (g + nt)-th, ... of its columns' tiles)."""
    flat = [(tr, tc) for tc in range(q + (rank - q) % C, nb, C)
            for tr in range(q, tc + 1)]
    return [flat[g] for t in range(nt) for g in range(t, len(flat), nt)]


def _chol_cluster(M, b, C, nt=chol.CLUSTER_THREADS):
    """chol_cluster_kernel on a batch, C ranks sharing R's tiles."""
    Bm, n, _ = M.shape
    nb = -(-n // TILE)
    pw = TILE * nb
    # R as the kernel sees it, padded to whole tiles (the pad is never
    # read: a ragged tile's entries past n are loaded as 0, not stored)
    Mp = torch.zeros((Bm, pw, pw), dtype=M.dtype)
    Mp[:, :n, :n] = M
    Rp = torch.full_like(Mp, float("nan"))
    for p in range(0, n, b):
        bb = min(b, n - p)
        src = Mp if p == 0 else Rp
        pan = torch.zeros((Bm, bb, pw), dtype=M.dtype)
        for r in range(bb):
            row = p + r
            c0 = TILE * max(p // TILE, row // TILE)
            pan[:, r, c0:n] = src[:, row, c0:n]
        for k in range(bb):
            c = p + k
            acc = pan[:, k, c:n].clone()
            for i in range(k):
                acc -= pan[:, i, c, None] * pan[:, i, c:n]
            akk = acc[:, 0].clone()
            inv = 1.0 / torch.sqrt(akk)
            pan[:, k, c + 1:n] = acc[:, 1:] * inv[:, None]
            pan[:, k, c] = akk * inv
        t0 = p + bb
        if t0 < n:
            seen = set()
            for rank in range(C):
                for tr, tc in _own_tiles(t0 // TILE, rank, C, nb, nt):
                    assert tc % C == rank and (tr, tc) not in seen
                    seen.add((tr, tc))
                    rs = slice(TILE * tr, min(TILE * tr + TILE, n))
                    cs = slice(TILE * tc, min(TILE * tc + TILE, n))
                    acc = src[:, rs, cs].clone()
                    a, cv = pan[:, :, rs], pan[:, :, cs]
                    for r in range(bb):
                        acc -= a[:, r, :, None] * cv[:, r, None, :]
                    Rp[:, rs, cs] = acc
            q = t0 // TILE
            assert seen == {(tr, tc) for tc in range(q, nb)
                            for tr in range(q, tc + 1)}
        Rp[:, p:p + bb, :n] = torch.triu(pan[:, :, :n], p)
    return Rp[:, :n, :n].contiguous()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,b,C", [(9, 8, 2), (37, 8, 4), (37, 32, 8),
                                   (171, 32, 2), (171, 8, 1),
                                   (242, 16, 4)])
def test_cluster_factor_order_is_bit_identical(n, b, C, dtype):
    """n = 9, 37, 171 and 242 leave ragged last tiles; b = 32 at n = 37
    and 171 a ragged last panel."""
    M = _spd(2, n, dtype, seed=n + b + C)
    want = cholesky_upper_plain(M)
    got = _chol_cluster(M, b, C)
    assert torch.equal(got, want)
    assert torch.isfinite(got).all()


def _solve_warp(R, bvec, lanes=32):
    """chol_solve_warp_kernel in scalar f64 steps: lane t owns entries t,
    t + 32, ...; every lane divides the step's numerator u, which it formed
    itself from the next entry as it stood before the step less the
    step's one term; the owners then update their entries, the owner of
    the next entry forming the same u."""
    x = bvec.copy()
    Bm, n = x.shape
    own = [list(range(t, n, lanes)) for t in range(lanes)]
    for m in range(Bm):
        v, Rm = x[m], R[m]
        u = v[0]
        for j in range(n):
            wn = v[j + 1] if j + 1 < n else 0.0
            yj = u / Rm[j, j]
            u = wn - yj * (Rm[j, j + 1] if j + 1 < n else 0.0)
            for ls in own:
                for l in ls:
                    if l > j:
                        v[l] = v[l] - yj * Rm[j, l]
            v[j] = yj
            assert j + 1 == n or u == v[j + 1]
        u = v[n - 1]
        for l in range(n - 1, -1, -1):
            yp = v[l - 1] if l > 0 else 0.0
            xl = u / Rm[l, l]
            u = yp - (Rm[l - 1, l] if l > 0 else 0.0) * xl
            for rs in own:
                for r in rs:
                    if r < l:
                        v[r] = v[r] - Rm[r, l] * xl
            v[l] = xl
            assert l == 0 or u == v[l - 1]
    return x


@pytest.mark.parametrize("n", [2, 10, 64])
def test_warp_solve_order_is_bit_identical(n):
    M = _spd(3, n, np.float64, seed=30 + n)
    R = cholesky_upper_plain(M)
    b = np.random.default_rng(31).standard_normal((3, n))
    want = cholesky_solve_plain(R, torch.from_numpy(b)).numpy()
    assert np.array_equal(_solve_warp(R.numpy(), b), want)


def _solve_global(R, b, nt, E, D):
    """chol_solve_global_kernel in scalar steps of R's precision, for each
    matrix and column of b (B, n, k): the combined steps s = 0..2n-1
    (forward j = s, backward l = 2n - 1 - s), thread t's entries t + nt e,
    its ring slot s % D refilled at step s with step s + D's entries of R.
    Every write is asserted to be by the entry's owner and not to the
    entry that the step reads."""
    f = R.dtype.type
    Bm, n, k = b.shape
    x = np.empty_like(b)

    def fetch(Rm, t, s):
        out = np.zeros(E, f)
        for e in range(E):
            i = t + nt * e
            if s < n and s < i < n:
                out[e] = Rm[s, i]
            elif s >= n and i < 2 * n - 1 - s:
                out[e] = Rm[i, 2 * n - 1 - s]
        return out

    for m in range(Bm):
        Rm, dg = R[m], np.diag(R[m]).copy()
        for c in range(k):
            v = b[m, :, c].copy()
            ring = [[fetch(Rm, t, d) for d in range(D)] for t in range(nt)]
            prev = f(0)
            for s in range(2 * n):
                fwd = s < n
                read = s if fwd else 2 * n - 1 - s
                q = f((prev if s == n else v[read]) / dg[read])
                for t in range(nt):
                    for e in range(E):
                        i, r = t + nt * e, ring[t][s % D][e]
                        if fwd and s < i < n:
                            new = f(v[i] - f(q * r))
                        elif not fwd and i < read:
                            new = f(v[i] - f(r * q))
                        elif i == (s - 1 if fwd else read + 1) and s != n:
                            new = prev
                        else:
                            continue
                        assert i < n and i % nt == t and i != read
                        v[i] = new
                    ring[t][s % D] = fetch(Rm, t, s + D)
                prev = q
            x[m, :, c] = v
            x[m, 0, c] = prev
    return x


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,nt,E,D", [(1, 32, 1, 8), (2, 1, 2, 1),
                                      (9, 4, 4, 3), (37, 4, 16, 8),
                                      (64, 16, 4, 8), (64, 32, 2, 5)])
def test_global_solve_order_is_bit_identical(n, nt, E, D, dtype):
    """Ragged ownership (n < nt E), rings deeper than the solve and depths
    that do not divide n."""
    M = _spd(2, n, dtype, seed=40 + n)
    R = cholesky_upper_plain(M)
    b = np.random.default_rng(41).standard_normal((2, n, 2)).astype(dtype)
    b[1, :, 1] = np.eye(n, dtype=dtype)[:, n // 2]  # an identity column
    want = cholesky_solve_plain(R, torch.from_numpy(b)).numpy()
    assert np.array_equal(_solve_global(R.numpy(), b, nt, E, D), want)


def _solve_wide(R, b, nt, W, D, in_x):
    """chol_solve_wide_kernel in scalar steps of R's precision, for each
    matrix and column of b (B, n, k): the column lives in x's own column
    (`in_x`: x starts as b's) or beside it (written to x at the end), R's
    diagonal comes through a ring of D slots filled D steps ahead, thread
    t's entries t + nt w are read in chunks of W (every load of a chunk
    before its updates) and updated, entries past the backward step's last
    one skipped.  Every write is asserted to be by the entry's owner, not
    to the entry the step reads, and the step's quotient to land in its
    entry one step later (entry 0 after the last step)."""
    f = R.dtype.type
    Bm, n, k = b.shape
    x = b.copy() if in_x else np.full_like(b, np.nan)

    def diag(Rm, s):
        i = s if s < n else 2 * n - 1 - s
        return Rm[i, i] if i >= 0 else f(0)

    for m in range(Bm):
        Rm = R[m]
        for c in range(k):
            # a view where the kernel works in x's column
            v = x[m, :, c] if in_x else b[m, :, c].copy()
            ring = [diag(Rm, d) for d in range(D)]
            prev, quot = f(0), {}
            for s in range(2 * n):
                fwd = s < n
                read = s if fwd else 2 * n - 1 - s
                q = f((prev if s == n else v[read]) / ring[s % D])
                late = -1 if s == n else (s - 1 if fwd else read + 1)
                hi = n if fwd else min(n, read + 2)
                for t in range(nt):
                    for l0 in range(t, hi, nt * W):
                        ls = [l0 + nt * w for w in range(W)]
                        upd = [(i > read and i < n) if fwd else i < read
                               for i in ls]
                        got = [(Rm[read, i] if fwd else Rm[i, read],
                                v[i]) if u else (f(0), f(0))
                               for i, u in zip(ls, upd)]
                        for i, u, (r, vi) in zip(ls, upd, got):
                            if u:
                                new = f(vi - f(q * r)) if fwd \
                                    else f(vi - f(r * q))
                            elif i == late:
                                assert quot[i] == prev
                                assert s == (i + 1 if fwd else 2 * n - i)
                                new = prev
                            else:
                                continue
                            assert i < n and i % nt == t and i != read
                            v[i] = new
                ring[s % D] = diag(Rm, s + D)
                quot[read] = q
                prev = q
            v[0] = prev
            x[m, :, c] = v
    return x


@pytest.mark.parametrize("in_x", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,nt,W,D", [(1, 32, 8, 8), (2, 1, 1, 1),
                                      (9, 4, 2, 3), (37, 4, 8, 8),
                                      (64, 16, 8, 8), (64, 32, 2, 5),
                                      (70, 8, 4, 8)])
def test_wide_solve_order_is_bit_identical(n, nt, W, D, dtype, in_x):
    """Ragged ownership, several chunks a thread, rings deeper than the
    solve and depths that do not divide n; one and two columns, one of
    them an identity column; the column in shared memory and in x's."""
    M = _spd(2, n, dtype, seed=50 + n)
    R = cholesky_upper_plain(M)
    b = np.random.default_rng(51).standard_normal((2, n, 2)).astype(dtype)
    b[1, :, 1] = np.eye(n, dtype=dtype)[:, n // 2]
    want = cholesky_solve_plain(R, torch.from_numpy(b)).numpy()
    assert np.array_equal(_solve_wide(R.numpy(), b, nt, W, D, in_x), want)
    assert np.array_equal(
        _solve_wide(R.numpy(), b[:, :, :1].copy(), nt, W, D, in_x),
        want[:, :, :1])


_CHOL_CU = Path(chol.__file__).resolve().parent.parent / "csrc" / "chol.cu"


def test_global_solve_shape_mirrors_the_launcher():
    """chol.py's limits are csrc/chol.cu's, and the launcher instantiates
    every E that global_solve_shape can pick (1 to GS_E_MAX, powers of
    two)."""
    src = _CHOL_CU.read_text()
    for name in ("GS_THREADS_MAX", "GS_E_MAX", "GS_ENTRY_BYTES"):
        hit = re.search(rf"\b{name} = (\d+)", src)
        assert hit and int(hit.group(1)) == getattr(chol, name), name
    body = src[src.index("int launch_solve_global("):]
    body = body[:body.index("\n}\n")]
    cases = {chol.GS_E_MAX if e == "GS_E_MAX" else int(e)
             for e in re.findall(r"launch_gs<T, (\w+)>", body)}
    assert cases == {1 << i for i in range(chol.GS_E_MAX.bit_length())}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_global_solve_shape_fits_every_n(dtype):
    """Every n up to 8192: threads a multiple of 32 up to GS_THREADS_MAX,
    an E that the launcher instantiates (1 to GS_E_MAX, powers of two),
    the fewest such, more than GS_ENTRY_BYTES of R a thread only at
    GS_THREADS_MAX threads (the kernel takes the block size as a constant
    there), and the column and diagonal within SMEM_LIMIT wherever the
    plan is global, for one right-hand side and for several."""
    es = 4 if dtype == torch.float32 else 8
    for n in range(1, 8193):
        nt, E = chol.global_solve_shape(n, dtype)
        assert nt % 32 == 0 and 32 <= nt <= chol.GS_THREADS_MAX
        assert E in (1, 2, 4, 8, 16, 32) and E * nt >= n
        assert E == 1 or E * nt < 2 * n
        assert E * es <= chol.GS_ENTRY_BYTES or nt == chol.GS_THREADS_MAX
        for k in (1, 2, n):
            if chol.solve_plan(64, n, k, dtype)[0] == "global":
                assert 2 * n * es <= chol.SMEM_LIMIT
    # the shape the general loop (and the polish, f32) launch at n = 480
    assert chol.global_solve_shape(480, dtype) == ((256, 2) if es == 4
                                                   else (480, 1))


def test_global_solve_takes_n_up_to_its_largest_e():
    """The global plan takes n up to its largest E (f32 16384), or while
    its two vectors fit shared memory (f64 14528); past either the wide
    plan takes every n, one column or several, under its own name.  Only
    a dtype no kernel takes raises."""
    assert chol.solve_plan(1, chol.GS_N_MAX, 1, torch.float32)[0] == "global"
    assert chol.global_solve_shape(chol.GS_N_MAX, torch.float32) == (512, 32)
    assert chol.solve_plan(1, 14528, 1, torch.float64)[0] == "global"
    for n, dtype in ((chol.GS_N_MAX + 1, torch.float32), (16392,
                                                          torch.float32),
                     (29056, torch.float32), (14529, torch.float64),
                     (14536, torch.float64), (10 ** 6, torch.float64)):
        for k in (1, 2, n):
            assert chol.solve_plan(64, n, k, dtype) == ("wide", 1)
            assert chol.solve_kernel("wide", k, dtype) == (
                "chol_solve_global_wide" if dtype == torch.float32
                else "chol_solve_global_wide_f64")
    for n in (1, 480, 10 ** 6):
        with pytest.raises(ValueError, match="no kernel takes"):
            chol.solve_plan(1, n, 1, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 8, 64, 200])
def test_global_plan_fits_every_n_it_admits(B, dtype):
    """Every n past the shared-memory factor up to 1024: a cluster of 1, 2,
    4 or 8 CTAs, the largest with B C <= 132 (1 past 132 matrices), panels
    of 32 rows where they fit, else 16 or 8, shared memory within
    SMEM_LIMIT."""
    es = 4 if dtype == torch.float32 else 8
    for n in range(1, 1025):
        if chol.factor_plan(n, dtype) != "global":
            continue
        p = chol.global_plan(B, n, dtype, sms=132)
        assert p.panel == "smem"
        assert chol.panel_scratch_bytes(B, n, dtype, p) == 0
        assert p.cluster == max(c for c in (1, 2, 4, 8)
                                if c == 1 or B * c <= 132)
        smem = chol.global_smem_bytes(n, dtype, p.b)
        assert smem == es * p.b * TILE * -(-n // TILE) <= chol.SMEM_LIMIT
        assert p.b == 32 or chol.global_smem_bytes(
            n, dtype, 2 * p.b) > chol.SMEM_LIMIT


@pytest.mark.parametrize("q,nb,C", [(0, 1, 1), (0, 7, 2), (3, 31, 4),
                                    (1, 60, 8), (59, 61, 8)])
def test_own_tiles_deal_each_trailing_tile_once(q, nb, C):
    """The ranks' tiles of the trailing triangle (own_tiles): each in the
    rank of its tile column, every tile of rows and columns q.. once."""
    got = [(r, t) for r in range(C)
           for t in _own_tiles(q, r, C, nb, chol.CLUSTER_THREADS)]
    assert all(tc % C == r for r, (tr, tc) in got)
    tiles = [t for _, t in got]
    assert sorted(tiles) == sorted((tr, tc) for tc in range(q, nb)
                                   for tr in range(q, tc + 1))


@pytest.mark.parametrize("B,n,dtype,want", [
    (64, 480, torch.float32, (2, 32, "smem")),
    (64, 480, torch.float64, (2, 32, "smem")),
    (128, 224, torch.float64, (1, 32, "smem")),
    (64, 300, torch.float32, (2, 32, "smem")),
    (64, 171, torch.float64, (2, 32, "smem")),
    (8, 480, torch.float64, (8, 32, "smem")),
    (200, 1024, torch.float64, (1, 16, "smem")),
    (1, 3640, torch.float64, (8, chol.WIDE_B, "global")),
    (2, 3640, torch.float64, (8, chol.WIDE_B, "global")),
    (1, 7272, torch.float32, (8, chol.WIDE_B, "global"))])
def test_global_plan_choices(B, n, dtype, want):
    """The general loop's randomQP n=480 at B = 64, at f32 and f64, is the
    shape tools/chol_plans.py measured fastest (PERF.md); the others follow
    the same rule, the wide plan's panels in a global scratch."""
    assert tuple(chol.global_plan(B, n, dtype, sms=132)) == want


def test_global_plan_raises_where_nothing_fits():
    """Past the last n whose panel of 8 rows fits a CTA (f64 3632, f32
    7264) the wide plan takes the factor, its scratch a panel of WIDE_B
    rows a CTA (csrc/chol.cu, cluster_smem_bytes, CTA i's at byte i times
    that); only a dtype fits no plan."""
    assert chol.global_plan(1, 3632, torch.float64) == (8, 8, "smem")
    assert chol.global_plan(1, 7264, torch.float32) == (8, 8, "smem")
    assert chol.factor_plan(3632, torch.float64) == "global"
    assert chol.factor_plan(7264, torch.float32) == "global"
    for n, dtype in ((3633, torch.float64), (7265, torch.float32),
                     (3640, torch.float64), (7272, torch.float32),
                     (50000, torch.float64)):
        es = 4 if dtype == torch.float32 else 8
        assert chol.factor_plan(n, dtype) == "wide"
        for B in (1, 2, 64):
            p = chol.global_plan(B, n, dtype)
            assert p.panel == "global" and p.b == chol.WIDE_B
            panel = es * p.b * TILE * -(-n // TILE)
            assert chol.global_smem_bytes(n, dtype, p.b) == panel
            assert chol.panel_scratch_bytes(B, n, dtype, p) == \
                B * p.cluster * panel
        assert chol.KERNELS["factor", "wide", dtype] == (
            "chol_global_wide" if es == 4 else "chol_global_wide_f64")
    for n in (480, 3640):
        with pytest.raises(ValueError, match="no kernel takes"):
            chol.global_plan(1, n, torch.float16)
        with pytest.raises(ValueError, match="no kernel takes"):
            chol.factor_plan(n, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_factor_plans_meet_where_the_panel_leaves_shared_memory(dtype):
    """factor_plan says "wide" exactly where global_plan puts the panels in
    a global scratch, and a panel in shared memory always fits a CTA."""
    last = 3632 if dtype == torch.float64 else 7264
    for n in range(last - 40, last + 41):
        plan, p = chol.factor_plan(n, dtype), chol.global_plan(64, n, dtype)
        assert (plan == "wide") == (p.panel == "global") == (n > last)
        if p.panel == "smem":
            assert chol.global_smem_bytes(n, dtype, p.b) <= chol.SMEM_LIMIT


def test_wide_plans_mirror_the_c_side():
    """The C side's panel size and offsets are the ones chol.py allocates
    (panel_scratch_bytes), its wide solve's threads a block a multiple of
    32, and every new entry point's signature is bound."""
    from qpalm_tpu_torch import _build

    src = _CHOL_CU.read_text()
    assert "return (size_t)b * ((n + CTILE - 1) / CTILE) * CTILE * es;" in src
    assert "pan = GPAN ? gpan + (size_t)blockIdx.x * b * pw" in src
    assert "const int nb = (n + CTILE - 1) / CTILE, pw = CTILE * nb;" in src
    hit = re.search(r"\bCTILE = (\d+)", src)
    assert hit and int(hit.group(1)) == TILE
    hit = re.search(r"GW_THREADS = (\d+), GW_CHUNK = (\d+)", src)
    assert hit and int(hit.group(1)) % 32 == 0 and int(hit.group(2)) >= 1
    # the wide solve's column in shared memory while n elements fit
    body = src[src.index("int launch_solve_wide("):]
    assert f"if (smem > {chol.SMEM_LIMIT})" in body[:body.index("\n}\n")]
    assert len(_build._SIGNATURES["qp_chol_global"]) == 10
    assert len(_build._SIGNATURES["qp_chol_solve_wide"]) == 8


def test_warp_plan_takes_f64_one_vector_of_even_n():
    for n in range(1, 200):
        plan = chol.solve_plan(512, n, 1, torch.float64)[0]
        fits = (n % 2 == 0 and n <= chol.WARP_N_MAX
                and chol.warp_smem_bytes(n) <= chol.SMEM_LIMIT)
        assert (plan == "warp") == fits, n
        assert chol.solve_plan(512, n, 2, torch.float64)[0] != "warp"
        assert chol.solve_plan(512, n, 1, torch.float32)[0] != "warp"


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_cuda_refused_cluster_shape_raises():
    """A shape the entry point does not take (a cluster of 16, a panel of
    12 rows) raises before any launch; a shape it takes but the card
    refuses (2^31 CTAs, past the grid's limit) raises from the cluster
    launch itself, which leaves no error behind: the next launch runs
    clean.  Nothing runs in their place."""
    _cuda()
    from qpalm_tpu_torch._build import check_launch, kernels

    M = _spd(2, 300, np.float32, seed=1).cuda()
    R = torch.zeros_like(M)
    for plan in (chol.GlobalPlan(16, 32), chol.GlobalPlan(2, 12)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            check_launch("qp_chol_global", chol._launch_global(M, R, plan))
    with pytest.raises(RuntimeError, match="CUDA error"):
        check_launch("qp_chol_global", kernels().qp_chol_global(
            M.data_ptr(), R.data_ptr(), 2 ** 30, 300, 0, 2, 32, None, None,
            torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    assert not R.any()
    check_launch("qp_chol_global",
                 chol._launch_global(M, R, chol.global_plan(2, 300,
                                                            M.dtype)))
    torch.cuda.synchronize()
    assert torch.equal(R, cholesky_upper_plain(M))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,dtype", [(1, 3640, torch.float64),
                                       (2, 3640, torch.float64),
                                       (1, 7272, torch.float32)])
def test_cuda_wide_factor_is_bit_identical_to_plain(B, n, dtype):
    """The sizes past a CTA's panel of 8 rows: the wide plan, counted
    under its own name, bit for bit the twin run on the card."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(60 + B)
    G = torch.randn((B, n, n), generator=g, device="cuda", dtype=dtype)
    M = G @ G.transpose(1, 2) + n * torch.eye(n, device="cuda", dtype=dtype)
    del G
    assert chol.factor_plan(n, dtype) == "wide"
    name = chol.KERNELS["factor", "wide", dtype]
    before = chol.KERNEL_LAUNCHES[name]
    R = chol.cholesky_upper(M)
    assert chol.KERNEL_LAUNCHES[name] == before + 1
    assert torch.equal(R, cholesky_upper_plain(M))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_wide_factor_forced_equals_todays_plan(dtype):
    """At the general loop's (64, 480, 480) the wide plan, forced, gives
    the bits of the plan it replaces there (and of the twin)."""
    _cuda()
    M = _spd(64, 480, dtype, seed=61).cuda()
    today = chol.global_plan(64, 480, M.dtype)
    assert today.panel == "smem"
    R0, R1 = torch.empty_like(M), torch.empty_like(M)
    for R, plan in ((R0, today), (R1, today._replace(panel="global"))):
        assert chol._launch_global(M, R, plan) == 0
    torch.cuda.synchronize()
    assert torch.equal(R1, R0)
    assert torch.equal(R0, cholesky_upper_plain(M))


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype,k", [
    (14536, torch.float64, 1), (14536, torch.float64, 2),
    (16392, torch.float32, 1), (16392, torch.float32, 2),
    (29064, torch.float64, 1)])
def test_cuda_wide_solve_is_bit_identical_to_plain(n, dtype, k):
    """Past the global solve's shared vectors (f64) and its ring's entries
    (f32): the wide plan, bit for bit the twin run on the card, the column
    in shared memory, and past it (f64 n > 29056) in x's; R a random upper
    triangle with a dominant diagonal (no factor that large)."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(62 + k)
    R = torch.triu(torch.rand((1, n, n), generator=g, device="cuda",
                              dtype=dtype) - 0.5)
    R.diagonal(dim1=1, dim2=2).fill_(n)
    shape = (1, n) if k == 1 else (1, n, k)
    b = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    assert chol.solve_plan(1, n, k, dtype) == ("wide", 1)
    name = chol.solve_kernel("wide", k, dtype)
    before = chol.KERNEL_LAUNCHES[name]
    x = chol.cholesky_solve(R, b)
    assert chol.KERNEL_LAUNCHES[name] == before + 1
    assert torch.equal(x, cholesky_solve_plain(R, b))


@pytest.mark.cuda
def test_cuda_solve_batch_f64_runs_past_the_shared_panel():
    """solve_batch at the default Settings() (f64) on randomQP n = 3640
    (m = n): n_pad 3640 is past the last n whose panel fits a CTA, so the
    general loop factors through the wide plan; the lane is solved and
    the f64 referee holds its KKT residuals within the settings' eps."""
    _cuda()
    from qpalm_tpu_torch import referee
    from qpalm_tpu_torch.batch import solve_batch, stack_problems
    from qpalm_tpu_torch.types import QPData, Settings
    from qpalm_tpu_torch.workloads import random_qp

    s = Settings()
    probs = [random_qp(3640)]
    chol.KERNEL_LAUNCHES.clear()
    res = solve_batch(probs, s, device="cuda")
    assert chol.KERNEL_LAUNCHES["chol_global_wide_f64"] > 0
    assert int(res.status[0]) == 1
    d64 = QPData(*(a.numpy() for a in stack_problems(probs, np.float64)))
    viol = referee.check(*d64, res.x.cpu().numpy(), res.y.cpu().numpy(),
                         s.eps_abs, s.eps_rel)[0]
    assert viol[0] <= 1.0
