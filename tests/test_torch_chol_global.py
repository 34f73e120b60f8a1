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
  (b) the f64 warp solve (chol_solve_warp_kernel): a warp a column, lanes
      owning entries t, t + 32, ..., every lane forming each step's
      numerator itself, forward in saxpy form and backward in column form:
      bit for bit cholesky_solve_plain, at odd n and several columns too;
      its staging of R (row copies, or one span with a ragged first and
      last entry) covering each entry once inside its matrix;
  (c) the global solve (chol_solve_global_kernel): threads owning entries
      t, t + nt, ..., each loading its entries of R for step s + D at step
      s into a ring of D registers, every quotient written into its entry a
      step later, no thread writing an entry another reads in that step:
      bit for bit cholesky_solve_plain;
  (c') the stripe solve (chol_solve_stripe_kernel): a CTA a stripe of w
      entries of a column, drawn from a ticket, the CTAs interleaved in a
      seeded order with few resident, each waiting on the flags of the
      stripes it reads, tiles zero-padded past n, the diagonal block by
      the warp's order: bit for bit cholesky_solve_plain, no published
      entry read before its flag, no deadlock;
  (c'') the grid factor (chol_grid_kernel): G CTAs shared out over the
      matrices, every CTA's left-looking diagonal triangle, each rank's
      slice of the panel rows, the trailing triangle's blocks of tiles
      dealt round robin (each tile once a panel): bit for bit
      cholesky_upper_plain, ragged tiles and panels, rounds of matrices;
  (d) the plans: shapes, shared memory within SMEM_LIMIT for every n they
      admit, the grid factor and the stripe solve past them and where they
      were measured faster, the C side's mirrors, and a ValueError only
      for a dtype no kernel takes.

On a card: a cluster launch and a cooperative launch the card refuses
raising, and the next launch running clean; the wide plans at the sizes
the other plans do not take, and the grid factor forced at n = 480 equal
to the plan it replaces there, each against the twin run on the card bit
for bit; solve_batch at f64 randomQP n = 3640 through the grid factor (the
factor and the solve of the other plans against their twins are in test_torch_chol.py)."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qpalm_tpu_torch._build import check_launch
from qpalm_tpu_torch.linalg import chol
from qpalm_tpu_torch.linalg.chol import (CLUSTER_TILE, cholesky_solve_plain,
                                         cholesky_upper_plain)
from torch_support import _cuda

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


def _solve_stripe(R, b, w, seed):
    """chol_solve_stripe_kernel's two launches in scalar steps of R's
    precision, for R (B, n, n) and b (B, n, k): a CTA for each (matrix,
    column, stripe of w entries), at most `slots` of them resident (drawn
    with the interleaving from a seeded rng), each drawing its stripe from
    its column's ticket when it starts and yielding wherever the kernel
    waits on a flag.  A tile is w x w with entries past n zero-filled;
    forward stripe s applies tiles p = 0..s-1 (w_l -= y_j R_jl, j
    ascending), backward tiles p = S-1..s+1 (y_r -= R_rk x_k, k descending,
    the tile's padding first), each after stripe p's flag; then its
    diagonal block as the warp does it (every lane forming the next
    numerator itself, asserted equal to the owner's).  Every read of a
    published entry is asserted to come after that entry's stripe set its
    flag in this pass; a deadlock fails."""
    f = R.dtype.type
    Bm, n, k = b.shape
    S = -(-n // w)
    rng = np.random.default_rng(seed)
    x = np.full_like(b, np.nan)
    published = [set(), set()]  # (m, c, entry) by pass

    def tile(Rm, row0, nrows, col0, ncols):
        t = np.zeros((w, w), R.dtype)
        t[:nrows, :ncols] = Rm[row0:row0 + nrows, col0:col0 + ncols]
        return t

    def cta(m, c, bwd, ticket, flag):
        s = ticket[m, c]
        ticket[m, c] += 1
        if bwd:
            s = S - 1 - s
        r0, Rm = s * w, R[m]
        ns = min(w, n - r0)
        if bwd:
            assert all((m, c, r0 + t) in published[0] for t in range(ns))
        v = [(x[m, r0 + t, c] if bwd else b[m, r0 + t, c]) if t < ns
             else f(0) for t in range(w)]
        nt = S - 1 - s if bwd else s
        for it in range(nt):
            p = S - 1 - it if bwd else it
            pw = min(w, n - p * w)
            while not flag[m, c, p]:
                yield m, c, p
            assert all((m, c, p * w + t) in published[bwd]
                       for t in range(pw))
            ys = [x[m, p * w + t, c] if t < pw else f(0) for t in range(w)]
            if bwd:
                tl = tile(Rm, r0, ns, p * w, pw)
                for t in range(w):
                    for kk in range(w - 1, -1, -1):
                        v[t] = f(v[t] - f(tl[t, kk] * ys[kk]))
            else:
                tl = tile(Rm, p * w, pw, r0, ns)
                for t in range(w):
                    for j in range(w):
                        v[t] = f(v[t] - f(ys[j] * tl[j, t]))
            yield
        D = Rm[r0:r0 + ns, r0:r0 + ns]
        e = v[:ns]
        if not bwd:
            u = e[0]
            for j in range(ns):
                wn = e[j + 1] if j + 1 < ns else f(0)
                yj = f(u / D[j, j])
                u = f(wn - f(yj * (D[j, j + 1] if j + 1 < ns else f(0))))
                for l in range(j + 1, ns):
                    e[l] = f(e[l] - f(yj * D[j, l]))
                e[j] = yj
                assert j + 1 == ns or u == e[j + 1]
        else:
            u = e[ns - 1]
            for l in range(ns - 1, -1, -1):
                yp = e[l - 1] if l > 0 else f(0)
                xl = f(u / D[l, l])
                u = f(yp - f((D[l - 1, l] if l > 0 else f(0)) * xl))
                for r in range(l):
                    e[r] = f(e[r] - f(D[r, l] * xl))
                e[l] = xl
                assert l == 0 or u == e[l - 1]
        for t in range(ns):
            x[m, r0 + t, c] = e[t]
            published[bwd].add((m, c, r0 + t))
        flag[m, c, s] = True

    for bwd in (0, 1):
        ticket = {(m, c): 0 for m in range(Bm) for c in range(k)}
        flag = {(m, c, s): False for m in range(Bm) for c in range(k)
                for s in range(S)}
        # the launch's CTAs in an order the card might start them; a CTA
        # yields the flag it waits on (None where it only lets others run)
        pending = [(m, c) for m in range(Bm) for c in range(k)
                   for _ in range(S)]
        rng.shuffle(pending)
        slots = int(rng.integers(1, 4))
        waits = {}
        while pending or waits:
            ready = [g for g, key in waits.items()
                     if key is None or flag[key]]
            start = bool(pending) and len(waits) < slots
            assert ready or start, "deadlock"
            if start and (not ready or rng.random() < 0.5):
                g = cta(*pending.pop(), bwd, ticket, flag)
            else:
                g = ready[int(rng.integers(len(ready)))]
            try:
                waits[g] = next(g)
            except StopIteration:
                waits.pop(g, None)
    return x


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("w", [4, 8, 16])
@pytest.mark.parametrize("n", [1, 9, 37, 70])
def test_stripe_solve_order_is_bit_identical(n, w, dtype):
    """Ragged last stripes, CTAs interleaved in a seeded order with one to
    three resident, one and two columns (one an identity column): bit for
    bit cholesky_solve_plain, no published entry read before its flag."""
    M = _spd(2, n, dtype, seed=50 + n)
    R = cholesky_upper_plain(M)
    b = np.random.default_rng(51).standard_normal((2, n, 2)).astype(dtype)
    b[1, :, 1] = np.eye(n, dtype=dtype)[:, n // 2]
    want = cholesky_solve_plain(R, torch.from_numpy(b)).numpy()
    assert np.array_equal(_solve_stripe(R.numpy(), b, w, seed=n + w), want)
    assert np.array_equal(
        _solve_stripe(R.numpy(), b[:, :, :1].copy(), w, seed=n * w),
        want[:, :, :1])


GRID_TB = 16  # csrc/chol.cu: a block of the trailing update, in tiles


def _tri_tile(f):
    """csrc/chol.cu:tri_tile: column-major position f of an upper triangle
    -> (row i, column j), i <= j."""
    j = int((math.sqrt(8.0 * f + 1.0) - 1.0) * 0.5)
    while j * (j + 1) // 2 > f:
        j -= 1
    while (j + 1) * (j + 2) // 2 <= f:
        j += 1
    return f - j * (j + 1) // 2, j


def _grid_tiles(q, nb, per):
    """The tiles (tr, tc) each rank of a matrix's per CTAs updates in the
    trailing step whose tiles start at q, in chol_grid_kernel's dealing:
    blocks of GRID_TB x GRID_TB tiles, column by column, block f to rank f
    % per, thread t of GRID_TB^2 taking tile (t / GRID_TB, t % GRID_TB) of
    the block where it lies in the upper triangle."""
    nbk = -(-(nb - q) // GRID_TB)
    out = {rank: [] for rank in range(per)}
    for rank in range(per):
        for f in range(rank, nbk * (nbk + 1) // 2, per):
            bi, bj = _tri_tile(f)
            for t in range(GRID_TB * GRID_TB):
                tr = q + GRID_TB * bi + t // GRID_TB
                tc = q + GRID_TB * bj + t % GRID_TB
                if tr <= tc < nb:
                    out[rank].append((tr, tc))
    return out


def _chol_grid(M, b, G):
    """chol_grid_kernel on a batch, G CTAs shared out over its B matrices
    (groups = min(B, G) of per = G // groups, a round of matrices a group
    at a time), panels of b rows: every CTA factors the diagonal triangle
    left-looking (entry (k, c) less R_ik R_ic for i < k in turn, then times
    1 / sqrt of the pivot); rank r computes the panel rows at its
    contiguous slice of the columns right of it, right-looking in the
    column (each asserted to be one rank's); after the barrier the
    trailing triangle loses the panel's b products in row order, its tiles
    dealt as _grid_tiles deals them (each asserted dealt once); rank 0
    writes the triangle, zeros below and left of it."""
    Bm, n, _ = M.shape
    groups = min(Bm, G)
    per = G // groups
    nb = -(-n // TILE)
    R = torch.full_like(M, float("nan"))
    for m0 in range(0, Bm, groups):
        ms = slice(m0, min(Bm, m0 + groups))
        Mm, Rm = M[ms], R[ms]
        for p in range(0, n, b):
            bb = min(b, n - p)
            t0 = p + bb
            src = Mm if p == 0 else Rm
            tri = src[:, p:t0, p:t0].clone()
            invs = torch.empty_like(tri[:, 0])
            for k in range(bb):
                a = tri[:, k, k:].clone()
                for i in range(k):
                    a -= tri[:, i, k, None] * tri[:, i, k:]
                inv = 1.0 / torch.sqrt(a[:, 0])
                tri[:, k, k:] = a * inv[:, None]
                invs[:, k] = inv
            ncols = n - t0
            chunk = -(-ncols // per)
            cols = []
            for rank in range(per):
                lo, hi = t0 + rank * chunk, min(n, t0 + (rank + 1) * chunk)
                if lo >= hi:
                    continue
                cols += range(lo, hi)
                acc = src[:, p:t0, lo:hi].clone()
                for k in range(bb):
                    acc[:, k] *= invs[:, k, None]
                    for j in range(k + 1, bb):
                        acc[:, j] -= tri[:, k, j, None] * acc[:, k]
                Rm[:, p:t0, lo:hi] = acc
            assert cols == list(range(t0, n))
            Rm[:, p:t0, p:t0] = torch.triu(tri)
            Rm[:, p:t0, :p] = 0
            if t0 < n:
                q = t0 // TILE
                dealt = [t for ts in _grid_tiles(q, nb, per).values()
                         for t in ts]
                assert sorted(dealt) == [(tr, tc) for tr in range(q, nb)
                                         for tc in range(tr, nb)]
                P = Rm[:, p:t0, t0:]
                W = src[:, t0:, t0:].clone()
                for r in range(bb):
                    W -= P[:, r, :, None] * P[:, r, None, :]
                Rm[:, t0:, t0:] = W
        R[ms] = Rm
    return torch.triu(R)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("b", [8, 16, 32])
@pytest.mark.parametrize("G,B", [(1, 1), (3, 1), (8, 1)])
def test_grid_factor_order_is_bit_identical(G, B, b, dtype):
    """n = 70: a ragged last tile and (b = 16, 32) a ragged last panel; G
    = 3 and 8 CTAs do not divide the slices' columns or the tiles: bit for
    bit cholesky_upper_plain."""
    M = _spd(B, 70, dtype, seed=70 + G + b)
    got = _chol_grid(M, b, G)
    assert torch.equal(got, cholesky_upper_plain(M))


@pytest.mark.parametrize("B,G,n", [(3, 2, 37), (2, 8, 130), (5, 3, 9)])
def test_grid_factor_rounds_are_bit_identical(B, G, n):
    """More matrices than groups (rounds), groups of several CTAs a
    matrix, a matrix of one tile."""
    M = _spd(B, n, np.float64, seed=B + G + n)
    assert torch.equal(_chol_grid(M, 32, G), cholesky_upper_plain(M))


@pytest.mark.parametrize("q,nb,per", [(0, 1, 1), (0, 17, 3), (4, 455, 132),
                                      (40, 455, 66), (30, 60, 7),
                                      (200, 909, 132)])
def test_grid_deals_each_trailing_tile_once(q, nb, per):
    """Every tile of rows and columns q.. of the trailing triangle goes to
    exactly one rank, block f to rank f % per."""
    got = _grid_tiles(q, nb, per)
    tiles = [t for ts in got.values() for t in ts]
    assert len(tiles) == len(set(tiles))
    assert set(tiles) == {(tr, tc) for tr in range(q, nb)
                          for tc in range(tr, nb)}


def test_tri_tile_inverts_the_column_major_numbering():
    """csrc/chol.cu:tri_tile (mirrored in _tri_tile) gives back (i, j) of
    f = j (j + 1) / 2 + i, i <= j, across the sizes the kernel meets."""
    for j in list(range(300)) + [4095, 4096, 100000]:
        for i in {0, j // 2, j}:
            assert _tri_tile(j * (j + 1) // 2 + i) == (i, j)


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
    its two vectors fit shared memory (f64 14528), for more than
    STRIPE_BK_MAX columns in all; past either the wide plan (the stripe
    solve) takes every n, one column or several, under its own name.  Only
    a dtype no kernel takes raises."""
    assert chol.solve_plan(64, chol.GS_N_MAX, 1, torch.float32)[0] == \
        "global"
    assert chol.global_solve_shape(chol.GS_N_MAX, torch.float32) == (512, 32)
    assert chol.solve_plan(64, 14528, 1, torch.float64)[0] == "global"
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
    SMEM_LIMIT; the grid factor for at most GRID_B_MAX matrices from
    GRID_N_MIN on."""
    es = 4 if dtype == torch.float32 else 8
    for n in range(1, 1025):
        if chol.factor_plan(n, dtype) != "global":
            continue
        p = chol.global_plan(B, n, dtype, sms=132)
        if B <= chol.GRID_B_MAX and n >= chol.GRID_N_MIN[dtype]:
            assert p == chol.GridPlan(132, chol.GRID_B)
            continue
        assert isinstance(p, chol.GlobalPlan)
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
    (1, 480, torch.float64, (8, 32, "smem")),
    (9, 1024, torch.float64, (8, 16, "smem")),
    (1, 640, torch.float64, (132, 32, "grid")),
    (8, 1024, torch.float64, (132, 32, "grid")),
    (1, 960, torch.float32, (132, 32, "grid")),
    (1, 3640, torch.float64, (132, 64, "grid")),
    (2, 3640, torch.float64, (132, 64, "grid")),
    (1, 7272, torch.float32, (132, 64, "grid"))])
def test_global_plan_choices(B, n, dtype, want):
    """The general loop's randomQP n=480 at B = 64, at f32 and f64, is the
    shape tools/chol_plans.py measured fastest (PERF.md); the others follow
    the same rule: the grid factor past the cluster factor's panel and for
    a few matrices from GRID_N_MIN on, each measured faster there."""
    p = chol.global_plan(B, n, dtype, sms=132)
    kind = "grid" if isinstance(p, chol.GridPlan) else "smem"
    assert (*p, kind) == want


def test_global_plan_raises_where_nothing_fits():
    """Past the last n whose panel of 8 rows fits a CTA (f64 3632, f32
    7264) the grid factor takes the factor, the card's CTAs shared out over
    any number of matrices (csrc/chol.cu, launch_grid_b); only a dtype fits
    no plan."""
    assert chol.global_plan(9, 3632, torch.float64) == (8, 8)
    assert chol.global_plan(9, 7264, torch.float32) == (8, 8)
    assert chol.factor_plan(3632, torch.float64) == "global"
    assert chol.factor_plan(7264, torch.float32) == "global"
    for n, dtype in ((3633, torch.float64), (7265, torch.float32),
                     (3640, torch.float64), (7272, torch.float32),
                     (50000, torch.float64)):
        es = 4 if dtype == torch.float32 else 8
        assert chol.factor_plan(n, dtype) == "wide"
        for B in (1, 2, 64, 200):
            p = chol.global_plan(B, n, dtype, sms=132)
            assert p == chol.GridPlan(132, chol.GRID_B_WIDE)
            groups = min(B, 132)
            assert chol.prof_ctas(B, p) == groups * (132 // groups) <= 132
        assert chol.KERNELS["factor", "wide", dtype] == (
            "chol_global_wide" if es == 4 else "chol_global_wide_f64")
    for n in (480, 3640):
        with pytest.raises(ValueError, match="no kernel takes"):
            chol.global_plan(1, n, torch.float16)
        with pytest.raises(ValueError, match="no kernel takes"):
            chol.factor_plan(n, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_factor_plans_meet_where_the_panel_leaves_shared_memory(dtype):
    """factor_plan says "wide" exactly where global_plan, at more matrices
    than GRID_B_MAX, leaves the cluster factor for the grid factor, and a
    cluster factor's panel always fits a CTA."""
    last = 3632 if dtype == torch.float64 else 7264
    for n in range(last - 40, last + 41):
        plan, p = chol.factor_plan(n, dtype), chol.global_plan(64, n, dtype)
        assert (plan == "wide") == isinstance(p, chol.GridPlan) == (n > last)
        if isinstance(p, chol.GlobalPlan):
            assert chol.global_smem_bytes(n, dtype, p.b) <= chol.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grid_plan_takes_few_matrices_from_its_n_min(dtype):
    """Below the cluster factor's limit the grid factor takes at most
    GRID_B_MAX matrices from GRID_N_MIN on (where tools/chol_plans.py
    measured it faster, PERF.md), and the cluster factor the rest; either
    way the factor counts under the kernel that runs."""
    lo = chol.GRID_N_MIN[dtype]
    for B in (1, chol.GRID_B_MAX):
        assert isinstance(chol.global_plan(B, lo, dtype), chol.GridPlan)
        assert isinstance(chol.global_plan(B, lo - 1, dtype), chol.GlobalPlan)
    assert isinstance(chol.global_plan(chol.GRID_B_MAX + 1, lo, dtype),
                      chol.GlobalPlan)
    assert chol.factor_plan(lo, dtype) == "global"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stripe_plan_takes_few_columns_from_its_n_min(dtype):
    """Below the global solve's limits the stripe solve takes at most
    STRIPE_BK_MAX columns in all from STRIPE_N_MIN on (measured faster
    there, PERF.md), in its width for the dtype, counted under its own
    name."""
    lo, bk = chol.STRIPE_N_MIN, chol.STRIPE_BK_MAX
    assert chol.STRIPE_W[dtype] in chol.STRIPE_WS
    for B, k in ((1, 1), (bk, 1), (2, bk // 2), (1, bk)):
        assert chol.solve_plan(B, lo, k, dtype) == ("wide", 1)
        assert chol.solve_plan(B, 2048, k, dtype) == ("wide", 1)
        assert chol.solve_kernel("wide", k, dtype) == (
            "chol_solve_global_wide"
            + ("_f64" if dtype == torch.float64 else ""))
    assert chol.solve_plan(1, lo - 1, 1, dtype) == ("global", 1)
    assert chol.solve_plan(bk + 1, lo, 1, dtype) == ("global", 1)
    assert chol.solve_plan(1, lo, bk + 1, dtype) == ("global", 1)
    # ticket and flags: 2 passes, B k columns, a ticket and S flags each
    assert chol.stripe_sync_ints(3, 100, 2, 32) == 2 * 3 * 2 * (4 + 1)


def test_wide_plans_mirror_the_c_side():
    """The C side's grid factor (threads, block of tiles, panel sizes, the
    padded strips), its stripe solve (widths, the layout of the tickets
    and flags) and every changed entry point's signature are the ones
    chol.py takes."""
    from qpalm_tpu_torch import _build

    src = _CHOL_CU.read_text()
    hit = re.search(r"\bCTILE = (\d+)", src)
    assert hit and int(hit.group(1)) == TILE
    hit = re.search(r"\bGRID_TB = (\d+)", src)
    assert hit and int(hit.group(1)) == GRID_TB
    assert "constexpr int GRID_THREADS = GRID_TB * GRID_TB;" in src
    assert GRID_TB * GRID_TB == chol.GRID_THREADS
    body = src[src.index("int launch_grid("):]
    body = body[:body.index("\n}\n")]
    assert {int(b) for b in re.findall(r"launch_grid_b<T, (\d+),", body)} \
        == set(chol.GRID_BS)
    assert chol.GRID_B in chol.GRID_BS and chol.GRID_B_WIDE in chol.GRID_BS
    body = src[src.index("int launch_solve_stripe("):]
    body = body[:body.index("\n}\n")]
    assert {int(w) for w in re.findall(r"case (\d+): return launch_stripe_w",
                                       body)} == set(chol.STRIPE_WS)
    assert ("sync + ((size_t)bwd * gridDim.z * k + (size_t)m * k + c) * "
            "(S + 1);") in src
    sig = _build._SIGNATURES
    assert len(sig["qp_chol_global"]) == len(sig["qp_chol_grid"]) == 9
    assert len(sig["qp_chol_solve_stripe"]) == 10
    assert "qp_chol_solve_wide" not in sig


def test_warp_plan_takes_f64_one_vector_of_even_n():
    """The warp plan takes every f64 solve whose R fits shared memory: one
    vector of even n as before, and since the plan's redesign odd n and
    several columns too (W warps a block from warp_cols); f32 never."""
    for n in range(1, 200):
        fits = (n <= chol.WARP_N_MAX
                and chol.warp_smem_bytes(n) <= chol.SMEM_LIMIT)
        assert fits == (n <= 170), n
        for B, k in ((512, 1), (512, 2), (1, 1), (8, 239), (3, 59)):
            plan = chol.solve_plan(B, n, k, torch.float64)
            assert (plan[0] == "warp") == fits, (B, n, k)
            if fits:
                assert plan[1] == chol.warp_cols(B, k)
                assert -(-k // plan[1]) <= 65535
        assert chol.solve_plan(512, n, 1, torch.float32)[0] != "warp"
    assert chol.solve_plan(1, 171, 1, torch.float64) == ("global", 1)


@pytest.mark.parametrize("B,k", [(1, 1), (1, 200), (8, 119), (8, 239),
                                 (64, 64), (512, 1), (512, 3), (132, 16),
                                 (131, 16)])
def test_warp_cols_fills_the_card_with_fewest_copies_of_R(B, k):
    """W is the largest power of two up to 16 and k whose B ceil(k / W)
    blocks still fill 132 SMs, else 1; the C side takes the same set."""
    W = chol.warp_cols(B, k, sms=132)
    assert W in chol.WARP_W and (W == 1 or W <= k)
    if W > 1:
        assert B * -(-k // W) >= 132
    bigger = [w for w in chol.WARP_W if w > W and w <= k]
    assert all(B * -(-k // w) < 132 for w in bigger)
    src = _CHOL_CU.read_text()
    assert "constexpr int WARP_W_MAX = 16;" in src
    assert max(chol.WARP_W) == 16


def _warp_stage(base, m, n, chunk=16384):
    """chol_solve_warp_kernel's bulk staging of matrix m, whose R
    starts at byte base + 8 m n^2: (row stride s, the byte of R in shared
    memory, the copies as (shared byte, global byte, bytes), the entries
    loaded one by one)."""
    s = n if n % 4 else n + 2
    nn = n * n
    src0 = base + 8 * m * nn
    head = 1 if s == n and src0 % 16 else 0
    r0 = 8 * head
    if s != n:
        return s, r0, [(r0 + 8 * r * s, src0 + 8 * r * n, 8 * n)
                       for r in range(n)], []
    tail = (nn - head) & 1
    nbytes = 8 * (nn - head - tail)
    copies = [(r0 + 8 * head + c, src0 + 8 * head + c, min(chunk, nbytes - c))
              for c in range(0, nbytes, chunk)]
    return s, r0, copies, [0] * head + [nn - 1] * tail


@pytest.mark.parametrize("n", [1, 2, 3, 17, 29, 33, 64, 65, 119, 126, 128,
                               169, 170])
def test_warp_staging_covers_R_once_inside_the_matrix(n):
    """Every entry of each matrix lands once at row r * s + column c of the
    staged R; every bulk copy is 16-byte aligned at both ends, a multiple
    of 16 bytes, and reads only its own matrix (the last matrix of an odd B
    n^2 included); the staged R fits warp_smem_bytes.  Bases 8 bytes off
    16 only where the wrapper allows them (n not a multiple of 4)."""
    src = _CHOL_CU.read_text()
    assert "constexpr uint32_t WARP_CHUNK = 16384;" in src
    assert "const int head = s == n && ((uintptr_t)src & 15) ? 1 : 0;" in src
    assert "return ((size_t)n * warp_solve_stride(n) + 1) * sizeof(double);" \
        in src
    for base in ((0, 8) if n % 4 else (0,)):
        for m in range(3):
            s, r0, copies, singles = _warp_stage(base, m, n)
            src0 = base + 8 * m * n * n
            seen = np.zeros(n * n, int)
            for dst, gsrc, size in copies:
                assert dst % 16 == 0 and gsrc % 16 == 0 and size % 16 == 0
                assert 0 < size and src0 <= gsrc
                assert gsrc + size <= src0 + 8 * n * n
                for off in range(0, size, 8):
                    e = (gsrc + off - src0) // 8
                    r, c = divmod(e, n)
                    assert dst + off == r0 + 8 * (r * s + c)
                    seen[e] += 1
            for e in singles:
                seen[e] += 1
            assert (seen == 1).all(), (base, m)
            assert r0 + 8 * n * s <= chol.warp_smem_bytes(n) - 16


@pytest.mark.parametrize("n,k", [(29, 3), (17, 2), (119, 1), (33, 2)])
def test_warp_solve_columns_at_odd_n_are_bit_identical(n, k):
    """Each warp of a block runs the one-vector schedule on its column:
    the emulation column by column equals cholesky_solve_plain of the
    (B, n, k) right-hand sides, bit for bit."""
    M = _spd(2, n, np.float64, seed=40 + n)
    R = cholesky_upper_plain(M)
    b = np.random.default_rng(41).standard_normal((2, n, k))
    want = cholesky_solve_plain(R, torch.from_numpy(b)).numpy()
    got = np.stack([_solve_warp(R.numpy(), b[:, :, c]) for c in range(k)],
                   -1)
    assert np.array_equal(got, want)


@pytest.mark.cuda
def test_cuda_refused_cluster_shape_raises():
    """A shape the entry point does not take (a cluster of 16, a panel of
    12 rows) raises before any launch; a shape it takes but the card
    refuses (2^31 CTAs, past the grid's limit) raises from the cluster
    launch itself, which leaves no error behind: the next launch runs
    clean.  Nothing runs in their place."""
    _cuda()
    from qpalm_tpu_torch._build import kernels

    M = _spd(2, 300, np.float32, seed=1).cuda()
    R = torch.zeros_like(M)
    for plan in (chol.GlobalPlan(16, 32), chol.GlobalPlan(2, 12)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            check_launch("qp_chol_global", chol._launch_global(M, R, plan))
    with pytest.raises(RuntimeError, match="CUDA error"):
        check_launch("qp_chol_global", kernels().qp_chol_global(
            M.data_ptr(), R.data_ptr(), 2 ** 30, 300, 0, 2, 32, None,
            torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    assert not R.any()
    check_launch("qp_chol_global",
                 chol._launch_global(M, R, chol.global_plan(2, 300,
                                                            M.dtype)))
    torch.cuda.synchronize()
    assert torch.equal(R, cholesky_upper_plain(M))


@pytest.mark.cuda
def test_cuda_refused_grid_launch_raises():
    """A grid factor of more CTAs than the card keeps resident is refused
    by the cooperative launch and raises, leaving no error behind: the
    next launch runs clean.  Nothing runs in its place."""
    _cuda()
    M = _spd(2, 300, np.float32, seed=3).cuda()
    R = torch.zeros_like(M)
    with pytest.raises(RuntimeError, match="CUDA error"):
        check_launch("qp_chol_grid", chol._launch_global(
            M, R, chol.GridPlan(100000, chol.GRID_B)))
    torch.cuda.synchronize()
    assert not R.any()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check_launch("qp_chol_grid", chol._launch_global(
        M, R, chol.GridPlan(sms, chol.GRID_B)))
    torch.cuda.synchronize()
    assert torch.equal(R, cholesky_upper_plain(M))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,dtype", [(1, 3640, torch.float64),
                                       (2, 3640, torch.float64),
                                       (1, 7272, torch.float32)])
def test_cuda_wide_factor_is_bit_identical_to_plain(B, n, dtype):
    """The sizes past a CTA's panel of 8 rows: the wide plan (the grid
    factor), counted under its own name, bit for bit the twin run on the
    card."""
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
    """At the general loop's (64, 480, 480) the wide plan (the grid
    factor), forced, gives the bits of the plan it replaces there (and of
    the twin)."""
    _cuda()
    M = _spd(64, 480, dtype, seed=61).cuda()
    today = chol.global_plan(64, 480, M.dtype)
    assert isinstance(today, chol.GlobalPlan)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    R0, R1 = torch.empty_like(M), torch.empty_like(M)
    for R, plan in ((R0, today), (R1, chol.GridPlan(sms, chol.GRID_B))):
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
    (f32): the wide plan (the stripe solve), bit for bit the twin run on
    the card, up to f64 n = 29064; R a random upper triangle with a
    dominant diagonal (no factor that large)."""
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
