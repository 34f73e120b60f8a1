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
  (d) the plans: shapes, shared memory within SMEM_LIMIT for every n they
      admit, and a ValueError where nothing fits.

On a card: a cluster launch the card refuses raising, and the next launch
running clean (the factor and the solve against their twins are in
test_torch_chol.py)."""

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
    """f64 runs out of shared memory (n > 14528) before the kernel's
    largest E (n > 16384); f32 n past 16384 fits no plan."""
    assert chol.solve_plan(1, chol.GS_N_MAX, 1, torch.float32)[0] == "global"
    assert chol.global_solve_shape(chol.GS_N_MAX, torch.float32) == (512, 32)
    assert chol.solve_plan(1, 14528, 1, torch.float64)[0] == "global"
    for n, dtype in ((chol.GS_N_MAX + 1, torch.float32), (29056,
                                                          torch.float32),
                     (14529, torch.float64)):
        with pytest.raises(ValueError, match="fits no plan"):
            chol.solve_plan(1, n, 1, dtype)


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
    (64, 480, torch.float32, (2, 32)),
    (64, 480, torch.float64, (2, 32)),
    (128, 224, torch.float64, (1, 32)),
    (64, 300, torch.float32, (2, 32)),
    (64, 171, torch.float64, (2, 32)),
    (8, 480, torch.float64, (8, 32)),
    (200, 1024, torch.float64, (1, 16))])
def test_global_plan_choices(B, n, dtype, want):
    """The general loop's randomQP n=480 at B = 64, at f32 and f64, is the
    shape tools/chol_plans.py measured fastest (PERF.md); the others follow
    the same rule."""
    assert tuple(chol.global_plan(B, n, dtype, sms=132)) == want


def test_global_plan_raises_where_nothing_fits():
    assert chol.global_plan(1, 3632, torch.float64).b == 8
    assert chol.global_plan(1, 7264, torch.float32).b == 8
    for n, dtype in ((3633, torch.float64), (7265, torch.float32)):
        with pytest.raises(ValueError, match="fits no plan"):
            chol.global_plan(1, n, dtype)


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
            M.data_ptr(), R.data_ptr(), 2 ** 30, 300, 0, 2, 32, None,
            torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    assert not R.any()
    check_launch("qp_chol_global",
                 chol._launch_global(M, R, chol.global_plan(2, 300,
                                                            M.dtype)))
    torch.cuda.synchronize()
    assert torch.equal(R, cholesky_upper_plain(M))
