"""The host polish's native Bunch-Kaufman path in the PyTorch port
(qpalm_tpu_torch/polish.py) against the JAX package's
(qpalm_tpu/polish.py:378-455), each with its own build of the native
library (native/batch_kkt.cpp): the same C source, the same BLAS, so the
results are expected bit for bit and are held to 1e-12."""

import numpy as np
import pytest

from qpalm_tpu_torch import baseline_c, polish
from qpalm_tpu_torch.batch import stack_problems
from qpalm_tpu_torch.types import QPData
from qpalm_tpu_torch.workloads import make_problems


def _seeds(probs, eps, solve=None):
    """f32-rounded C-baseline solutions at `eps` (zero where `solve` is
    False), stacked and padded."""
    d64 = QPData(*(a.numpy() for a in stack_problems(probs, np.float64)))
    B, n_pad = d64.q.shape
    x = np.zeros((B, n_pad))
    y = np.zeros((B, d64.bmin.shape[1]))
    for i, p in enumerate(probs):
        if solve is None or solve[i]:
            r = baseline_c.solve(*p[:5], eps_abs=eps, eps_rel=eps, scaling=2)
            x[i, :p[0].shape[0]] = r["x"]
            y[i, :p[1].shape[0]] = r["y"]
    return d64, x.astype(np.float32), y.astype(np.float32)


def _degenerate():
    """Three small strictly convex QPs and one whose KKT system is exactly
    singular at the seed: Q = 0 with every row inactive (the factor fails
    that lane, which takes the per-lane LU fallback and is reported not
    ok)."""
    rng = np.random.default_rng(5)
    probs = []
    for _ in range(3):
        M = rng.standard_normal((8, 8))
        probs.append((M @ M.T + 0.5 * np.eye(8), rng.standard_normal((12, 8)),
                      rng.standard_normal(8), -np.ones(12), np.ones(12)))
    probs.append((np.zeros((8, 8)), rng.standard_normal((12, 8)),
                  rng.standard_normal(8), -1e3 * np.ones(12),
                  1e3 * np.ones(12)))
    return probs


@pytest.fixture(scope="module")
def batches():
    if polish._bkkt_lib() is None:
        pytest.skip("the native library does not build here")
    headline = _seeds(make_problems(16, 64, 96, seed=7), 1e-4)
    degenerate = _seeds(_degenerate(), 1e-4, solve=[True] * 3 + [False])
    return {"headline": headline, "degenerate": degenerate}


def _reference(d64):
    from qpalm_tpu.types import QPData as JQPData

    return JQPData(*d64)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
@pytest.mark.parametrize("case", ["headline", "degenerate"])
def test_native_polish_matches_the_reference(batches, case, precision):
    """Both packages take the native path (their _bkkt_lib loads); equal
    ok on every lane, x and y within 1e-12 (bit for bit in practice)."""
    pytest.importorskip("jax")
    import qpalm_tpu.polish as ref

    assert ref._bkkt_lib() is not None
    d64, x, y = batches[case]
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, rounds=2,
              refine_steps=2 if precision == "mixed" else 1, threads=2,
              precision=precision)
    got = polish.polish_batch_np(d64, x, y, **kw)
    want = ref.polish_batch_np(_reference(d64), x, y, **kw)
    assert np.array_equal(got.ok, np.asarray(want.ok))
    for f in ("x", "y"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert np.allclose(a, b, rtol=0, atol=1e-12, equal_nan=True), f
    if case == "headline":
        assert got.ok.sum() >= 14
    else:
        assert got.ok[:3].all() and not got.ok[3]


def test_the_factor_fails_the_singular_lane_alone(batches):
    """bkkt_factor_solve reports the singular lane and no other, so the
    per-lane fallback runs on it alone."""
    d64, x, y = batches["degenerate"]
    lib = polish._bkkt_lib()
    Q, A = d64.Q, d64.A
    B, n = d64.q.shape
    K = np.zeros((B, n + A.shape[1], n + A.shape[1]))
    K[:, :n, :n] = Q
    K[:, n:, n:] = np.eye(A.shape[1])  # every row inactive
    ipiv = np.empty(K.shape[:2], np.int32)
    fail = np.empty(B, np.int32)
    rhs = np.ones(K.shape[:2])
    nf = lib.bkkt_factor_solve(B, K.shape[1], K, ipiv, rhs, fail)
    assert nf == 1 and fail.tolist() == [0, 0, 0, 1]


def test_without_the_library_the_polish_solves_by_lu(batches, monkeypatch):
    """The reference's fallback (qpalm_tpu/polish.py:381): no library, the
    LU path; it certifies the same lanes."""
    d64, x, y = batches["headline"]
    native = polish.polish_batch_np(d64, x, y, rounds=2)
    monkeypatch.setattr(polish, "_bkkt_lib", lambda: None)
    lu = polish.polish_batch_np(d64, x, y, rounds=2)
    assert np.array_equal(native.ok, lu.ok)
    scale = np.abs(lu.x).max()
    assert np.abs(native.x - lu.x).max() <= 1e-8 * scale
