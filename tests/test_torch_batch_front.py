"""The PyTorch port's batch front end (qpalm_tpu_torch.batch.solve_batch,
solve_many, bucket_indices, BatchResult, _fused_eligible) against
qpalm_tpu.batch on the CPU.  There the JAX package takes its general
solver loop, which tests/test_fused.py holds iteration-identical to its
fused kernel; the port runs K1's plain twin, with its own gamma pins."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import random_convex_qp
from qpalm_tpu_torch import constants as C
from qpalm_tpu_torch.batch import (
    BatchResult, _fused_eligible, bucket_indices, solve_batch, solve_many)
from qpalm_tpu_torch.types import Settings
from qpalm_tpu_torch.workloads import boxqp
import torch_support  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
S32 = dict(dtype="float32", eps_abs=1e-4, eps_rel=1e-4, max_iter=100,
           scaling=2, max_refine=0, delta=10.0, verbose=False)
# scripts/bench_nonconvex.py:119-121
BOXQP = dict(dtype="float32", nonconvex=True, eps_abs=1e-4, eps_rel=1e-4,
             max_iter=400, scaling=2, max_refine=0, verbose=False)


def _nonconvex_family(B=128):
    """tests/test_fused.py:193-204."""
    rng = np.random.default_rng(42)
    probs = []
    for i in range(B):
        Q = rng.standard_normal((8, 8))
        Q = 0.5 * (Q + Q.T) - 1.5 * np.eye(8) if i % 2 == 0 \
            else Q @ Q.T + 0.1 * np.eye(8)
        probs.append((Q, np.eye(8), rng.standard_normal(8), -np.ones(8),
                      np.ones(8)))
    return probs


def _reference(probs, s, **kw):
    import qpalm_tpu
    from qpalm_tpu.batch import solve_batch as jsolve

    r = jsolve(probs, qpalm_tpu.Settings(**dataclasses.asdict(s)), **kw)
    return [np.asarray(a) for a in r]


def _port(probs, s, **kw):
    r = solve_batch(probs, s, device="cpu", **kw)
    assert isinstance(r, BatchResult)
    return [a.numpy() for a in r]


def _agree(ref, got, min_status, min_iters, dx=1e-4):
    """Statuses and iteration counts equal on at least the given numbers of
    lanes; x within dx, and the objectives close, where both agree."""
    st = ref[2] == got[2]
    it = st & (ref[3] == got[3])
    assert st.sum() >= min_status, np.where(~st)
    assert it.sum() >= min_iters, np.where(~it)
    assert np.max(np.abs(ref[0] - got[0])[it]) < dx
    assert np.allclose(got[4][it], ref[4][it], rtol=1e-4, atol=1e-4)


def test_solve_batch_nonconvex_matches_reference():
    pytest.importorskip("jax")
    probs = _nonconvex_family()
    s = Settings(**{**S32, "nonconvex": True, "max_iter": 400})
    ref, got = _reference(probs, s), _port(probs, s)
    assert np.mean(ref[2] == C.QPALM_SOLVED) > 0.9
    # the port's own pins may differ from the reference's by f32 LOBPCG
    # rounding, which can move a lane by one inner cycle
    _agree(ref, got, 128, 126)


def _stationary(p, x, y, tol=5e-3):
    """tests/test_fused.py:225-239: Qx + q + A'y ~ 0, and y_j > 0 only at
    the upper bound, y_j < 0 only at the lower one."""
    Q, A, q, bl, bu = p
    x, y = x[:Q.shape[0]].astype(float), y[:A.shape[0]].astype(float)
    ax = A @ x
    return (np.max(np.abs(Q @ x + q + A.T @ y)) < tol
            and np.all((y <= 1e-3) | (ax > bu - 1e-3))
            and np.all((y >= -1e-3) | (ax < bl + 1e-3)))


def test_solve_batch_boxqp_matches_reference():
    """BOXQP-d at n = 16 (scripts/bench_nonconvex.py:118-131), at its f32
    floor: most lanes end at max_iter, and which few solve is decided by
    f32 rounding.  The reference's own two paths part there (its fused
    kernel and general loop agree on 117/128 statuses of this family, 22
    against 23 solved), and the port's kernel order parts from both in the
    same way.  So statuses are held on 7/8 of the lanes, the solved counts
    within 3, and every lane the port solves must be stationary."""
    pytest.importorskip("jax")
    probs = [boxqp(16, seed=16000 + i) for i in range(64)]
    s = Settings(**BOXQP)
    ref, got = _reference(probs, s), _port(probs, s)
    assert (got[2] == ref[2]).sum() >= 56
    solved = got[2] == C.QPALM_SOLVED
    assert abs(int(solved.sum()) - int((ref[2] == C.QPALM_SOLVED).sum())) <= 3
    assert solved.sum() >= 5
    assert np.all(np.isfinite(got[0])) and np.all(np.isfinite(got[1]))
    for i in np.where(solved)[0]:
        assert _stationary(probs[i], got[0][i], got[1][i]), i


def test_solve_batch_dual_termination_matches_reference():
    pytest.importorskip("jax")
    probs = [random_convex_qp(16, 24, seed=90 + i, density=0.5)
             for i in range(128)]
    s = Settings(**S32, enable_dual_termination=True,
                 dual_objective_limit=-1.0)
    ref, got = _reference(probs, s), _port(probs, s)
    assert (got[2] == C.QPALM_DUAL_TERMINATED).any()
    _agree(ref, got, 128, 128)


def test_solve_batch_warm_start_matches_reference():
    pytest.importorskip("jax")
    probs = [random_convex_qp(12, 18, seed=70 + i, density=0.5)
             for i in range(64)]
    s = Settings(**S32)
    cold = _port(probs, s)
    x0 = [cold[0][i, :12] for i in range(64)]
    y0 = [cold[1][i, :18] for i in range(64)]
    ref, got = _reference(probs, s, x0=x0, y0=y0), _port(probs, s, x0=x0,
                                                         y0=y0)
    assert np.all(got[2] == C.QPALM_SOLVED)
    # as tests/test_fused.py:113-118: a lane on the tolerance boundary may
    # run one more inner cycle under another summation order
    _agree(ref, got, 64, 61)
    assert got[3].mean() < cold[3].mean()


def test_solve_many_matches_reference():
    pytest.importorskip("jax")
    from qpalm_tpu.batch import solve_many as jmany
    import qpalm_tpu

    sizes = [(5, 7), (12, 3), (9, 18), (16, 24)]
    probs = [random_convex_qp(*sizes[i % 4], seed=300 + i, density=0.5)
             for i in range(32)]
    s = Settings(**S32)
    ref = jmany(probs, qpalm_tpu.Settings(**dataclasses.asdict(s)))
    got = solve_many(probs, s, device="cpu")
    for name in ("n", "m"):
        assert np.array_equal(getattr(got, name), getattr(ref, name))
    assert got.x.shape == ref.x.shape and got.y.shape == ref.y.shape
    assert np.array_equal(got.status, ref.status)
    assert np.array_equal(got.iterations, ref.iterations)
    assert np.max(np.abs(got.x - ref.x)) < 1e-4
    assert np.array_equal(got.solved, ref.solved)


def test_bucket_indices_matches_reference():
    pytest.importorskip("jax")
    from qpalm_tpu.batch import bucket_indices as jbuckets

    sizes = [(5, 7), (12, 3), (9, 0), (16, 24), (8, 8), (17, 1)]
    for mult in (1, 4, 8):
        assert bucket_indices(sizes, mult) == jbuckets(sizes, mult)


def test_batch_result_helpers_and_objective():
    probs = [random_convex_qp(6, 9, seed=400 + i) for i in range(8)]
    probs[0] = probs[0] + (1.5,)  # an objective constant
    res = solve_batch(probs, Settings(**S32), device="cpu")
    assert torch.equal(res.solved, res.status == C.QPALM_SOLVED)
    counts, edges = res.iteration_histogram(bins=4)
    assert counts.sum() == 8 and len(edges) == 5
    for i, p in enumerate(probs):
        x = res.x[i, :6].double().numpy()
        obj = 0.5 * x @ p[0] @ x + p[2] @ x + (p[5] if len(p) > 5 else 0.0)
        assert abs(res.objective[i].item() - obj) < 1e-4 * max(1, abs(obj))


@pytest.mark.parametrize("kw,eligible", [
    (dict(), True),
    (dict(nonconvex=True, enable_dual_termination=True), True),
    (dict(use_fused="never"), False),
    (dict(max_refine=2), False),
    (dict(time_limit=5.0), False),
    (dict(dtype="float64"), False),
    (dict(factorization_method=C.FACTORIZE_CG), False),
    (dict(residuals_fp64=True), False),
])
def test_fused_eligible_rules(kw, eligible):
    s = Settings(**{**S32, **kw})
    assert _fused_eligible(s, 64, 96) is eligible
    if not eligible and s.use_fused != "never":
        with pytest.raises(ValueError, match="general loop"):
            _fused_eligible(s.replace(use_fused="always"), 64, 96)


@pytest.mark.parametrize("n_pad,m_pad,eligible", [
    (64, 96, True), (160, 8, True), (168, 8, True), (128, 192, True),
    (352, 528, True), (62, 96, False), (360, 8, False), (352, 3000, False)])
def test_fused_eligible_shared_memory_plan(n_pad, m_pad, eligible):
    """K1 keeps Q, A and M in one block's 227 KB of shared memory up to
    n_pad = 160 with few rows; past that its streaming tier takes the shape
    up to n_pad 352, as long as its vectors fit.  The rest is the general
    loop's (solver/core.py)."""
    s = Settings(**S32)
    assert _fused_eligible(s, n_pad, m_pad) is eligible
    if not eligible:
        with pytest.raises(ValueError, match="general loop"):
            _fused_eligible(s.replace(use_fused="always"), n_pad, m_pad)


def test_boxqp_is_the_bench_generator():
    spec = importlib.util.spec_from_file_location(
        "bench_nonconvex", ROOT / "scripts" / "bench_nonconvex.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for n, seed, coupling in ((16, 16000, True), (12, 3, False)):
        for u, v in zip(boxqp(n, seed, coupling),
                        bench.boxqp(n, seed, coupling)):
            assert np.array_equal(u, v)
