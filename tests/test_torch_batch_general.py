"""The batch front end's general route (qpalm_tpu_torch.batch on
solver/core.py) against qpalm_tpu.batch on the CPU: what K1 does not take
(default f64 settings, use_fused="never", refinement and f64 residuals,
a shape past K1's streaming tier, a time limit, nonconvex batches) runs
the general loop, as the reference's does, and solve_batch_escalate and
solve_many(escalate=True) re-solve in float64.  Bars as in
tests/test_torch_core.py: at float64 equal statuses and iteration counts,
|dx| <= 1e-8 and |dy| <= 1e-7 scaled by max(1, |x|); at float32 equal
statuses and counts, |dx| < 1e-4 and |dy| < 1e-3."""

import numpy as np
import pytest

from helpers import random_convex_qp
from qpalm_tpu_torch import constants as C
from qpalm_tpu_torch.batch import (_fused_eligible, solve_batch,
                                   solve_batch_escalate, solve_many)
from qpalm_tpu_torch.types import Settings
from torch_support import _js, _scaled

PROBS = [random_convex_qp(5 + i % 8, 9 + i % 5, seed=500 + i, density=0.6)
         for i in range(12)]
S32 = dict(dtype="float32", eps_abs=1e-4, eps_rel=1e-4, max_iter=100,
           scaling=2, max_refine=0, delta=10.0, verbose=False)


def _reference(probs, s, **kw):
    from qpalm_tpu.batch import solve_batch as jsolve

    return [np.asarray(a) for a in jsolve(probs, _js(s), **kw)]


def _port(probs, s=None, **kw):
    return [a.cpu().numpy() for a in solve_batch(probs, s, device="cpu",
                                                 **kw)]


def _match(ref, got, f64=True):
    assert np.array_equal(got[2], ref[2])
    assert np.array_equal(got[3], ref[3])
    dx, dy = (1e-8, 1e-7) if f64 else (1e-4, 1e-3)
    assert _scaled(ref[0], got[0]).max() <= dx
    assert _scaled(ref[1], got[1]).max() <= dy


def test_default_settings_solve_and_match_reference():
    """Settings() is f64 with max_refine=3: K1 does not take it, and
    solve_batch with no settings solves through the general loop."""
    pytest.importorskip("jax")
    import qpalm_tpu
    from qpalm_tpu.batch import solve_batch as jsolve

    assert not _fused_eligible(Settings(), 16, 16)
    ref = [np.asarray(a) for a in jsolve(PROBS, qpalm_tpu.Settings())]
    got = _port(PROBS)
    assert got[0].dtype == np.float64
    assert np.all(got[2] == C.QPALM_SOLVED)
    _match(ref, got)


@pytest.mark.parametrize("kw", [
    dict(use_fused="never"),
    dict(max_refine=2, refine_fp64=True),
    dict(residuals_fp64=True)],
    ids=["never", "refine_fp64", "residuals_fp64"])
def test_float32_configurations_route_to_the_general_loop(kw):
    """Each of these keeps a batch off K1 (qpalm_tpu/batch.py:152-163);
    the general loop runs it at float32, at the f32 bar."""
    pytest.importorskip("jax")
    s = Settings(**{**S32, **kw})
    assert not _fused_eligible(s, 16, 16)
    ref, got = _reference(PROBS, s), _port(PROBS, s)
    assert got[0].dtype == np.float32
    _match(ref, got, f64=False)


def test_shape_past_the_streaming_tier_routes_to_the_general_loop():
    """n_pad 360 has no fused plan: the general loop takes it (K2's
    global-memory plan on a card), a few iterations at small m."""
    pytest.importorskip("jax")
    probs = [random_convex_qp(360, 8, seed=3 + i) for i in range(2)]
    s32 = Settings(**{**S32, "max_iter": 2})
    assert not _fused_eligible(s32, 360, 8)
    with pytest.raises(ValueError, match="no fused memory plan"):
        _fused_eligible(s32.replace(use_fused="always"), 360, 8)
    for s in (Settings(max_iter=3), s32):
        ref, got = _reference(probs, s), _port(probs, s)
        assert np.all(got[2] == C.QPALM_MAX_ITER_REACHED)
        _match(ref, got, f64=s.dtype == "float64")


def test_time_limited_batch_matches_reference():
    """A time limit runs the general loop in chunks of 200 iterations with
    the clock read between them (qpalm_tpu/batch.py:175-203).  With a
    limit the first chunk passes, the lanes still running get
    TIME_LIMIT_REACHED at iteration 200 and the lane that finished keeps
    its result, as in the reference; a limit that never passes changes
    nothing."""
    pytest.importorskip("jax")
    primal_inf = (np.eye(2), np.array([[1.0, 0.0], [1.0, 0.0]]),
                  np.zeros(2), np.array([1.0, -1e30]),
                  np.array([1e30, 0.0]))
    probs = [primal_inf] + PROBS[:3]
    s = Settings(eps_abs=1e-15, eps_rel=1e-15, max_iter=1000,
                 time_limit=1e-9)
    ref, got = _reference(probs, s), _port(probs, s)
    assert ref[2][0] == C.QPALM_PRIMAL_INFEASIBLE
    assert np.all(ref[2][1:] == C.QPALM_TIME_LIMIT_REACHED)
    assert np.all(ref[3][1:] == 200)
    _match(ref, got)
    s2 = Settings(max_iter=1000, time_limit=1e6)
    timed, plain = _port(PROBS, s2), _port(PROBS, s2.replace(
        time_limit=C.QPALM_INFTY))
    for a, b in zip(timed, plain):
        assert np.array_equal(a, b)


def test_nonconvex_through_the_general_route():
    """Nonconvex batches K1 does not take (here f64) run the general loop
    under the LOBPCG pins (qpalm_tpu/batch.py:301-306, 471-487), each
    package's own (the port's keep n eps ||Q|| of room,
    tests/test_torch_nonconvex.py, a few f64 ulps here), at the f64 bar;
    with a time limit the batch raises, as the reference's does."""
    pytest.importorskip("jax")
    rng = np.random.default_rng(42)
    probs = []
    for i in range(8):
        Qm = rng.standard_normal((6, 6))
        Qm = 0.5 * (Qm + Qm.T) - 1.5 * np.eye(6) if i % 2 == 0 \
            else Qm @ Qm.T + 0.1 * np.eye(6)
        probs.append((Qm, np.eye(6), rng.standard_normal(6), -np.ones(6),
                      np.ones(6)))
    s = Settings(nonconvex=True, eps_abs=1e-6, eps_rel=1e-6, max_iter=400)
    ref, got = _reference(probs, s), _port(probs, s)
    assert np.all(ref[2] == C.QPALM_SOLVED)
    _match(ref, got)
    with pytest.raises(NotImplementedError, match="nonconvex"):
        solve_batch(probs, s.replace(time_limit=10.0), device="cpu")


@pytest.mark.parametrize("use_fused", ["never", "auto"])
def test_solve_batch_escalate_matches_reference(use_fused):
    """An f32 pass of 12 iterations, then the lanes it left unsolved
    re-solved in f64 (max_iter 4000) and merged in the first pass's
    dtypes.  With use_fused="never" both first passes are the general loop
    and agree at the f32 bar; with "auto" the port's first pass is K1's
    twin, which may leave other lanes unsolved, so the merged statuses
    and solutions are held."""
    pytest.importorskip("jax")
    from qpalm_tpu.batch import solve_batch_escalate as jesc

    s = Settings(**{**S32, "max_iter": 12, "use_fused": use_fused})
    first = _port(PROBS, s)
    assert np.any(first[2] != C.QPALM_SOLVED)
    ref = [np.asarray(a) for a in jesc(PROBS, _js(s))]
    got = [a.numpy() for a in solve_batch_escalate(PROBS, s, device="cpu")]
    assert got[0].dtype == np.float32
    assert np.all(got[2] == C.QPALM_SOLVED)
    assert np.array_equal(got[2], ref[2])
    assert np.abs(got[0] - ref[0]).max() < 1e-4
    if use_fused == "never":
        _match(ref, got, f64=False)


def test_solve_many_escalate_matches_reference():
    """solve_many(escalate=True) escalates bucket by bucket."""
    pytest.importorskip("jax")
    from qpalm_tpu.batch import solve_many as jmany

    s = Settings(**{**S32, "max_iter": 12, "use_fused": "never"})
    ref = jmany(PROBS, _js(s), escalate=True)
    got = solve_many(PROBS, s, escalate=True, device="cpu")
    assert np.array_equal(got.status, ref.status)
    assert np.array_equal(got.iterations, ref.iterations)
    assert np.all(got.solved)
    assert np.abs(got.x - ref.x).max() < 1e-4
