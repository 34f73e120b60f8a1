"""The general solver loop of the PyTorch port (qpalm_tpu_torch.solver.core)
against qpalm_tpu.solver.core.full_solve vmapped over a batch, as
qpalm_tpu.batch.solve_batch_jit runs it, on the problems of
tests/test_basic_qp.py, tests/test_medium_qp.py and
tests/test_infeasibility.py, from the same stacked numpy data.  On the CPU
the port runs K2's plain twins and the reference LAPACK's Cholesky.

The bar at float64: equal statuses and iteration counts, |dx| <= 1e-8 and
|dy| <= 1e-7, each scaled by max(1, |x|) (the two factor and sum in other
orders).  At float32 it is tests/test_fused.py:41-57's: equal statuses and
counts, |dx| < 1e-4 and |dy| < 1e-3 (scaled likewise: the basic QP's x
reaches 3382, where an f32 ulp is 2.4e-4).  Lanes that end infeasible are
held by status and certificate direction: their iterates diverge."""

import dataclasses

import numpy as np
import pytest
import torch

from helpers import random_convex_qp
from qpalm_tpu_torch import constants as C
from qpalm_tpu_torch.solver import core
from qpalm_tpu_torch.types import (ScalingInfo, Settings, qpdata_from_numpy,
                                   solverstate_from_numpy)
from torch_support import _scaled

# tests/test_basic_qp.py:24-33
N, M = 4, 5
Q = np.diag([1.0, 0.046415888, 0.0021544347, 0.0001])
A = np.zeros((M, N))
A[3, 0] = -1.0
A[4, 1] = 0.025431136
A[0, 2] = -0.0001
A[2, 3] = 0.33066985
q = np.array([-2.0146781, 2.9613971, 7.286537, 7.8925204])
BMIN, BMAX = np.full(M, -2.0), np.full(M, 2.0)
BASIC = (Q, A, q, BMIN, BMAX)
# test_medium_qp.py: two of its seeds at n = m = 15
MEDIUM = [random_convex_qp(15, 15, seed=s) for s in (1, 2)]
# test_infeasibility.py:20-26, :45-52 and :66-70
PRIMAL_INF = (np.eye(1), np.array([[1.0], [1.0]]), np.zeros(1),
              np.array([1.0, -1e30]), np.array([1e30, 0.0]))
DUAL_INF = (1e-10 * np.eye(2), np.ones((3, 2)), np.array([1.0, -2.0]),
            np.array([-5.0, -10.0, -20.0]), np.array([5.0, 10.0, 20.0]))
DUAL_INF_ZERO_Q = (np.zeros((1, 1)), np.zeros((1, 1)), np.array([-1.0]),
                   np.array([-1e30]), np.array([1e30]))


def _settings(**kw):
    """tests/test_basic_qp.py:39-42."""
    return Settings(**{**dict(eps_abs=1e-6, eps_rel=1e-6, gamma_init=1e1,
                              verbose=False), **kw})


def _stack(probs, s):
    from qpalm_tpu.batch import stack_problems

    return [np.asarray(a) for a in stack_problems(probs, np.dtype(s.dtype))]


def _reference(data, s):
    """core.full_solve vmapped (qpalm_tpu/batch.py:60-100): the final
    state, x, y and the objective, as numpy."""
    import jax
    import jax.numpy as jnp
    import qpalm_tpu
    from qpalm_tpu.solver.core import full_solve
    from qpalm_tpu.types import QPData

    js = qpalm_tpu.Settings(**dataclasses.asdict(s))
    d = QPData(*(jnp.asarray(a) for a in data))
    zx = jnp.zeros_like(d.q)
    zy = jnp.zeros_like(d.bmin)
    out = jax.jit(jax.vmap(lambda dd, xw, yw: full_solve(
        dd, xw, yw, js, False, False)))(d, zx, zy)
    final, x, y, obj = out
    return (type(final)(*(np.asarray(f) for f in final)), np.asarray(x),
            np.asarray(y), np.asarray(obj))


def _port(data, s):
    final, x, y, obj = core.full_solve(qpdata_from_numpy(*data, "cpu"), s)
    return final, x.numpy(), y.numpy(), obj.numpy()


def _match(ref, got, f64=True):
    """Statuses and iteration counts equal; x, y and the objective at the
    bar."""
    (rf, rx, ry, ro), (gf, gx, gy, go) = ref, got
    assert np.array_equal(gf.status.numpy(), rf.status)
    assert np.array_equal(gf.iter.numpy(), rf.iter)
    dx, dy = (1e-8, 1e-7) if f64 else (1e-4, 1e-3)
    assert _scaled(rx, gx).max() <= dx
    assert _scaled(ry, gy).max() <= dy
    assert _scaled(ro, go).max() <= dx


@pytest.mark.parametrize("proximal", [True, False])
@pytest.mark.parametrize("scaling", [0, 10])
def test_basic_and_medium_sweep_match_reference(proximal, scaling):
    """tests/test_basic_qp.py:49-60's proximal x scaling sweep (SCHUR) on
    the basic QP and two medium ones, one batch."""
    pytest.importorskip("jax")
    s = _settings(proximal=proximal, scaling=scaling)
    data = _stack([BASIC] + MEDIUM, s)
    ref, got = _reference(data, s), _port(data, s)
    assert np.all(ref[0].status == C.QPALM_SOLVED)
    _match(ref, got)


@pytest.mark.parametrize("kw", [dict(max_iter=3), dict(inner_max_iter=2),
                                dict(sigma_max=1e3)],
                         ids=["max_iter", "inner_max_iter", "sigma_max"])
def test_budget_settings_match_reference(kw):
    """test_basic_qp.py:92-112: max_iter 3 (MAX_ITER_REACHED at 3), a
    2-iteration inner budget, a low sigma_max."""
    pytest.importorskip("jax")
    s = _settings(**kw)
    data = _stack([BASIC] + MEDIUM, s)
    ref, got = _reference(data, s), _port(data, s)
    if "max_iter" in kw:
        assert np.all(ref[0].status == C.QPALM_MAX_ITER_REACHED)
        assert np.all(got[0].iter.numpy() == 3)
    _match(ref, got)


def test_dual_objective_matches_reference():
    """test_basic_qp.py:115-127: the dual objective from R_Q (K2a, then
    K2b) at the solution, to the f64 bar."""
    pytest.importorskip("jax")
    s = _settings(enable_dual_termination=True, dual_objective_limit=1e20)
    data = _stack([BASIC] + MEDIUM, s)
    ref, got = _reference(data, s), _port(data, s)
    _match(ref, got)
    dref = ref[0].dual_objective
    assert np.all(np.isfinite(dref))
    assert np.all(_scaled(dref, got[0].dual_objective.numpy()) <= 1e-8)
    assert np.all(_scaled(dref, ref[3]) <= 1e-4)


def test_dual_termination_singular_q_matches_reference():
    """test_basic_qp.py:130-146: a PSD-singular Q NaNs the Q factor; with
    a -1e20 limit no lane may terminate on its dual objective, and the
    solve ends as the reference's does."""
    pytest.importorskip("jax")
    s = _settings(enable_dual_termination=True, dual_objective_limit=-1e20)
    Qs = np.diag([1.0, 1.0, 0.0, 0.0])
    data = _stack([(Qs, A, q, BMIN, BMAX), BASIC], s)
    ref, got = _reference(data, s), _port(data, s)
    assert ref[0].status[0] == C.QPALM_SOLVED
    assert ref[0].status[1] == C.QPALM_DUAL_TERMINATED
    assert not np.isfinite(got[0].dual_objective[0].item())
    _match(ref, got)


@pytest.mark.parametrize("proximal", [True, False])
@pytest.mark.parametrize("scaling", [2, 0])
def test_infeasibility_matches_reference(proximal, scaling):
    """tests/test_infeasibility.py's primal and dual infeasible problems
    under the four proximal x scaling combinations (the zero-Hessian one
    proximal only): statuses equal, certificates parallel."""
    pytest.importorskip("jax")
    s = _settings(proximal=proximal, scaling=scaling, gamma_init=1e7)
    probs = [PRIMAL_INF, DUAL_INF] + ([DUAL_INF_ZERO_Q] if proximal else [])
    data = _stack(probs, s)
    (rf, rx, ry, _), (gf, gx, gy, _) = _reference(data, s), _port(data, s)
    want = [C.QPALM_PRIMAL_INFEASIBLE] + [C.QPALM_DUAL_INFEASIBLE] * (
        len(probs) - 1)
    assert list(rf.status) == want
    assert np.array_equal(gf.status.numpy(), rf.status)

    def unit(v):
        return v / np.abs(v).max()

    dy_r, dy_g = rf.delta_y[0], gf.delta_y[0].numpy()
    assert np.abs(unit(dy_r) - unit(dy_g)).max() < 1e-6
    for i in range(1, len(probs)):
        dx_r, dx_g = rf.delta_x[i], gf.delta_x[i].numpy()
        assert np.abs(unit(dx_r) - unit(dx_g)).max() < 1e-6


def test_float32_general_loop_matches_reference():
    """The f32 loop (bisection linesearch, no refinement) at the f32 bar."""
    pytest.importorskip("jax")
    s = _settings(dtype="float32", eps_abs=1e-4, eps_rel=1e-4, max_refine=0)
    data = _stack([BASIC] + MEDIUM, s)
    ref, got = _reference(data, s), _port(data, s)
    assert got[1].dtype == np.float32
    _match(ref, got, f64=False)


def test_results_do_not_depend_on_the_sync_stride(monkeypatch):
    """Finished problems are frozen, so reading the done flags every
    iteration or every few gives bit-identical results."""
    s = _settings()
    probs = [BASIC] + MEDIUM + [random_convex_qp(6, 9, seed=5)]
    from qpalm_tpu_torch.batch import stack_problems

    data = stack_problems(probs, np.float64)
    base = core.full_solve(data, s)
    for stride in (1, 3):
        monkeypatch.setattr(core, "SYNC_STRIDE", stride)
        out = core.full_solve(data, s)
        assert all(torch.equal(a, b) for a, b in zip(out[0], base[0]))
        assert all(torch.equal(a, b) for a, b in zip(out[1:], base[1:]))


def test_unroll_changes_nothing():
    """Settings.unroll exists for the TPU's dispatch floor; its sub-steps
    are guarded (core.py:855-869), so it changes no result, and the port
    ignores it."""
    from qpalm_tpu_torch.batch import stack_problems

    data = stack_problems([BASIC] + MEDIUM, np.float64)
    base = core.full_solve(data, _settings())
    out = core.full_solve(data, _settings(unroll=4))
    assert all(torch.equal(a, b) for a, b in zip(out[0], base[0]))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(dtype="float32", residuals_fp64=True, max_refine=0, eps_abs=1e-4,
         eps_rel=1e-4),
    dict(dtype="float32", max_refine=2, refine_fp64=True, eps_abs=1e-4,
         eps_rel=1e-4)], ids=["f64", "f32_residuals_fp64", "f32_refine_fp64"])
def test_one_iteration_from_a_shared_state(kw):
    """One make_iteration step of both loops from the reference's state
    after k iterations (solverstate_from_numpy carries it across, with the
    reference's scaled data): every field of every lane at the bar, at
    float64 within 1e-9 relative, at float32 within 1e-4, flags and
    counters exactly."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import qpalm_tpu
    from qpalm_tpu.batch import _batch_chunk, _batch_init

    s = _settings(**kw)
    js = qpalm_tpu.Settings(**dataclasses.asdict(s))
    data = _stack(MEDIUM + [BASIC, random_convex_qp(10, 14, seed=9)], s)
    sts, sd, sc = _batch_init(_jdata(data),
                              jnp.zeros(data[2].shape, data[2].dtype),
                              jnp.zeros(data[3].shape, data[3].dtype), js,
                              False)
    psd = qpdata_from_numpy(*(np.asarray(f) for f in sd), device="cpu")
    psc = ScalingInfo(*(torch.as_tensor(np.array(f)) for f in sc))
    rtol = 1e-9 if s.dtype == "float64" else 1e-4
    for k in (2, 5):
        before = _batch_chunk(sts, sd, sc, js, jnp.asarray(k, jnp.int32))
        after = _batch_chunk(sts, sd, sc, js, jnp.asarray(k + 1, jnp.int32))
        st = solverstate_from_numpy(
            type(before)(*(np.asarray(f) for f in before)), device="cpu")
        got = core.solve_from_state(st, psd, psc, s, max_iter=k + 1)
        for name in st._fields:
            r = np.asarray(getattr(after, name))
            g = getattr(got, name).numpy()
            assert g.dtype == r.dtype, name
            if r.dtype.kind in "biu":
                assert np.array_equal(g, r), (k, name)
            elif r.size:
                err = _scaled(r.astype(float), g.astype(float)).max()
                assert err <= rtol, (k, name, err)


def _jdata(data):
    import jax.numpy as jnp
    from qpalm_tpu.types import QPData

    return QPData(*(jnp.asarray(a) for a in data))
