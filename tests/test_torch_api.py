"""The single-problem front end of the PyTorch port (qpalm_tpu_torch.api:
QPALM and solve, validate, the KKT method) against qpalm_tpu's on the CPU,
on the problems of tests/test_basic_qp.py and tests/test_validate.py, from
the same numpy inputs.  The port solves a batch of one through its general
loop (K2's plain twins here); the reference jits its loop for one problem.

The bar at float64: equal statuses and iteration counts, |dx| <= 1e-8 and
|dy| <= 1e-7, each scaled by max(1, |x|) and max(1, |y|) (the bar of
tests/test_torch_core.py).  At float32: equal statuses and counts, |dx| <
1e-4 and |dy| < 1e-3 (tests/test_fused.py:41-57), on a well-conditioned
problem (the basic QP at f32 is chaotic: SKILL.md, parity gotchas)."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from helpers import kkt_check, random_convex_qp
from qpalm_tpu_torch import QPALM, Settings, solve
from qpalm_tpu_torch import constants as C
from qpalm_tpu_torch.validate import ValidationError, validate_settings
from torch_support import _js

# tests/test_basic_qp.py:24-33
N, M = 4, 5
Q = np.diag([1.0, 0.046415888, 0.0021544347, 0.0001])
A = np.zeros((M, N))
A[3, 0] = -1.0
A[4, 1] = 0.025431136
A[0, 2] = -0.0001
A[2, 3] = 0.33066985
q = np.array([-2.0146781, 2.9613971, 7.286537, 7.8925204])
bmin = np.full(M, -2.0)
bmax = np.full(M, 2.0)
BASIC = (Q, A, q, bmin, bmax)
SOLUTION = np.array([2.0000000e00, -6.3801365e01, -3.3821109e03,
                     -6.0483288e00])


def base_settings(**kw):
    """tests/test_basic_qp.py:39-42."""
    return Settings(**{**dict(eps_abs=1e-6, eps_rel=1e-6, gamma_init=1e1,
                              verbose=False), **kw})


def reference(prob, s, x0=None, y0=None):
    """qpalm_tpu.solve on the same inputs."""
    import qpalm_tpu

    return qpalm_tpu.solve(*prob, settings=_js(s), x0=x0, y0=y0)


def _scaled(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b) / np.maximum(1.0, np.abs(a))


def assert_match(ref, got, f64=True):
    assert got.info.status_val == int(ref.info.status_val)
    assert got.info.iter == int(ref.info.iter)
    assert got.info.iter_out == int(ref.info.iter_out)
    dx, dy = (1e-8, 1e-7) if f64 else (1e-4, 1e-3)
    assert _scaled(ref.solution.x, got.solution.x).max() <= dx
    assert _scaled(ref.solution.y, got.solution.y).max() <= dy
    assert abs(got.info.objective - float(ref.info.objective)) <= \
        (1e-8 if f64 else 1e-4) * max(1.0, abs(float(ref.info.objective)))


def assert_solution(res):
    """tests/test_basic_qp.py:45-52."""
    assert res.info.status_val == C.QPALM_SOLVED
    np.testing.assert_allclose(res.solution.x, SOLUTION, rtol=1e-5)
    kkt_check(Q, A, q, bmin, bmax, res.solution.x, res.solution.y, tol=1e-4)


@pytest.mark.parametrize("proximal", [True, False])
@pytest.mark.parametrize(
    "method", [C.FACTORIZE_SCHUR, C.FACTORIZE_KKT, C.FACTORIZE_KKT_OR_SCHUR])
def test_basic_qp_sweep_matches_reference(proximal, method):
    """tests/test_basic_qp.py:55-65, SCHUR, KKT and KKT_OR_SCHUR, each held
    against the reference's own path."""
    pytest.importorskip("jax")
    s = base_settings(proximal=proximal, factorization_method=method)
    got = QPALM(*BASIC, settings=s, device="cpu").solve()
    assert_solution(got)
    assert_match(reference(BASIC, s), got)


def test_kkt_matches_reference_on_random_problems():
    """The KKT path past the basic QP: random problems whose active sets
    change, f64, with and without scaling and the proximal term."""
    pytest.importorskip("jax")
    for seed, kw in ((31, {}), (32, dict(scaling=0, proximal=False))):
        prob = random_convex_qp(12, 18, seed=seed, density=0.6)
        s = base_settings(factorization_method=C.FACTORIZE_KKT, **kw)
        got = solve(*prob, settings=s, device="cpu")
        assert got.info.status == "solved"
        assert_match(reference(prob, s), got)


def test_basic_qp_warm_start():
    """tests/test_basic_qp.py:68-79: the warm-started solve converges in
    < 12 iterations, cold and warm solves equal to the reference's."""
    pytest.importorskip("jax")
    s = base_settings()
    solver = QPALM(*BASIC, settings=s, device="cpu")
    res = solver.solve()
    assert_solution(res)
    assert_match(reference(BASIC, s), res)
    solver.warm_start(res.solution.x, res.solution.y)
    res2 = solver.solve()
    assert_solution(res2)
    assert res2.info.iter < 12
    assert_match(reference(BASIC, s, res.solution.x, res.solution.y), res2)
    # the warm start applies to one solve only (api.py:314)
    res3 = solver.solve()
    assert res3.info.iter == res.info.iter
    np.testing.assert_array_equal(res3.solution.x, res.solution.x)


def test_basic_qp_warm_start_resolve_identical():
    """tests/test_basic_qp.py:82-95."""
    solver = QPALM(*BASIC, settings=base_settings(), device="cpu")
    x0, y0 = np.ones(N), np.ones(M)
    solver.warm_start(x0, y0)
    res1 = solver.solve()
    solver.warm_start(x0, y0)
    res2 = solver.solve()
    assert res1.info.iter == res2.info.iter
    np.testing.assert_array_equal(res1.solution.x, res2.solution.x)


@pytest.mark.parametrize("kw", [dict(max_iter=3), dict(inner_max_iter=2),
                                dict(sigma_max=1e3)],
                         ids=["max_iter", "inner_max_iter", "sigma_max"])
def test_basic_qp_limits_match_reference(kw):
    """tests/test_basic_qp.py:98-116."""
    pytest.importorskip("jax")
    s = base_settings(**kw)
    got = solve(*BASIC, settings=s, device="cpu")
    if "max_iter" in kw:
        assert got.info.status_val == C.QPALM_MAX_ITER_REACHED
        assert got.info.iter == 3
    else:
        assert_solution(got)
    assert_match(reference(BASIC, s), got)


def test_basic_qp_dual_objective():
    """tests/test_basic_qp.py:119-131: the dual objective equals the
    primal one at the solution, and the reference's."""
    pytest.importorskip("jax")
    s = base_settings(enable_dual_termination=True,
                      dual_objective_limit=1e20)
    got = solve(*BASIC, settings=s, device="cpu")
    assert_solution(got)
    assert abs(got.info.dual_objective - got.info.objective) <= \
        1e-4 * max(1.0, abs(got.info.objective))
    ref = reference(BASIC, s)
    assert_match(ref, got)
    assert abs(got.info.dual_objective - float(ref.info.dual_objective)) \
        <= 1e-8 * abs(got.info.objective)


def test_float32_matches_reference():
    """An f32 solve of a well-conditioned problem at the f32 bar."""
    pytest.importorskip("jax")
    prob = random_convex_qp(10, 15, seed=7)
    s = base_settings(dtype="float32", eps_abs=1e-4, eps_rel=1e-4)
    got = solve(*prob, settings=s, device="cpu")
    assert got.info.status == "solved"
    assert got.solution.x.dtype == np.float64
    assert_match(reference(prob, s), got, f64=False)


def _indefinite(n, seed):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    Qi = 0.5 * (G + G.T)
    Ai = np.concatenate([np.eye(n), rng.standard_normal((2, n))])
    u = np.concatenate([np.ones(n), 2.0 * np.ones(2)])
    return Qi, Ai, rng.standard_normal(n), -u, u


@pytest.mark.parametrize("n", [3, 12])
def test_nonconvex_matches_reference(n):
    """api.py:195-225: the pin from the scaled Q's minimum eigenvalue
    (eigvalsh at n <= 3, LOBPCG above), proximal on; equal to the
    reference at f64 where its lambda is finite."""
    pytest.importorskip("jax")
    import qpalm_tpu

    prob = _indefinite(n, seed=40 + n)
    s = base_settings(nonconvex=True)
    solver = QPALM(*prob, settings=s, device="cpu")
    ref_solver = qpalm_tpu.QPALM(*prob, settings=_js(s))
    assert np.isfinite(ref_solver._gamma_override)
    assert solver.settings.proximal and solver.settings.nonconvex
    assert abs(solver._gamma_override - ref_solver._gamma_override) <= \
        1e-10 * ref_solver._gamma_override
    got = solver.solve()
    assert got.info.status == "solved"
    assert_match(ref_solver.solve(), got)
    # a convex problem is solved as one
    convex = QPALM(*random_convex_qp(6, 8, seed=3), settings=s,
                   device="cpu")
    assert not convex.settings.nonconvex
    assert convex._gamma_override is None


def test_time_limit_chunks_and_cuts():
    """The host chunking of api.py:273-299: a limit that does not cut gives
    the unlimited result bit for bit; one that cuts ends the solve after
    the first chunk of min(200, max_iter) iterations."""
    s = base_settings()
    free = solve(*BASIC, settings=s, device="cpu")
    loose = solve(*BASIC, settings=s.replace(time_limit=1e6), device="cpu")
    assert loose.info.iter == free.info.iter
    np.testing.assert_array_equal(loose.solution.x, free.solution.x)
    cut = solve(*BASIC, settings=s.replace(eps_abs=1e-14, eps_rel=0.0,
                                          max_iter=1000, time_limit=1e-9),
                device="cpu")
    assert cut.info.status_val == C.QPALM_TIME_LIMIT_REACHED
    assert cut.info.status == "time limit exceeded"
    assert cut.info.iter == 200


def test_result_types_and_verbose():
    """Solution and certificates are host f64 arrays of the true sizes, the
    state a batch of one on the device, and verbose prints the reference's
    banner and box (api.py:268-271, 301-312)."""
    out = io.StringIO()
    with redirect_stdout(out):
        res = QPALM(*BASIC, settings=base_settings(verbose=True),
                    device="cpu").solve()
    text = out.getvalue()
    assert f"(n = {N}, m = {M})" in text
    assert "status:     solved" in text
    assert f"iterations: {res.info.iter} " in text
    for v, k in ((res.solution.x, N), (res.solution.y, M),
                 (res.delta_x, N), (res.delta_y, M)):
        assert isinstance(v, np.ndarray) and v.dtype == np.float64
        assert v.shape == (k,)
    assert isinstance(res.info.iter, int)
    assert res.state.x.shape == (1, 8)
    assert res.info.run_time >= res.info.solve_time > 0


def test_unported_branches_raise():
    """The branches that raised NotImplementedError before they were
    ported now run: FACTORIZE_CG, sparse=True and large scipy input take
    the CG branch, solve routes large scipy input to solve_sparse_auto,
    SequentialMPC takes the sparse backend, and FACTORIZE_STAGE and the
    stage-structured MPC run block Thomas (an n that stage_block does not
    divide is a ValueError, as in the reference); a device that is neither
    the CPU nor CUDA still raises."""
    from qpalm_tpu_torch.linalg.sparse import is_sparse
    from qpalm_tpu_torch.workloads import SequentialMPC

    for solver in (QPALM(*BASIC, settings=base_settings(
            factorization_method=C.FACTORIZE_CG), device="cpu"),
            QPALM(*BASIC, settings=base_settings(), sparse=True,
                  device="cpu")):
        assert solver.sparse and is_sparse(solver._data.A)
        assert solver.settings.factorization_method == C.FACTORIZE_CG
        res = solver.solve()
        assert res.info.status == "solved"
        assert np.abs(res.solution.x - SOLUTION).max() < 1e-2 * np.abs(
            SOLUTION).max()
    big = sp.identity(2048, format="csc")
    assert QPALM(big, big, np.zeros(2048), -np.ones(2048), np.ones(2048),
                 device="cpu").sparse
    res = solve(big, big, np.ones(2048), -np.ones(2048), np.ones(2048),
                device="cpu")
    assert res.info.status == "solved" and res.state is None
    np.testing.assert_allclose(res.solution.x, -np.ones(2048), atol=1e-6)
    with pytest.raises(ValueError, match="stage_block"):
        QPALM(*BASIC, settings=base_settings(
            factorization_method=C.FACTORIZE_STAGE, stage_block=3),
            device="cpu")
    res = QPALM(*BASIC, settings=base_settings(
        factorization_method=C.FACTORIZE_STAGE, stage_block=2),
        device="cpu").solve()
    assert res.info.status == "solved"
    assert np.abs(res.solution.x - SOLUTION).max() < 1e-2 * np.abs(
        SOLUTION).max()
    mpc = SequentialMPC(2, 3, stage_structured=True, device="cpu")
    assert mpc.step()[0] == "solved"
    mpc = SequentialMPC(2, 3, backend="sparse", device="cpu")
    assert mpc.step()[0] == "solved"
    with pytest.raises(NotImplementedError, match="CPU and CUDA"):
        QPALM(*BASIC, device="meta")


# tests/test_validate.py


def test_bounds_crossed_and_shapes():
    with pytest.raises(ValidationError):
        QPALM(np.eye(1), np.ones((1, 1)), np.zeros(1), np.array([2.0]),
              np.array([1.0]), device="cpu")
    for Qb, Ab, qb in ((np.eye(2), np.ones((1, 3)), np.zeros(2)),
                       (np.eye(2), np.ones((1, 2)), np.zeros(3)),
                       (np.ones((2, 3)), np.ones((1, 2)), np.zeros(2))):
        with pytest.raises(ValidationError):
            QPALM(Qb, Ab, qb, np.array([0.0]), np.array([1.0]),
                  device="cpu")


BAD_SETTINGS = [
    dict(max_iter=0), dict(inner_max_iter=0), dict(eps_abs=-1.0),
    dict(eps_rel=-1.0), dict(eps_abs=0.0, eps_rel=0.0),
    dict(eps_abs_in=-1.0), dict(eps_rel_in=-1.0), dict(rho=1.0),
    dict(rho=0.0), dict(eps_prim_inf=-1e-3), dict(eps_dual_inf=-1e-3),
    dict(theta=1.5), dict(delta=0.5), dict(sigma_max=0.0),
    dict(sigma_init=0.0), dict(gamma_init=0.0), dict(gamma_upd=0.5),
    dict(gamma_max=0.0), dict(scaling=-1), dict(print_iter=0),
    dict(reset_newton_iter=0), dict(time_limit=0.0),
    dict(factorization_method=7), dict(dtype="float16"),
    dict(linesearch="golden"),
]


@pytest.mark.parametrize("kw", BAD_SETTINGS,
                         ids=[str(k) for k in BAD_SETTINGS])
def test_bad_settings_rejected_as_reference(kw):
    """tests/test_validate.py:35-67: every range check of validate.c, and
    the reference's validate_settings rejects the same settings."""
    with pytest.raises(ValidationError):
        validate_settings(Settings(**kw))
    with pytest.raises(ValidationError):
        QPALM(*BASIC, settings=Settings(**kw), device="cpu")
    jax_validate = pytest.importorskip("qpalm_tpu.validate")
    with pytest.raises(jax_validate.ValidationError):
        jax_validate.validate_settings(_js(Settings(**kw)))


def test_good_settings_pass():
    validate_settings(Settings())
    validate_settings(Settings(eps_abs=0.0, eps_rel=1e-9))
    validate_settings(Settings(dtype="float32", max_refine=0))


@pytest.mark.cuda
def test_cuda_front_end_matches_cpu():
    """On the card: QPALM's SCHUR solve equals solve_batch([p]) bit for
    bit, and the card's SCHUR and KKT solves match the CPU's at the f64
    bar (K2 is bit-identical to its twins; cuBLAS sums in other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from qpalm_tpu_torch.batch import solve_batch

    prob = random_convex_qp(40, 60, seed=13, density=0.5)
    for method in (C.FACTORIZE_SCHUR, C.FACTORIZE_KKT):
        s = base_settings(factorization_method=method)
        got = solve(*prob, settings=s, device="cuda")
        want = solve(*prob, settings=s, device="cpu")
        assert got.info.status == "solved"
        assert got.info.iter == want.info.iter
        assert _scaled(want.solution.x, got.solution.x).max() <= 1e-8
        assert _scaled(want.solution.y, got.solution.y).max() <= 1e-7
        if method == C.FACTORIZE_SCHUR:
            res = solve_batch([prob], s, device="cuda")
            assert np.array_equal(res.x[0, :40].cpu().numpy(),
                                  got.solution.x)
