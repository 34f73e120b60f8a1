"""Kernel K1 (the fused P-ALM loop) of the PyTorch port: the plain twin
through solve_batch_fused against qpalm_tpu.solver.fused.solve_batch_fused
in interpret mode, at the bars of tests/test_fused.py, in every tier the
port runs (convex, nonconvex under gamma pins, dual-objective termination,
warm start, host chunking); and the CUDA kernel against its plain twin on
a card."""

import numpy as np
import pytest
import torch

from helpers import random_convex_qp
from qpalm_tpu_torch import constants as C
from qpalm_tpu_torch.batch import (
    solve_batch, solve_batch_escalate, solve_many, stack_problems)
from qpalm_tpu_torch.solver import fused as F
from qpalm_tpu_torch.solver.nonconvex import batch_gamma_pins
from qpalm_tpu_torch.types import Settings
from torch_support import _js, _settings

B = 128  # the reference kernel takes whole 128-lane blocks


def _primal_infeasible(seed):
    """a'x >= 1 and a'x <= -0.5 at once, beside a feasible box row."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((3, 3))
    a = rng.standard_normal(3)
    A = np.vstack([a, a, rng.standard_normal(3)])
    return (G @ G.T + 0.5 * np.eye(3), A, rng.standard_normal(3),
            np.array([1.0, -1e30, -1.0]), np.array([1e30, -0.5, 1.0]))


PRIMAL_INFEASIBLE = _primal_infeasible(10)
# zero Hessian, free variable, descending objective (test_infeasibility.py:64)
DUAL_INFEASIBLE = (np.zeros((1, 1)), np.zeros((1, 1)), np.array([-1.0]),
                   np.array([-1e30]), np.array([1e30]))


def _nonconvex_family():
    """tests/test_fused.py:193-204: half the problems indefinite, half
    convex, n = m = 8."""
    rng = np.random.default_rng(42)
    probs = []
    for i in range(B):
        Q = rng.standard_normal((8, 8))
        Q = 0.5 * (Q + Q.T) - 1.5 * np.eye(8) if i % 2 == 0 \
            else Q @ Q.T + 0.1 * np.eye(8)
        probs.append((Q, np.eye(8), rng.standard_normal(8), -np.ones(8),
                      np.ones(8)))
    return probs


def _jax_settings(s):
    import qpalm_tpu

    return qpalm_tpu.Settings(**{k: getattr(s, k) for k in (
        "dtype", "eps_abs", "eps_rel", "max_iter", "scaling", "max_refine",
        "delta", "proximal", "nonconvex", "enable_dual_termination",
        "dual_objective_limit")})


def _jax_pins(probs, s):
    """The JAX package's gamma pins, as numpy: both sides are fed these, so
    an ulp between the two LOBPCGs cannot steer the f32 trajectories."""
    from qpalm_tpu.batch import stack_problems as jstack
    from qpalm_tpu.solver.nonconvex import batch_gamma_pins as jpins

    return tuple(np.asarray(a) for a in
                 jpins(jstack(probs, np.float32), _jax_settings(s)))


def _both(probs, s, x_ws=None, y_ws=None, pins=(None, None), chunk=0):
    """(reference outputs, port outputs), each a list of numpy arrays; the
    reference runs in one call, the port in `chunk`-iteration launches."""
    from qpalm_tpu.batch import stack_problems as jstack
    from qpalm_tpu.solver.fused import solve_batch_fused as jsolve

    ref = jsolve(jstack(probs, np.float32), _jax_settings(s), x_ws=x_ws,
                 y_ws=y_ws, gamma_init=pins[0], gamma_max=pins[1],
                 interpret=True)
    got = F.solve_batch_fused(stack_problems(probs, np.float32), s,
                              x_ws=x_ws, y_ws=y_ws, chunk=chunk,
                              gamma_init=pins[0], gamma_max=pins[1])
    return [np.asarray(a) for a in ref], [a.numpy() for a in got]


def _assert_parity(ref, got, min_equal_iters=126):
    assert np.array_equal(got[2], ref[2])
    same = got[3] == ref[3]
    assert same.sum() >= min_equal_iters, np.where(~same)
    # solutions are compared where both solved in the same count
    same &= ref[2] == C.QPALM_SOLVED
    assert np.max(np.abs(got[0] - ref[0])[same]) < 1e-4
    assert np.max(np.abs(got[1] - ref[1])[same]) < 1e-3


@pytest.mark.parametrize("scaling,proximal", [(2, True), (0, True),
                                              (2, False)])
def test_plain_twin_matches_reference_kernel(scaling, proximal):
    pytest.importorskip("jax")
    probs = [random_convex_qp(16, 24, seed=60 + i, density=0.5)
             for i in range(B)]
    ref, got = _both(probs, _settings(scaling, proximal=proximal))
    assert np.all(ref[2] == C.QPALM_SOLVED)
    _assert_parity(ref, got)


def test_plain_twin_certificates_match_reference_kernel():
    pytest.importorskip("jax")
    probs = [PRIMAL_INFEASIBLE, DUAL_INFEASIBLE] + [
        random_convex_qp(8, 12, seed=160 + i, density=0.5)
        for i in range(B - 2)]
    ref, got = _both(probs, _settings(2))
    assert ref[2][0] == C.QPALM_PRIMAL_INFEASIBLE
    assert ref[2][1] == C.QPALM_DUAL_INFEASIBLE
    # an infeasible lane's iterates diverge, so rounding steers its
    # trajectory: its status, not its iteration count, is held to the
    # reference (the two lanes fit in the bar's 2-lane allowance)
    _assert_parity(ref, got)
    # certificates (termination.c:136-240): A'dy ~ 0 with a negative
    # support function over the finite bounds; a descent direction along
    # the free variable
    Q, A, q, bl, bu = PRIMAL_INFEASIBLE
    dy = got[6][0, :3].astype(np.float64)
    assert np.abs(A.T @ dy).max() / np.abs(dy).max() < 1e-4
    fin_l, fin_u = np.abs(bl) < 1e20, np.abs(bu) < 1e20
    support = np.sum(np.where(fin_u, bu * np.maximum(dy, 0), 0)
                     + np.where(fin_l, bl * np.minimum(dy, 0), 0))
    assert support < 0
    dx = got[7][1, :1].astype(np.float64)
    assert dx[0] > 0 and DUAL_INFEASIBLE[2] @ dx < 0
    assert np.array_equal(got[7][1], ref[7][1])


def test_plain_twin_warm_start_matches_reference_kernel():
    pytest.importorskip("jax")
    probs = [random_convex_qp(12, 18, seed=70 + i, density=0.5)
             for i in range(B)]
    s = _settings(2)
    ref, _ = _both(probs, s)
    x0, y0 = ref[0], ref[1]
    ref2, got2 = _both(probs, s, x_ws=x0, y_ws=y0)
    assert np.all(got2[2] == C.QPALM_SOLVED)
    assert np.array_equal(got2[2], ref2[2])
    # as tests/test_fused.py:113-118: the warm start's Qx is rebuilt with
    # another f32 summation order, so a lane at the tolerance boundary may
    # run one more inner cycle; that must stay rare
    diff = np.abs(got2[3] - ref2[3])
    assert np.mean(diff > 0) <= 0.05, diff
    assert got2[3].max() < ref[3].max()


def test_plain_twin_nonconvex_matches_reference_kernel():
    pytest.importorskip("jax")
    probs = _nonconvex_family()
    s = _settings(2, nonconvex=True, max_iter=400)
    ref, got = _both(probs, s, pins=_jax_pins(probs, s))
    assert np.mean(ref[2] == C.QPALM_SOLVED) > 0.9
    _assert_parity(ref, got, min_equal_iters=B)


def test_plain_twin_dual_termination_matches_reference_kernel():
    pytest.importorskip("jax")
    probs = [random_convex_qp(16, 24, seed=90 + i, density=0.5)
             for i in range(B)]
    s = _settings(2, enable_dual_termination=True, dual_objective_limit=-1.0)
    ref, got = _both(probs, s)
    assert (ref[2] == C.QPALM_DUAL_TERMINATED).any()
    assert (ref[2] == C.QPALM_SOLVED).any()
    _assert_parity(ref, got, min_equal_iters=B)


def test_plain_twin_chunked_equals_single_call():
    pytest.importorskip("jax")
    probs = [random_convex_qp(12, 18, seed=90 + i, density=0.5)
             for i in range(B)]
    s = _settings(2, max_iter=60)
    ref, chunked = _both(probs, s, chunk=13)
    single = [a.numpy() for a in
              F.solve_batch_fused(stack_problems(probs, np.float32), s)]
    for a, b in zip(chunked, single):
        assert np.array_equal(a, b, equal_nan=True)
    assert np.array_equal(chunked[2], ref[2])


def test_plain_twin_chunked_keeps_certificates():
    """tests/test_fused.py:283-303: a Farkas certificate found in an early
    chunk survives the later launches."""
    probs = [random_convex_qp(8, 12, seed=100 + i, density=0.5)
             for i in range(B)]
    Q, A, q, bl, bu = probs[3]
    A2 = A.copy()
    A2[1] = A2[0]
    bl2, bu2 = bl.copy(), bu.copy()
    bl2[0], bu2[0] = 1.0, 2.0
    bl2[1], bu2[1] = 3.0, 4.0  # contradictory duplicate row
    probs[3] = (Q, A2, q, bl2, bu2)
    s = _settings(2, max_iter=120)
    data = stack_problems(probs, np.float32)
    out = F.solve_batch_fused(data, s, chunk=10)
    assert out[2][3] == C.QPALM_PRIMAL_INFEASIBLE
    cert = out[6][3, :12].numpy().astype(np.float64)
    assert np.abs(cert).max() > 0  # not zeroed by a later chunk
    assert np.abs(A2.T @ cert).max() <= 1e-3 * np.abs(cert).max()
    single = F.solve_batch_fused(data, s)
    for a, b in zip(out, single):
        assert torch.equal(a, b)


# the routes K1 does not take, each to the general loop, with the settings
# that send it there
OUT_OF_SLICE = {
    "use_fused_never": dict(use_fused="never"),
    "refinement": dict(max_refine=2),
    "time_limit": dict(time_limit=10.0),
    "n_pad_360": dict(max_iter=2),
    "solve_many_escalate": dict(max_iter=5, use_fused="never"),
    "solve_batch_escalate": dict(max_iter=5, use_fused="never"),
    "kkt": dict(factorization_method=C.FACTORIZE_KKT),
    # CG runs the general loop (K1 never takes it), as the reference's
    # vmapped CG does
    "cg": dict(factorization_method=C.FACTORIZE_CG),
    # block Thomas, stage_block 4 of n_pad 8
    "stage": dict(factorization_method=C.FACTORIZE_STAGE, stage_block=4),
}


@pytest.mark.parametrize("route", list(OUT_OF_SLICE))
def test_out_of_slice_route_matches_reference(route):
    """What K1 does not take routes to the general loop and matches the
    reference's general loop at the f32 bar: use_fused='never',
    refinement, a time limit, a shape past K1's streaming tier, the f64
    escalation (solve_many and solve_batch_escalate), FACTORIZE_KKT,
    FACTORIZE_CG and FACTORIZE_STAGE."""
    pytest.importorskip("jax")
    from qpalm_tpu import batch as jbatch

    s = _settings(2, **OUT_OF_SLICE[route])
    probs = [random_convex_qp(360, 8, seed=2) if route == "n_pad_360"
             else random_convex_qp(4, 6, seed=1)]
    if route == "solve_many_escalate":
        many = solve_many(probs, s, escalate=True, device="cpu")
        want = jbatch.solve_many(probs, _js(s), escalate=True)
        assert np.array_equal(many.status, want.status)
        assert np.array_equal(many.iterations, want.iterations)
        return
    if route == "solve_batch_escalate":
        got = solve_batch_escalate(probs, s, device="cpu")
        want = jbatch.solve_batch_escalate(probs, _js(s))
    else:
        got = solve_batch(probs, s, device="cpu")
        want = jbatch.solve_batch(probs, _js(s))
    assert np.array_equal(got.status.numpy(), np.asarray(want.status))
    if route not in ("n_pad_360", "solve_batch_escalate"):
        assert np.array_equal(got.iterations.numpy(),
                              np.asarray(want.iterations))
    assert np.abs(got.x.numpy() - np.asarray(want.x)).max() < 1e-4


def test_negative_chunk_raises():
    probs = [random_convex_qp(4, 6, seed=1)]
    with pytest.raises(ValueError, match="chunk"):
        F.solve_batch_fused(stack_problems(probs, np.float32), _settings(2),
                            chunk=-1)


def test_plain_twin_reports_max_iter():
    probs = [random_convex_qp(8, 12, seed=80 + i, density=0.5)
             for i in range(16)]
    s = Settings(dtype="float32", eps_abs=1e-12, eps_rel=0.0, max_iter=7,
                 scaling=2, max_refine=0, delta=10.0)
    out = F.solve_batch_fused(stack_problems(probs, np.float32), s)
    assert np.all(out[2].numpy() == C.QPALM_MAX_ITER_REACHED)
    assert np.all(out[3].numpy() == 7)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,proximal,tier", [
    (16, 24, True, "convex"), (16, 24, False, "convex"),
    (8, 300, True, "convex"),  # m > 256
    (64, 96, True, "convex"),  # the headline shape (bench.py:74-76)
    (8, 8, True, "nonconvex"), (16, 24, True, "dual")])
def test_cuda_kernel_matches_plain_twin(n, m, proximal, tier):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    pins = (None, None)
    if tier == "nonconvex":
        probs = _nonconvex_family()[:64]
        s = _settings(2, nonconvex=True, max_iter=400)
    else:
        # a zero Hessian needs the proximal term (test_infeasibility.py:64)
        head = [PRIMAL_INFEASIBLE] + ([DUAL_INFEASIBLE] if proximal else [])
        probs = head + [random_convex_qp(n, m, seed=260 + i, density=0.5)
                        for i in range(64 - len(head))]
        s = _settings(2, proximal=proximal,
                      enable_dual_termination=tier == "dual",
                      dual_objective_limit=-1.0)
    data = stack_problems(probs, np.float32, device="cuda")
    if tier == "nonconvex":
        pins = batch_gamma_pins(data, s)
        s = s.replace(proximal=True)
    before = F.fused_palm.launches
    got = [a.cpu().numpy() for a in F.solve_batch_fused(
        data, s, gamma_init=pins[0], gamma_max=pins[1])]
    assert F.fused_palm.launches == before + 1
    if tier == "dual":
        assert (got[2] == C.QPALM_DUAL_TERMINATED).any()
    sd, scal, st = F._prepare(data, s, gamma_init=pins[0],
                              gamma_max=pins[1])
    plain = [a.cpu().numpy() for a in F._finish(
        sd, scal, F.fused_palm_plain(sd, scal, st, s.max_iter, s))]
    # the kernel keeps every entry's arithmetic and every sum's order of its
    # twin: every output equal on every lane (NaN equal to NaN)
    for a, b in zip(got, plain):
        assert np.array_equal(a, b, equal_nan=True)
    again = [a.cpu().numpy() for a in F.solve_batch_fused(
        data, s, gamma_init=pins[0], gamma_max=pins[1])]
    for a, b in zip(got, again):
        assert np.array_equal(a, b, equal_nan=True)  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("qa_panel", [0, 8])
def test_cuda_profiled_launch_keeps_the_state(qa_panel):
    """A launch with `fused_palm.profile` set (the on-chip tier runs a build
    with the cycle counters) ends in the state of one without, and appends
    one counter row a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    probs = [random_convex_qp(16, 24, seed=300 + i, density=0.5)
             for i in range(32)]
    s = _settings(2)
    sd, scal, st = F._prepare(stack_problems(probs, np.float32,
                                             device="cuda"), s)
    ref = F.fused_palm(sd, scal, st, s.max_iter, s, qa_panel)
    F.fused_palm.profile = []
    try:
        out = F.fused_palm(sd, scal, st, s.max_iter, s, qa_panel)
        prof = F.fused_palm.profile
    finally:
        F.fused_palm.profile = None
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    names = F.PROFILE_SECTIONS if qa_panel else F.SMEM_PROFILE_SECTIONS
    assert len(prof) == 1 and prof[0].shape == (32, len(names) + 1)
    cycles = prof[0].cpu()
    assert (cycles >= 0).all() and (cycles[:, -1] > 0).all()
    assert (cycles[:, :-1].sum(1) <= cycles[:, -1]).all()
    split = F.profile_split(prof[0], 1.0)
    assert list(split) == [*names, "rest"]


@pytest.mark.cuda
def test_cuda_smem_mirror_matches_library():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from qpalm_tpu_torch._build import kernels

    lib = kernels()
    for n, m in ((8, 8), (16, 24), (64, 96), (64, 80), (96, 144), (200, 8)):
        assert F.fused_smem_bytes(n, m) == lib.qp_fused_smem_bytes(n, m)
        assert F.fused_smem_bytes(n, m, True) == \
            lib.qp_fused_stream_smem_bytes(n, m)
