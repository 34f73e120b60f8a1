"""K1's streaming tier in the PyTorch port: the plain twin forced to stream
against qpalm_tpu.solver.fused.solve_batch_fused(interpret=True,
qa_panel=8) at the bars of tests/test_fused.py:60-93, against the port's
on-chip twin, the memory plan and routing of the workloads sweep's rows,
and (on a card) the CUDA streaming kernel against its twin."""

import numpy as np
import pytest
import torch

from helpers import random_convex_qp
from qpalm_tpu_torch import constants as C
from qpalm_tpu_torch.batch import _not_fused, solve_batch, stack_problems
from qpalm_tpu_torch.solver import fused as F
from qpalm_tpu_torch.sweep import ROWS, row_problems
from torch_support import _js, _settings

B = 128  # the reference kernel takes whole 128-lane blocks


def _probs(seed):
    return [random_convex_qp(16, 24, seed=seed + i, density=0.5)
            for i in range(B)]


def _reference_stream(probs, s):
    """The reference's streaming kernel (P = 8 row panels) in interpret
    mode, as numpy arrays."""
    import qpalm_tpu
    from qpalm_tpu.batch import stack_problems as jstack
    from qpalm_tpu.solver.fused import solve_batch_fused as jsolve

    js = qpalm_tpu.Settings(**{k: getattr(s, k) for k in (
        "dtype", "eps_abs", "eps_rel", "max_iter", "scaling", "max_refine",
        "delta", "enable_dual_termination", "dual_objective_limit")})
    return [np.asarray(a) for a in jsolve(jstack(probs, np.float32), js,
                                          interpret=True, qa_panel=8)]


def _port(probs, s, qa_panel):
    return [a.numpy() for a in F.solve_batch_fused(
        stack_problems(probs, np.float32), s, qa_panel=qa_panel)]


def _assert_parity(ref, got):
    """tests/test_fused.py's bars: statuses 128/128, iteration counts on
    at least 126/128, x and y where both finished (solved or
    dual-terminated) in the same count."""
    assert np.array_equal(got[2], ref[2])
    same = got[3] == ref[3]
    assert same.sum() >= B - 2, np.where(~same)
    same &= np.isin(ref[2], (C.QPALM_SOLVED, C.QPALM_DUAL_TERMINATED))
    assert np.max(np.abs(got[0] - ref[0])[same]) < 1e-4
    assert np.max(np.abs(got[1] - ref[1])[same]) < 1e-3


@pytest.mark.parametrize("case", ["scaling2", "scaling0", "dual"])
def test_stream_twin_matches_reference_stream_kernel(case):
    """Seeds and settings of tests/test_fused.py:60-93.  The streaming twin
    is also held against the port's on-chip twin: same statuses and counts
    (the two assembly orders round apart, so x only to f32 rounding)."""
    pytest.importorskip("jax")
    if case == "dual":
        probs = _probs(91)
        s = _settings(2, enable_dual_termination=True,
                      dual_objective_limit=-1e9)
    else:
        probs = _probs(61)
        s = _settings(2 if case == "scaling2" else 0)
    ref = _reference_stream(probs, s)
    got = _port(probs, s, qa_panel=8)
    assert np.all(ref[2] == (C.QPALM_DUAL_TERMINATED if case == "dual"
                             else C.QPALM_SOLVED))
    _assert_parity(ref, got)
    smem = _port(probs, s, qa_panel=0)
    assert np.array_equal(smem[2], got[2])
    assert np.array_equal(smem[3], got[3])
    assert np.max(np.abs(smem[0] - got[0])) < 1e-4


def _osqp_probs(n, count, seed):
    """`count` problems of OSQP's random QP class at n, m = 10 n (the
    benchmark's generator, portbench/reference/generators)."""
    from portbench.reference.generators import osqp_random_qp

    cfg = dict(n=n, m=10 * n, density=0.15, alpha=1e-2)
    return osqp_random_qp.problems(cfg, count, seed)


@pytest.mark.parametrize("shape", ["m=1.5n", "m=10n"])
def test_stream_order_differs_from_on_chip_order(shape):
    """The tier switch reaches the assembly: the two orders agree on every
    status and count but not bit for bit, at n = 16, m = 24 and on OSQP's
    random QP class at n = 16, m = 160 (the streaming twin forced where
    the shape fits on chip); x to f32 rounding."""
    probs = _probs(61)[:16] if shape == "m=1.5n" else _osqp_probs(16, 16, 7)
    s = _settings(2)
    a, b = _port(probs, s, qa_panel=0), _port(probs, s, qa_panel=8)
    assert F.pick_tier(16, len(probs[0][3])) == "smem"
    assert np.array_equal(a[2], b[2])
    assert np.array_equal(a[3], b[3])
    assert not np.array_equal(a[0], b[0])
    assert np.max(np.abs(a[0] - b[0])) < 1e-4


def _expected_tier(family, size):
    """Tiers of the sweep's rows from the reference's plan: randomQP
    n <= 128, lasso(20) and portfolio(60) fit on chip."""
    on_chip = {("randomQP", n) for n in (20, 40, 60, 80, 100, 128)} | {
        ("lasso", 20), ("portfolio", 60)}
    return "smem" if (family, size) in on_chip else "stream"


@pytest.mark.parametrize("family,size", ROWS)
def test_sweep_rows_are_admitted_with_their_tier(family, size):
    Q, A = row_problems(family, size, batch=1)[0][:2]
    n_pad = -(-Q.shape[0] // 8) * 8
    m_pad = -(-A.shape[0] // 8) * 8
    s = _settings(2, max_iter=400)
    assert _not_fused(s, n_pad, m_pad) is None
    assert F.pick_tier(n_pad, m_pad) == _expected_tier(family, size)


def test_shape_past_the_streaming_rule_matches_reference():
    """n_pad 360 has no fused plan: solve_batch takes the general loop
    there, as the reference does, and matches it (two iterations at
    f32)."""
    pytest.importorskip("jax")
    from qpalm_tpu.batch import solve_batch as jsolve

    probs = [random_convex_qp(360, 360, seed=3)]
    s = _settings(2, max_iter=2)
    got = solve_batch(probs, s, device="cpu")
    want = jsolve(probs, _js(s))
    assert np.array_equal(got.status.numpy(), np.asarray(want.status))
    assert np.array_equal(got.iterations.numpy(),
                          np.asarray(want.iterations))
    assert np.abs(got.x.numpy() - np.asarray(want.x)).max() < 1e-4


def test_shapes_past_the_streaming_rule_raise():
    """K1 itself refuses n_pad 360, past the streaming tier's last plan at
    352, and a negative qa_panel."""
    assert F.pick_tier(352, 352) == "stream"
    assert F.pick_tier(360, 360) is None
    data = stack_problems([random_convex_qp(360, 360, seed=3)], np.float32)
    with pytest.raises(NotImplementedError, match="general solver loop"):
        F.solve_batch_fused(data, _settings(2))
    with pytest.raises(ValueError, match="qa_panel"):
        F.solve_batch_fused(data, _settings(2), qa_panel=-1)


def _bit_identical_to_twin(n, m):
    """The streaming kernel and its twin from the same state, every state
    tensor bit-equal: randomQP n=352 (the sweep's widest row, its settings)
    for 5 iterations, or n, m stacked to a multiple of 4 and forced to
    stream for 40."""
    from qpalm_tpu_torch.sweep import S32, row_problems

    if n == 352:
        probs, T, pad = row_problems("randomQP", 352), 5, 8
    elif m == 10 * n:
        probs, T, pad = _osqp_probs(n, 32, 905), 40, 8
    else:
        probs = [random_convex_qp(n, m, seed=900 + i, density=0.5)
                 for i in range(32)]
        T, pad = 40, 4
    data = stack_problems(probs, np.float32, pad_multiple=pad, device="cuda")
    sd, scal, st = F._prepare(data, S32)
    got = F.fused_palm(sd, scal, st, T, S32, qa_panel=8)
    want = F.fused_palm_plain(sd, scal, st, T, S32, stream=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,tier", [
    (16, 24, "convex"), (16, 24, "plain"), (16, 24, "dual"),
    (8, 8, "nonconvex"), (16, 24, "warm"), (160, 160, "convex"),
    (352, 352, "bits"), (140, 100, "bits"), (256, 2560, "bits")])
def test_cuda_stream_kernel_matches_plain_twin(n, m, tier):
    """Every flag of the on-chip tier in the streaming one: proximal or
    plain, dual termination, nonconvex pins, warm start; and launches of a
    few iterations resume exactly.  "bits": kernel = twin bit for bit at
    n=352, at n=140, m=100 (4-wide edge tiles, a ragged Cholesky panel
    of 12 rows, a ragged A panel of 4) and at n=256, m=2560 (OSQP's random
    QP class: 19 m-vectors in 48,640 of the block's 58,112 floats, A in
    panels of 16 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    if tier == "bits":
        return _bit_identical_to_twin(n, m)
    from qpalm_tpu_torch.solver.nonconvex import batch_gamma_pins

    pins = (None, None)
    kw = {}
    ws = dict(x_ws=None, y_ws=None)
    if tier == "nonconvex":
        rng = np.random.default_rng(42)
        probs = []
        for _ in range(32):
            Q = rng.standard_normal((n, n))
            probs.append((0.5 * (Q + Q.T) - 1.5 * np.eye(n), np.eye(n),
                          rng.standard_normal(n), -np.ones(n), np.ones(n)))
        kw = dict(nonconvex=True, max_iter=400)
    else:
        probs = [random_convex_qp(n, m, seed=360 + i, density=0.5)
                 for i in range(32)]
        if tier == "dual":
            kw = dict(enable_dual_termination=True, dual_objective_limit=-1.0)
        if tier == "plain":
            kw = dict(proximal=False)
    s = _settings(2, **kw)
    data = stack_problems(probs, np.float32, device="cuda")
    if tier == "nonconvex":
        pins = batch_gamma_pins(data, s)
        s = s.replace(proximal=True)
    if tier == "warm":
        cold = F.solve_batch_fused(data, s, qa_panel=8)
        ws = dict(x_ws=1.01 * cold[0], y_ws=cold[1])
    before = F.fused_palm.stream_launches
    got = [a.cpu().numpy() for a in F.solve_batch_fused(
        data, s, gamma_init=pins[0], gamma_max=pins[1], qa_panel=8, **ws)]
    assert F.fused_palm.stream_launches == before + 1
    sd, scal, st = F._prepare(data, s, gamma_init=pins[0],
                              gamma_max=pins[1], **ws)
    plain = [a.cpu().numpy() for a in F._finish(sd, scal, F.fused_palm_plain(
        sd, scal, st, s.max_iter, s, stream=True))]
    assert np.array_equal(got[2], plain[2])
    same = got[3] == plain[3]
    assert same.sum() >= 30
    assert np.max(np.abs(got[0] - plain[0])[same]) < 1e-4
    chunked = [a.cpu().numpy() for a in F.solve_batch_fused(
        data, s, gamma_init=pins[0], gamma_max=pins[1], qa_panel=8,
        chunk=7, **ws)]
    for a, b in zip(got, chunked):
        assert np.array_equal(a, b, equal_nan=True)
