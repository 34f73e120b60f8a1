"""Padding, stacking and Ruiz scaling of the PyTorch port against
qpalm_tpu.batch.stack_problems and qpalm_tpu.scaling.scale_data; the
in-place stack against `pad_problem` a problem and `np.stack`, its f32
cast against the f32 stack, the benchmark round's K1 input, and the
page-locked stack on a card."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from helpers import random_convex_qp
from qpalm_tpu_torch import bench
from qpalm_tpu_torch.batch import _PAD_BOUND, pad_problem, stack_problems
from qpalm_tpu_torch.scaling import scale_data
from qpalm_tpu_torch.types import QPData, qpdata_from_numpy
from qpalm_tpu_torch.workloads import make_problems
import torch_support  # noqa: F401


def _mixed_problems():
    probs = [random_convex_qp(n, m, seed=10 + i, density=0.5)
             for i, (n, m) in enumerate([(5, 7), (12, 3), (9, 18), (16, 24)])]
    Q, A, q, bl, bu = random_convex_qp(6, 4, seed=20)
    bl[0], bu[1] = -1e30, 1e30  # beyond the padding bound: clipped
    probs.append((sp.csc_matrix(Q), sp.csc_matrix(A), q, bl, bu, 2.5))
    return probs


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stack_problems_matches_reference(dtype):
    pytest.importorskip("jax")
    from qpalm_tpu.batch import stack_problems as jstack

    probs = _mixed_problems()
    ref = jstack(probs, dtype)
    got = stack_problems(probs, dtype)
    for name in ref._fields:
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert np.array_equal(g, r), name


def _padded_and_stacked(probs, dtype, pad_multiple=8):
    """The stack as one `pad_problem` a problem, the bounds clipped to
    +-1e21, then `np.stack`."""
    n_pad = -(-max(p[0].shape[0] for p in probs) // pad_multiple) \
        * pad_multiple
    m_pad = -(-max(p[1].shape[0] for p in probs) // pad_multiple) \
        * pad_multiple
    pieces = []
    for p in probs:
        dense = [M.toarray() if sp.issparse(M) else M for M in p[:2]]
        Qp, Ap, qp, bl, bu = pad_problem(
            *dense, *(np.asarray(v, float).ravel() for v in p[2:5]),
            n_pad, m_pad, dtype)
        pieces.append((Qp, Ap, qp, np.maximum(bl, -_PAD_BOUND),
                       np.minimum(bu, _PAD_BOUND)))
    return [np.stack(a) for a in zip(*pieces)] + [
        np.asarray([p[5] if len(p) > 5 else 0.0 for p in probs], dtype)]


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stack_in_place_equals_padded_problems_stacked(dtype):
    probs = _mixed_problems()
    want = _padded_and_stacked(probs, dtype)
    got = stack_problems(probs, dtype)
    for name, w, g in zip(QPData._fields, want, got):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), name


def _wide_bounds():
    """_mixed_problems with bounds of +-1e30, beyond the f32 range, and
    values that round to f32 (1e21 itself among them)."""
    probs = _mixed_problems()
    Q, A, q, bl, bu = (np.array(a, float) for a in probs[2][:5])
    bl[:5] = [-1e30, -4e38, -1e21, -1.0000001e21, -np.inf]
    bu[:5] = [1e30, 1e39, 1e21, 0.9999999e21, np.inf]
    bu[5] = 1 / 3
    probs[2] = (Q, A, q, bl, bu)
    return probs


@pytest.mark.parametrize("make", [_mixed_problems, _wide_bounds])
def test_f64_stack_cast_equals_f32_stack(make):
    probs = make()
    s32 = stack_problems(probs, np.float32)
    s64 = stack_problems(probs, np.float64)
    for name, a, b in zip(QPData._fields, s32, s64):
        assert torch.equal(_bits(b.float()), _bits(a)), name


def test_round_hands_k1_the_f32_stack(monkeypatch):
    """`bench._round` stacks once in f64 and casts on the device: K1 gets
    the f32 stack bit for bit, the polish and the host the f64 one."""
    probs = make_problems(3, 16, 24, seed=5)
    Q, A, q, bl, bu = probs[1][:5]
    bl, bu = bl.copy(), bu.copy()
    bl[0], bu[1], bu[2] = -1e30, 1e39, 1 / 3
    probs[1] = (Q, A, q, bl, bu) + tuple(probs[1][5:])
    seen = {}
    solve, polish = bench.F.solve_batch_fused, bench.polish_batch

    def k1(data, *a, **k):
        seen["k1"] = data
        return solve(data, *a, **k)

    def pol(data, *a, **k):
        seen["polish"] = data
        return polish(data, *a, **k)

    monkeypatch.setattr(bench.F, "solve_batch_fused", k1)
    monkeypatch.setattr(bench, "polish_batch", pol)
    ok, _, h64, phases, _ = bench._round(probs, torch.device("cpu"), False)
    assert sorted(phases) == ["copy", "enqueue", "flag_fetch", "stack"]
    s32 = stack_problems(probs, np.float32)
    s64 = stack_problems(probs, np.float64)
    for name, a, k1, b, pol, h in zip(QPData._fields, s32, seen["k1"], s64,
                                      seen["polish"], h64):
        assert k1.dtype == torch.float32, name
        assert torch.equal(_bits(k1), _bits(a)), name
        assert torch.equal(_bits(pol), _bits(b)), name
        assert torch.equal(_bits(torch.from_numpy(h)), _bits(b)), name


@pytest.mark.cuda
def test_cuda_stack_is_page_locked():
    """On a card: `pin_memory=True` stacks into page-locked memory with
    the same values, a CUDA `device` pins on its own, and the counter
    says how many bytes were written there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from qpalm_tpu_torch import trace

    probs = _mixed_problems()
    plain = stack_problems(probs, np.float64)
    pinned = stack_problems(probs, np.float64, pin_memory=True)
    for name, a, b in zip(QPData._fields, plain, pinned):
        assert b.is_pinned() and not a.is_pinned(), name
        assert torch.equal(_bits(a), _bits(b)), name
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        on_card = stack_problems(probs, np.float64, device="cuda")
    finally:
        trace.disable()
    assert trace.drain().counters == {
        "stack.pinned_bytes": sum(t.nbytes for t in plain)}
    for name, a, b in zip(QPData._fields, plain, on_card):
        assert b.is_cuda and torch.equal(_bits(a), _bits(b.cpu())), name


def test_qpdata_from_numpy_keeps_arrays():
    probs = _mixed_problems()
    d = stack_problems(probs, np.float64)
    back = qpdata_from_numpy(*(t.numpy() for t in d), device="cpu")
    for a, b in zip(d, back):
        assert torch.equal(a, b)


@pytest.mark.parametrize("iters", [0, 2, 10])
def test_scale_data_matches_reference(iters):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from qpalm_tpu.batch import stack_problems as jstack
    from qpalm_tpu.scaling import scale_data as jscale

    probs = [random_convex_qp(12, 18, seed=30 + i, density=0.5)
             for i in range(8)]
    jd = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                      jstack(probs, np.float32))
    rs, rscal = jax.vmap(lambda d: jscale(d, iters))(jd)
    gs, gscal = scale_data(stack_problems(probs, np.float32), iters)

    def close(r, g, name):
        r = np.asarray(r)
        g = g.numpy()
        assert g.dtype == np.float32, name
        err = np.max(np.abs(g - r)) / max(np.max(np.abs(r)), 1e-30)
        assert err < 1e-6, (name, err)

    for name in ("D", "Dinv", "E", "Einv", "c", "cinv"):
        close(getattr(rscal, name), getattr(gscal, name), name)
    for name in ("Q", "A", "q"):
        close(getattr(rs, name), getattr(gs, name), name)
    # the bounds hold the +-1e21 padding; compare the finite rows
    for name in ("bmin", "bmax"):
        r = np.asarray(getattr(rs, name))
        g = getattr(gs, name).numpy()
        fin = np.abs(r) < 1e20
        assert np.allclose(g[fin], r[fin], rtol=1e-6, atol=0), name
        assert np.allclose(g[~fin], r[~fin], rtol=1e-6), name
