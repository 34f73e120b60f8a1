"""Nonconvex gamma pins of the PyTorch port (qpalm_tpu_torch.solver.
nonconvex) against qpalm_tpu.solver.nonconvex: the batched LOBPCG against
the vmapped one on the same seeded Q and start vectors, the pins of
batch_gamma_pins, and the numpy helpers, which are copies."""

import dataclasses

import numpy as np
import pytest
import torch

from qpalm_tpu_torch.batch import stack_problems
from qpalm_tpu_torch.linalg.dense import norm_inf, norm_two
from qpalm_tpu_torch.solver.nonconvex import (
    batch_gamma_pins, lobpcg_min_eig, lobpcg_min_eig_np, min_eig_settings)
from qpalm_tpu_torch.types import Settings
import torch_support  # noqa: F401

NC = dict(dtype="float32", nonconvex=True, eps_abs=1e-4, eps_rel=1e-4,
          max_iter=400, scaling=2, max_refine=0, delta=10.0)


def _matrices(B=16, n=12, seed=5):
    """Symmetric Q, indefinite on even lanes and PD on odd ones, and
    normalized start vectors, in f64."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    Q = 0.5 * (G + np.transpose(G, (0, 2, 1)))
    Q[1::2] = G[1::2] @ np.transpose(G[1::2], (0, 2, 1)) + 0.1 * np.eye(n)
    v = rng.random((B, n))
    return Q, v / np.linalg.norm(v, axis=1, keepdims=True)


def _jax_lobpcg(Q, v):
    import jax
    import jax.numpy as jnp
    from qpalm_tpu.solver.nonconvex import lobpcg_min_eig as jlobpcg

    return np.asarray(jax.jit(jax.vmap(jlobpcg))(jnp.asarray(Q),
                                                 jnp.asarray(v)))


@pytest.mark.parametrize("dtype,rel", [(np.float64, 1e-8),
                                       (np.float32, 1e-4)])
def test_lobpcg_matches_reference(dtype, rel):
    pytest.importorskip("jax")
    Q, v = (a.astype(dtype) for a in _matrices())
    ref = _jax_lobpcg(Q, v)
    got = lobpcg_min_eig(torch.from_numpy(Q), torch.from_numpy(v)).numpy()
    assert got.dtype == dtype
    # where the reference's f32 Gram-matrix Cholesky fails it returns NaN;
    # the port stops that lane with its Ritz pair, a valid lower bound
    fin = np.isfinite(ref)
    assert fin.sum() >= len(ref) - 1
    err = np.abs(got - ref)[fin] / np.maximum(1.0, np.abs(ref[fin]))
    assert err.max() < rel, err.max()
    lam = np.linalg.eigvalsh(Q.astype(np.float64))[:, 0]
    assert np.all(got <= lam)
    assert np.all(lam - got < 1e-3 * np.maximum(1.0, np.abs(lam)))


def test_lobpcg_is_a_lower_bound_of_the_spectrum():
    Q, v = _matrices(B=24, n=20, seed=6)
    got = lobpcg_min_eig(torch.from_numpy(Q), torch.from_numpy(v)).numpy()
    lam = np.linalg.eigvalsh(Q)[:, 0]
    assert np.all(got <= lam)
    assert np.all(lam - got < 1e-4 * np.maximum(1.0, np.abs(lam)))


def test_lobpcg_lane_with_nan_leaves_the_others_alone():
    """A lane whose small eigenproblems are not finite gets NaN, as in the
    reference, and neither stops the batch nor changes its other lanes."""
    Q, v = _matrices(B=8, n=10, seed=7)
    clean = lobpcg_min_eig(torch.from_numpy(Q), torch.from_numpy(v)).numpy()
    Q[3, 2, 5] = Q[3, 5, 2] = np.nan
    got = lobpcg_min_eig(torch.from_numpy(Q), torch.from_numpy(v)).numpy()
    assert np.isnan(got[3])
    keep = np.arange(8) != 3
    assert np.array_equal(got[keep], clean[keep])


def _nonconvex_family(B=64):
    rng = np.random.default_rng(42)
    probs = []
    for i in range(B):
        Q = rng.standard_normal((8, 8))
        Q = 0.5 * (Q + Q.T) - 1.5 * np.eye(8) if i % 2 == 0 \
            else Q @ Q.T + 0.1 * np.eye(8)
        probs.append((Q, np.eye(8), rng.standard_normal(8), -np.ones(8),
                      np.ones(8)))
    return probs


@pytest.mark.parametrize("scaling", [2, 0])
def test_batch_gamma_pins_match_reference(scaling):
    pytest.importorskip("jax")
    import qpalm_tpu
    from qpalm_tpu.batch import stack_problems as jstack
    from qpalm_tpu.solver.nonconvex import batch_gamma_pins as jpins

    probs = _nonconvex_family()
    s = Settings(**{**NC, "scaling": scaling})
    ref = [np.asarray(a) for a in
           jpins(jstack(probs, np.float32),
                 qpalm_tpu.Settings(**dataclasses.asdict(s)))]
    got = [a.numpy() for a in
           batch_gamma_pins(stack_problems(probs, np.float32), s)]
    for r, g in zip(ref, got):
        assert g.dtype == np.float32 and g.shape == (64,)
        # the same lanes are pinned, at pins within f32 LOBPCG's rounding
        assert np.array_equal(r < s.gamma_max, g < s.gamma_max)
        assert np.max(np.abs(g - r) / r) < 1e-4
    assert (got[1] < s.gamma_max).sum() == 32  # the indefinite half


@pytest.mark.parametrize("n", [2, 3, 12, 30])
def test_lobpcg_min_eig_np_equals_reference(n):
    pytest.importorskip("jax")
    from qpalm_tpu.solver.nonconvex import lobpcg_min_eig_np as jnp_lobpcg

    rng = np.random.default_rng(n)
    G = rng.standard_normal((n, n))
    Q = 0.5 * (G + G.T)
    assert lobpcg_min_eig_np(lambda v: Q @ v, n, seed=3) == \
        jnp_lobpcg(lambda v: Q @ v, n, seed=3)


@pytest.mark.parametrize("lam", [-2.5, 0.7])
def test_min_eig_settings_equals_reference(lam):
    pytest.importorskip("jax")
    import qpalm_tpu
    from qpalm_tpu.solver.nonconvex import min_eig_settings as jmin

    s = Settings(nonconvex=True, proximal=False)
    ref = jmin(lam, qpalm_tpu.Settings(**dataclasses.asdict(s)))
    assert dataclasses.asdict(min_eig_settings(lam, s)) == \
        dataclasses.asdict(ref)


def test_norms_reduce_the_last_axis():
    v = torch.tensor([[3.0, -4.0], [0.0, 1.0]])
    assert torch.equal(norm_inf(v), torch.tensor([4.0, 1.0]))
    assert torch.equal(norm_two(v), torch.tensor([5.0, 1.0]))
    assert norm_inf(torch.zeros((2, 0))).shape == (2,)


def test_f32_pins_keep_the_pinned_hessian_factorable():
    """BOXQP-d at n = 64 in f32: every pin leaves Q_s + I/gamma positive
    definite with room for f32 (half of n eps ||Q_s||), and its f32
    Cholesky succeeds.  The reference's bound (a drifting recurrence for Ax
    and a 1e-6 margin) left one such problem indefinite on an H100, and
    K1's Newton step returned NaN there."""
    from qpalm_tpu_torch.scaling import scale_data
    from qpalm_tpu_torch.workloads import boxqp

    probs = [boxqp(64, seed=64000 + i) for i in range(32)]
    s = Settings(**NC)
    data = stack_problems(probs, np.float32)
    gi, gm = batch_gamma_pins(data, s)
    Qs = scale_data(data, s.scaling)[0].Q
    lam = np.linalg.eigvalsh(Qs.double().numpy())[:, 0]
    room = 0.5 * 64 * np.finfo(np.float32).eps \
        * Qs.abs().sum(-1).amax(-1).double().numpy()
    assert np.all(lam < 0) and torch.equal(gi, gm)
    assert np.all(lam + 1.0 / gm.double().numpy() >= room)
    eye = torch.eye(64)
    _, info = torch.linalg.cholesky_ex(Qs + eye / gm[:, None, None])
    assert torch.all(info == 0)
