"""The general loop's exact linesearch (qpalm_tpu_torch.solver.linesearch)
against qpalm_tpu.solver.linesearch, vmapped over the same random
breakpoints made with numpy: both forms, at float64 and float32, with tied
breakpoints, hinges sitting exactly at their breakpoint, and lanes whose
hinges are all inactive."""

import numpy as np
import pytest
import torch

from qpalm_tpu_torch.solver import linesearch as L
import torch_support  # noqa: F401

B, M = 64, 12


def _case(seed, dtype, ties=False, inactive=False):
    """(eta, beta, delta, alpha) of B lanes with 2M breakpoints each."""
    rng = np.random.default_rng(seed)
    eta = rng.uniform(0.1, 2.0, B)
    beta = -rng.uniform(0.1, 3.0, B)
    delta = rng.standard_normal((B, 2 * M))
    alpha = rng.standard_normal((B, 2 * M))
    if ties:
        # repeated breakpoints s = alpha / delta, zero slopes, and hinges
        # exactly at their breakpoint (alpha = 0)
        delta[:, M:] = delta[:, :M]
        alpha[:, M:] = alpha[:, :M]
        delta[:, ::5] = 0.0
        alpha[:, 1::7] = 0.0
    if inactive:
        # every hinge inactive for tau > 0: the walk passes no breakpoint
        delta = -np.abs(delta)
        alpha = np.abs(alpha) + 0.1
    return [a.astype(dtype) for a in (eta, beta, delta, alpha)]


def _reference(fn, args):
    import jax
    import jax.numpy as jnp
    from qpalm_tpu.solver import linesearch as JL

    f = jax.jit(jax.vmap(getattr(JL, fn)))
    return np.asarray(f(*(jnp.asarray(a) for a in args)))


def _port(fn, args):
    return getattr(L, fn)(*(torch.from_numpy(a) for a in args)).numpy()


@pytest.mark.parametrize("fn", ["linesearch_from_breakpoints",
                                "linesearch_bisection"])
@pytest.mark.parametrize("kind", ["random", "ties", "inactive"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_linesearch_matches_reference(fn, kind, dtype):
    """Both forms against the reference's on the same breakpoints: at
    float64 within 1e-12 relative (the sums round in another order), at
    float32 within 1e-5."""
    pytest.importorskip("jax")
    args = _case(11 if kind == "random" else 12, dtype,
                 ties=kind == "ties", inactive=kind == "inactive")
    ref, got = _reference(fn, args), _port(fn, args)
    assert got.dtype == dtype and got.shape == (B,)
    assert np.all(np.isfinite(got))
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sort_and_bisection_agree(dtype):
    """The two forms find the same exact minimizer on breakpoints without
    ties (with hinges exactly at their breakpoint the reference's own two
    forms read the 0+ piece apart where tau <= 0)."""
    args = _case(13, dtype)
    a = _port("linesearch_from_breakpoints", args)
    b = _port("linesearch_bisection", args)
    tol = 1e-10 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def test_sort_is_stable_as_the_reference_sorts():
    """jnp.argsort is stable, and so is the port's sort: tied keys keep
    their order."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    key = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, np.inf, 1.0, np.inf]])
    ref = np.asarray(jnp.argsort(jnp.asarray(key), axis=-1))
    got = torch.sort(torch.from_numpy(key), dim=-1, stable=True)[1].numpy()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("mode", ["sort", "bisect"])
def test_exact_linesearch_matches_reference(mode):
    """exact_linesearch builds the breakpoints as the reference does."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from qpalm_tpu.solver.linesearch import exact_linesearch as jls

    rng = np.random.default_rng(14)
    n, m = 6, M
    d, Qd, df = (rng.standard_normal((B, n)) for _ in range(3))
    Qd = Qd * np.sign((d * Qd).sum(1, keepdims=True))  # eta > 0
    Ad, Ax, y = (rng.standard_normal((B, m)) for _ in range(3))
    sigma = rng.uniform(0.5, 20.0, (B, m))
    bmin, bmax = -rng.uniform(0.1, 1, (B, m)), rng.uniform(0.1, 1, (B, m))
    args = (d, Qd, Ad, df, Ax, y, sigma, np.sqrt(sigma), bmin, bmax)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda *a: jls(*a, mode=mode)))(*(jnp.asarray(a) for a in args)))
    got = L.exact_linesearch(*(torch.from_numpy(a) for a in args),
                             mode=mode).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
