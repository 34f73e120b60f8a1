"""The Schur Newton step of the port's linalg/dense.py against the JAX
package's (qpalm_tpu/linalg/dense.py:54-186) on the CPU, from the same
numpy inputs: the factor (K2a's twin against jnp.linalg.cholesky), the
solve (K2b's twin against two triangular solves), the Schur matrix, the
refined Newton step and the host cost model."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from qpalm_tpu_torch import constants as C
from qpalm_tpu_torch.linalg import dense as TD
import torch_support  # noqa: F401


def _jax_dense():
    pytest.importorskip("jax")
    from qpalm_tpu.linalg import dense as JD

    return JD


def _schur_case(seed=4, n=12, m=18):
    """tests/test_kernels.py:41-56's problem."""
    rng = np.random.default_rng(seed)
    Mh = rng.standard_normal((n, n))
    Q = Mh @ Mh.T + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n))
    sigma = rng.random(m) + 0.5
    active = rng.random(m) < 0.5
    b = rng.standard_normal(n)
    return Q, A, sigma, active, 50.0, b


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("proximal", [True, False])
@pytest.mark.parametrize("max_refine", [0, 3])
def test_newton_solve_schur_matches_jax(max_refine, proximal):
    """d and L of one problem against the reference's to rtol 1e-9, atol
    1e-11 (f64), and d against numpy's solve of the same M."""
    import jax.numpy as jnp

    JD = _jax_dense()
    Q, A, sigma, active, gamma, b = _schur_case()
    d_j, L_j = JD.newton_solve_schur(
        jnp.asarray(Q), jnp.asarray(A), jnp.sqrt(jnp.asarray(sigma)),
        jnp.asarray(active), jnp.asarray(gamma), jnp.asarray(b),
        proximal=proximal, max_refine=max_refine)
    d_t, L_t = TD.newton_solve_schur(
        _t(Q), _t(A), torch.sqrt(_t(sigma)), _t(active), gamma, _t(b),
        proximal=proximal, max_refine=max_refine)
    assert d_t.shape == (12,) and L_t.shape == (12, 12)
    assert d_t.dtype == torch.float64
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-9,
                               atol=1e-11)
    assert np.array_equal(L_t.numpy(), np.tril(L_t.numpy()))
    M = Q + (np.eye(12) / gamma if proximal else 0) \
        + A.T @ np.diag(sigma * active) @ A
    np.testing.assert_allclose(d_t.numpy(), np.linalg.solve(M, b),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("reuse", [True, False])
def test_newton_solve_schur_reuse_selects_the_cached_factor(reuse):
    """With a cached factor from another active set, `reuse` picks it (and
    d solves with it) or refactors, as the reference does."""
    import jax.numpy as jnp

    JD = _jax_dense()
    Q, A, sigma, active, gamma, b = _schur_case()
    args = lambda act: (Q, A, np.sqrt(sigma), act, gamma, b)  # noqa: E731
    L_old_j = JD.newton_solve_schur(
        *map(jnp.asarray, args(~active)), proximal=True)[1]
    d_j, L_j = JD.newton_solve_schur(
        *map(jnp.asarray, args(active)), proximal=True, max_refine=3,
        L=L_old_j, reuse=jnp.asarray(reuse))
    L_old_t = TD.newton_solve_schur(
        *(_t(a) for a in args(~active)), proximal=True)[1]
    d_t, L_t = TD.newton_solve_schur(
        *(_t(a) for a in args(active)), proximal=True, max_refine=3,
        L=L_old_t, reuse=reuse)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-9,
                               atol=1e-11)
    assert torch.equal(L_t, L_old_t) == reuse


def test_newton_solve_schur_batch_equals_one_by_one():
    """A batch of three problems, each with its own gamma, gives each
    problem's unbatched result."""
    cases = [_schur_case(seed=s) for s in (4, 5, 6)]
    gam = torch.tensor([50.0, 3.0, 1e3], dtype=torch.float64)
    stack = [torch.stack([_t(c[i]) for c in cases]) for i in range(6)]
    Q, A, sig, act, _, b = stack
    d, L = TD.newton_solve_schur(Q, A, torch.sqrt(sig), act, gam, b,
                                 proximal=True, max_refine=3)
    for k, c in enumerate(cases):
        dk, Lk = TD.newton_solve_schur(_t(c[0]), _t(c[1]),
                                       torch.sqrt(_t(c[2])), _t(c[3]),
                                       float(gam[k]), _t(c[5]),
                                       proximal=True, max_refine=3)
        np.testing.assert_allclose(d[k].numpy(), dk.numpy(), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(L[k].numpy(), Lk.numpy(), rtol=1e-12,
                                   atol=1e-14)


@pytest.mark.parametrize("n", [5, 33])
def test_cholesky_shifted_and_cho_solve_match_jax(n):
    """The factor of M + shift I and the solve against it at f64, to
    1e-12 relative, for one vector and for several columns."""
    import jax.numpy as jnp

    JD = _jax_dense()
    rng = np.random.default_rng(30 + n)
    G = rng.standard_normal((n, n))
    M = G @ G.T + 0.5 * np.eye(n)
    shift = 0.25
    L_j = np.asarray(JD.cholesky_shifted(jnp.asarray(M), shift))
    L_t = TD.cholesky_shifted(_t(M), shift)
    assert L_t.shape == (n, n)
    np.testing.assert_allclose(L_t.numpy(), L_j, rtol=0,
                               atol=1e-12 * np.abs(L_j).max())
    for b in (rng.standard_normal(n), rng.standard_normal((n, 3))):
        x_j = np.asarray(JD.cho_solve(jnp.asarray(L_j), jnp.asarray(b)))
        x_t = TD.cho_solve(L_t, _t(b)).numpy()
        assert x_t.shape == b.shape
        np.testing.assert_allclose(x_t, x_j, rtol=0,
                                   atol=1e-12 * np.abs(x_j).max())
        Ms = M + shift * np.eye(n)
        assert np.abs(Ms @ x_t - b).max() < 1e-12 * np.abs(Ms).max() \
            * max(np.abs(x_t).max(), 1.0)


def test_cholesky_shifted_batch():
    """A batch (B, n, n) with a shift a matrix."""
    rng = np.random.default_rng(40)
    G = rng.standard_normal((3, 9, 9))
    M = G @ G.transpose(0, 2, 1)
    shift = np.array([1.0, 0.5, 2.0])
    L = TD.cholesky_shifted(_t(M), _t(shift)).numpy()
    for k in range(3):
        want = np.linalg.cholesky(M[k] + shift[k] * np.eye(9))
        np.testing.assert_allclose(L[k], want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("proximal", [True, False])
def test_schur_matrix_matches_jax(proximal):
    import jax.numpy as jnp

    JD = _jax_dense()
    Q, A, sigma, active, gamma, _ = _schur_case(seed=7, n=10, m=15)
    want = np.asarray(JD.schur_matrix(
        jnp.asarray(Q), jnp.asarray(A), jnp.sqrt(jnp.asarray(sigma)),
        jnp.asarray(active), jnp.asarray(1.0 / gamma), proximal))
    got = TD.schur_matrix(_t(Q), _t(A), torch.sqrt(_t(sigma)), _t(active),
                          torch.tensor(1.0 / gamma, dtype=torch.float64),
                          proximal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())
    exact = Q + A.T @ np.diag(sigma * active) @ A \
        + (np.eye(10) / gamma if proximal else 0)
    np.testing.assert_allclose(got, exact, rtol=1e-12, atol=1e-12)


def _cost_cases():
    """(Q, A) pairs on both sides of the threshold: a sparse A, a dense A,
    one dense row of A and a banded A (KKT, ratios 0.1 to 1.2); a diagonal
    Q under a selection of its entries, half of them (Schur, 2.67)."""
    rng = np.random.default_rng(50)
    n, m = 40, 60
    out = []
    Qd = np.diag(rng.random(n) + 1.0)
    A1 = sp.random(m, n, density=0.03, random_state=1).toarray()
    out.append((Qd, A1))
    out.append((Qd + 0.1, rng.standard_normal((m, n))))
    A3 = np.zeros((m, n))
    A3[0] = 1.0
    A3[np.arange(1, m), np.arange(1, m) % n] = 2.0
    out.append((Qd, A3))
    A4 = sum(np.eye(m, n, k) for k in range(-2, 3))
    out.append((np.eye(n), A4))
    out.append((Qd, np.eye(n // 2, n)))
    return out


@pytest.mark.parametrize("case", range(5))
def test_select_factorization_method_matches_jax(case):
    """Equal to the reference's choice on dense and scipy inputs; the cases
    give both choices."""
    JD = _jax_dense()
    Q, A = _cost_cases()[case]
    want = JD.select_factorization_method(Q, A)
    assert TD.select_factorization_method(Q, A) == want
    assert TD.select_factorization_method(sp.csr_matrix(Q),
                                          sp.csc_matrix(A)) == want
    assert JD.select_factorization_method(sp.csr_matrix(Q),
                                          sp.csc_matrix(A)) == want
    for threshold in (0.5, 2.0, 8.0):
        assert TD.select_factorization_method(Q, A, threshold) == \
            JD.select_factorization_method(Q, A, threshold)


def test_select_factorization_method_gives_both():
    got = {TD.select_factorization_method(Q, A) for Q, A in _cost_cases()}
    assert got == {C.FACTORIZE_KKT, C.FACTORIZE_SCHUR}
