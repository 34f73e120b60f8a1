"""The port's differentiable solve (qpalm_tpu_torch.diff.solve_diff, a
torch.autograd.Function) against qpalm_tpu.diff.solve_diff, on the CPU.

tests/diff_checks.py's four checks (gradients against finite differences,
at a loose solver tolerance, an embedded-QP gradient descent, batched
against single solves) plus the cases the reference never tested
(VERDICT.md:183-189): a weakly active constraint, a degenerate point (a
duplicated active row) and an f32 forward pass.  The JAX gradients come
from a fresh interpreter that writes an .npz (as tests/test_diff.py runs
diff_checks.py: the custom-VJP compilations crash XLA on the CPU after
hundreds of earlier compiles in one process).

The port's gradients are held to the JAX package's within 1e-6 relative
at f64, or within kappa(K) eps where the backward system K = Q + A_act'
sigma A_act (sigma = 1e10) is conditioned so that no two f64 solves of it
agree closer: at seed 0 (kappa = 9.9e10) the port's and the reference's
gradients of A differ by 9.9e-6 relative, and numpy's LU and LAPACK's
Cholesky solves of the same K differ by 6e-6 in nu = sigma A lam.  An f32
forward pass (sigma = 1e5) is held to the f64 gradients within 1e-3
relative, or within kappa(K) u32 of its f32 system where that is larger:
at seed 0 (kappa = 9.9e5) its gradients lie 3.1e-3 from the f64 ones (the
reference's own f32 gradients up to 1.2e-2 from its f64 ones), and an f32
Cholesky of that K alone moves lam by 2e-2."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qpalm_tpu_torch import Settings
from qpalm_tpu_torch.diff import active_rows, solve_diff
import torch_support  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
S = Settings(eps_abs=1e-10, eps_rel=1e-10, verbose=False, scaling=0)
S_LOOSE = Settings(eps_abs=1e-4, eps_rel=1e-4, verbose=False, scaling=0)
ARGS = ("Q", "A", "q", "bmin", "bmax")


def _qp(seed=0, n=5, m=7):
    """tests/diff_checks.py:27-35."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    Q = M @ M.T + 1.0 * np.eye(n)
    A = rng.standard_normal((m, n))
    q = rng.standard_normal(n)
    u = 1.0 + rng.random(m)
    return Q, A, q, -u, u


def _weakly_active():
    """Q = I, x* = c, and row 0 (x_0 <= c_0) holds with equality and a
    zero multiplier; the other rows are loose."""
    n, m = 5, 7
    c = np.array([0.7, -0.3, 0.2, 0.5, -0.6])
    A = np.zeros((m, n))
    A[:n] = np.eye(n)
    A[n:] = np.random.default_rng(1).standard_normal((m - n, n))
    bmin = np.full(m, -10.0)
    bmax = np.full(m, 10.0)
    bmax[0] = c[0]
    return np.eye(n), A, -c, bmin, bmax


def _degenerate():
    """A strongly active row repeated (LICQ fails): x_0 <= 0.5 twice with
    the unconstrained optimum at x_0 = 2."""
    Q, A, q, bmin, bmax = _weakly_active()
    A = A.copy()
    A[1] = A[0]
    q = q.copy()
    q[0] = -2.0
    bmax = bmax.copy()
    bmax[0] = bmax[1] = 0.5
    return Q, A, q, bmin, bmax


W = np.random.default_rng(99).standard_normal(5)
W_LOOSE = np.random.default_rng(42).standard_normal(5)
W_BATCH = np.random.default_rng(0).standard_normal(5)
PROBS = {"seed0": _qp(0), "seed1": _qp(1), "weak": _weakly_active(),
         "degenerate": _degenerate()}

# computes the JAX package's gradients into an .npz: argv[1] the output
_REFERENCE = r"""
import sys
sys.path.insert(0, sys.argv[2])
sys.path.insert(0, sys.argv[3])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from qpalm_tpu import Settings
from qpalm_tpu.diff import _ACT_TOL_F64, _Y_TOL_REL, _fwd, solve_diff
import test_torch_diff as T

S = Settings(eps_abs=1e-10, eps_rel=1e-10, verbose=False, scaling=0)
S_LOOSE = Settings(eps_abs=1e-4, eps_rel=1e-4, verbose=False, scaling=0)
out = {}
w = jnp.asarray(T.W)

def loss(Q, A, q, bmin, bmax):
    x = solve_diff(Q, A, q, bmin, bmax, S)
    return jnp.vdot(w, x) + 0.5 * jnp.vdot(x, x)

grad5 = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))
for name, p in T.PROBS.items():
    p = [jnp.asarray(a) for a in p]
    for arg, g in zip(T.ARGS, grad5(*p)):
        out[f"{name}_{arg}"] = np.asarray(g)
    x, y = _fwd(*p, S)[1][5:]
    Ax = p[1] @ x
    tol = _ACT_TOL_F64 * jnp.maximum(1.0, jnp.max(jnp.abs(Ax)))
    y_tol = jnp.maximum(_Y_TOL_REL * jnp.maximum(1.0, jnp.max(jnp.abs(y))),
                        10.0 * S.eps_abs)
    at_upper = (Ax >= p[4] - tol) | (y > y_tol)
    out[f"{name}_x"] = np.asarray(x)
    out[f"{name}_active"] = np.asarray((Ax <= p[3] + tol) | at_upper
                                       | (y < -y_tol))

# an f32 forward pass of the reference (its own margins and penalty)
S32 = Settings(eps_abs=1e-4, eps_rel=1e-4, verbose=False, scaling=0)
w32 = jnp.asarray(T.W, jnp.float32)

def loss32(Q, A, q, bmin, bmax):
    x = solve_diff(Q, A, q, bmin, bmax, S32)
    return jnp.vdot(w32, x) + 0.5 * jnp.vdot(x, x)

grad32 = jax.jit(jax.grad(loss32, argnums=(0, 1, 2, 3, 4)))
for name in ("seed0", "seed1"):
    p = [jnp.asarray(a, jnp.float32) for a in T.PROBS[name]]
    for arg, g in zip(T.ARGS, grad32(*p)):
        out[f"{name}_{arg}_f32"] = np.asarray(g, np.float64)

p5 = [jnp.asarray(a) for a in T._qp(5)]
wl = jnp.asarray(T.W_LOOSE)
for key, s in (("tight", S), ("loose", S_LOOSE)):
    g = jax.jit(jax.grad(lambda v, s=s: jnp.vdot(
        wl, solve_diff(p5[0], p5[1], v, p5[3], p5[4], s))))
    out[f"seed5_q_{key}"] = np.asarray(g(p5[2]))

probs = [T._qp(seed=i) for i in range(4)]
stk = [jnp.stack([jnp.asarray(p[k]) for p in probs]) for k in range(5)]
wb = jnp.asarray(T.W_BATCH)
vg = jax.jit(jax.vmap(jax.grad(lambda Q, A, q, lo, hi: jnp.vdot(
    wb, solve_diff(Q, A, q, lo, hi, S)), argnums=2)))
out["batch_q"] = np.asarray(vg(*stk))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pytest.importorskip("jax")
    path = tmp_path_factory.mktemp("diff") / "ref.npz"
    tests = str(Path(__file__).resolve().parent)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(path),
                          str(ROOT), tests], capture_output=True, text=True,
                         timeout=400, env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tensors(p, dtype=torch.float64, grad=True):
    return [torch.tensor(a, dtype=dtype, requires_grad=grad) for a in p]


def _loss(t, w=W, settings=S):
    x = solve_diff(*t, settings)
    wt = torch.as_tensor(w, dtype=x.dtype)
    return (wt * x).sum() + 0.5 * (x * x).sum()


def _grads(p, dtype=torch.float64, settings=S):
    t = _tensors(p, dtype)
    _loss(t, settings=settings).backward()
    return [a.grad.double().numpy() for a in t]


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _kappa(p, active, sigma):
    """Condition number of the backward pass's K at these active rows."""
    Q, A = p[0], p[1]
    Bm = A * np.sqrt(np.where(active, sigma, 0.0))[:, None]
    return np.linalg.cond(Q + Bm.T @ Bm + 1e-12 * np.eye(Q.shape[0]))


@pytest.mark.parametrize("name", sorted(PROBS))
def test_gradients_match_reference(ref, name):
    """Every gradient within 1e-6 relative of the JAX package's (or
    kappa(K) eps, module docstring), the solution within 1e-8, and the
    backward pass's active rows the same (the weakly active and the
    degenerate point included)."""
    p = PROBS[name]
    bar = max(1e-6, _kappa(p, ref[f"{name}_active"], 1e10)
              * np.finfo(np.float64).eps)
    for arg, g in zip(ARGS, _grads(p)):
        want = ref[f"{name}_{arg}"]
        if np.abs(want).max() == 0:
            assert np.abs(g).max() == 0, (name, arg)
        else:
            assert _rel(g, want) <= bar, (name, arg, _rel(g, want), bar)
    t = _tensors(p, grad=False)
    x = solve_diff(*t, S)
    assert np.abs(x.numpy() - ref[f"{name}_x"]).max() <= 1e-8
    from qpalm_tpu_torch.diff import _solve_primal

    xb, yb = _solve_primal(*(a[None] for a in t), S)
    active = active_rows(t[1][None], t[3][None], t[4][None], xb, yb,
                         S.eps_abs)[0][0].numpy()
    np.testing.assert_array_equal(active, ref[f"{name}_active"])


def _fd(p, arg, idx, eps=1e-6, side=0):
    """Finite difference of the loss in p[arg][idx]: central (side 0) or
    one-sided (+1 forward, -1 backward)."""
    def at(e):
        q = [np.array(a, dtype=float) for a in p]
        q[arg][idx] += e
        if arg == 0 and idx[0] != idx[1]:  # Q stays symmetric
            q[0][idx[::-1]] += e
        return float(_loss(_tensors(q, grad=False)))
    if side == 0:
        return (at(eps) - at(-eps)) / (2 * eps)
    return side * (at(side * eps) - at(0.0)) / eps


def test_gradients_match_finite_differences():
    """tests/diff_checks.py:44-77, two samples an argument."""
    for seed in (0, 1):
        p = PROBS[f"seed{seed}"]
        g = _grads(p)
        g[0] = g[0] + g[0].T - np.diag(np.diagonal(g[0]))  # symmetric dQ
        rng = np.random.default_rng(7)
        for arg in range(5):
            for _ in range(2):
                idx = tuple(int(rng.integers(0, s)) for s in p[arg].shape)
                num, ana = _fd(p, arg, idx), float(g[arg][idx])
                assert abs(num - ana) <= max(2e-3 * abs(ana), 2e-5), \
                    (seed, ARGS[arg], idx, num, ana)


def test_gradients_at_loose_solver_tolerance(ref):
    """tests/diff_checks.py:99-116: at eps 1e-4 the inactive rows' residual
    duals must not read as active; the gradients equal the tight ones."""
    p = _qp(5)

    def grad_q(settings):
        t = _tensors(p)
        x = solve_diff(*t, settings)
        (torch.as_tensor(W_LOOSE) * x).sum().backward()
        return t[2].grad.numpy()

    tight, loose = grad_q(S), grad_q(S_LOOSE)
    np.testing.assert_allclose(loose, tight, atol=5e-3, rtol=5e-3)
    assert _rel(tight, ref["seed5_q_tight"]) <= 1e-6
    assert _rel(loose, ref["seed5_q_loose"]) <= 1e-6


def test_gradient_descent_on_embedded_qp():
    """tests/diff_checks.py:80-96: recover a q whose solution hits a
    realizable target."""
    Q, A, q_true, bmin, bmax = (torch.tensor(a) for a in _qp(3))
    target = solve_diff(Q, A, q_true, bmin, bmax, S)

    def objective(qv):
        x = solve_diff(Q, A, qv, bmin, bmax, S)
        return 0.5 * ((x - target) ** 2).sum()

    qv = torch.zeros(5, dtype=torch.float64)
    val0 = float(objective(qv))
    for _ in range(80):
        qv.requires_grad_(True)
        g, = torch.autograd.grad(objective(qv), qv)
        qv = (qv - 0.5 * g).detach()
    assert float(objective(qv)) < 0.02 * val0


def test_batched_equals_single_calls(ref):
    """tests/diff_checks.py:119-137: a leading batch dimension (B = 4)
    gives each problem's own gradient, and the reference's vmapped
    ones."""
    probs = [_qp(seed=i) for i in range(4)]
    stk = [torch.tensor(np.stack([p[k] for p in probs])) for k in range(5)]
    stk[2].requires_grad_(True)
    x = solve_diff(*stk, S)
    (torch.as_tensor(W_BATCH) * x).sum().backward()
    gb = stk[2].grad.numpy()
    for i, p in enumerate(probs):
        t = _tensors(p)
        (torch.as_tensor(W_BATCH) * solve_diff(*t, S)).sum().backward()
        np.testing.assert_allclose(gb[i], t[2].grad.numpy(), rtol=0,
                                   atol=1e-10)
    assert _rel(gb, ref["batch_q"]) <= 1e-6


def test_weakly_active_constraint_gradients():
    """Row 0 holds with equality and a zero multiplier.  The backward pass
    holds it active, so its gradient is the one-sided derivative on the
    side where the row stays active (raising q_0 or lowering bmax_0 pushes
    the optimum into it): the one-sided differences there agree, and the
    central differences of every coordinate away from the kink agree."""
    p = PROBS["weak"]
    g = _grads(p)
    assert all(np.isfinite(a).all() for a in g)
    for arg, idx, side in ((2, (0,), -1), (4, (0,), -1)):
        num, ana = _fd(p, arg, idx, side=side), float(g[arg][idx])
        assert abs(num - ana) <= 1e-5, (ARGS[arg], idx, num, ana)
    for arg, idx in ((2, (1,)), (2, (3,)), (4, (2,)), (3, (4,)), (0, (1, 2)),
                     (1, (5, 1))):
        gg = g[0] + g[0].T - np.diag(np.diagonal(g[0])) if arg == 0 \
            else g[arg]
        num, ana = _fd(p, arg, idx), float(gg[idx])
        assert abs(num - ana) <= 1e-5, (ARGS[arg], idx, num, ana)


def test_float32_forward_matches_float64(ref):
    """An f32 forward pass (its own margins and penalty) gives gradients
    within 1e-3 relative of the f64 ones, or kappa(K) u32 of its f32
    backward system (module docstring), the bar the reference's own f32
    gradients meet against its f64 ones (at seed 0 they lie up to 1.2e-2
    from them)."""
    s32 = Settings(eps_abs=1e-4, eps_rel=1e-4, verbose=False, scaling=0)
    for seed in (0, 1):
        p = PROBS[f"seed{seed}"]
        bar = max(1e-3, _kappa(p, ref[f"seed{seed}_active"], 1e5)
                  * np.finfo(np.float32).eps)
        g64 = _grads(p)
        g32 = _grads(p, torch.float32, s32)
        for arg, a, b in zip(ARGS, g32, g64):
            assert np.isfinite(a).all()
            assert _rel(a, b) <= bar, (seed, arg, _rel(a, b), bar)
            want, want64 = ref[f"seed{seed}_{arg}_f32"], \
                ref[f"seed{seed}_{arg}"]
            assert _rel(want, want64) <= bar, (seed, arg, "reference")
