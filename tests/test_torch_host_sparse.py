"""The port's host sparse solvers (qpalm_tpu_torch.host_sparse over its own
builds of native/: linalg/sparse_direct.py's libqpalm_ldl.so and
baseline_c.py's sparse engine) against qpalm_tpu's on the CPU.  The host
routes are numpy copies on libraries built from the same sources, so x, y
and the iteration counts are equal bit for bit; solve_sparse_auto takes
the same route in both packages, and its CG fallback runs the port's
api.solve on the device asked for (the CPU here)."""

import contextlib
import os

import numpy as np
import pytest
import scipy.sparse as sp

from helpers import kkt_check, random_convex_qp
from qpalm_tpu_torch import Settings, SparseQPALM, solve, \
    solve_sparse_auto, solve_sparse_batch, solve_sparse_direct
from qpalm_tpu_torch import baseline_c, host_sparse
from qpalm_tpu_torch import constants as C
from qpalm_tpu_torch.io.qps import load_qps_python
from qpalm_tpu_torch.linalg import sparse_direct
from torch_support import _js

pytest.importorskip("jax")

S = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)
MM_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                      "qps_mm")


def _equal(got, want, cert=False):
    assert got.status == want.status and got.status_str == want.status_str
    assert got.iterations == want.iterations
    assert np.array_equal(got.x, want.x) and np.array_equal(got.y, want.y)
    assert got.objective == want.objective
    if cert:
        for f in ("delta_x", "delta_y"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            assert a is None or np.array_equal(a, b), f


def test_native_libraries_are_built_by_the_port():
    """Both libraries come from native/'s sources through _build.py into
    qpalm_tpu_torch/_build/, not from native/'s Makefile."""
    ldl = sparse_direct.load_library()
    assert ldl is not None, sparse_direct.unavailable_reason()
    base = baseline_c.load_library()
    assert base is not None, baseline_c.unavailable_reason()
    for lib in (ldl, base):
        assert os.path.join("qpalm_tpu_torch", "_build") in lib._name


def _heavy(n, m, seed):
    rng = np.random.default_rng(seed)
    Qr = sp.random(n, n, density=0.02, random_state=rng)
    Q = (Qr @ Qr.T + sp.eye(n)).tocsc()
    A = (sp.random(m, n, density=0.02, random_state=rng)
         + 0.5 * sp.eye(m, n)).tocsc()
    u = 1 + rng.random(m)
    return Q, A, rng.standard_normal(n), -u, u


def _banded(n, m, seed):
    rng = np.random.default_rng(seed)
    L = sp.diags([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1])
    Q = (L @ L + 1e-6 * sp.eye(n)).tocsc()
    A = sp.diags([np.ones(m), 0.5 * np.ones(m)], [0, 1],
                 shape=(m, n)).tocsc()
    u = 1 + rng.random(m)
    return Q, A, rng.standard_normal(n), -u, u


def _dense_rows(n, m, seed, k=4):
    rng = np.random.default_rng(seed)
    Q, _, q, _, _ = _banded(n, m, seed)
    A = sp.vstack([sp.diags(np.ones(m - k), 0, shape=(m - k, n)),
                   sp.csc_matrix(rng.standard_normal((k, n)) / np.sqrt(n))
                   ]).tocsc()
    u = 1 + rng.random(m)
    return Q, A, q, -u, u


def _small(n, m, seed):
    Q, A, q, bl, bu = random_convex_qp(n, m, seed=seed, density=0.3)
    return sp.csc_matrix(Q), sp.csc_matrix(A), q, bl, bu


@pytest.mark.parametrize("case, kw", [
    ("small", {}),
    ("small", dict(factorization_method=C.FACTORIZE_KKT)),
    ("small", dict(factorization_method=C.FACTORIZE_SCHUR, proximal=False,
                   scaling=0)),
    ("heavy", {}),
    ("dense_rows", {}),
    ("nonconvex", dict(nonconvex=True)),
])
def test_solve_sparse_direct_matches_reference(case, kw):
    from qpalm_tpu.host_sparse import solve_sparse_direct as jdirect

    if case == "nonconvex":
        rng = np.random.default_rng(9)
        G = sp.random(40, 40, density=0.2, random_state=9)
        prob = (((G + G.T) / 2).tocsc(), sp.eye(40, format="csc"),
                rng.standard_normal(40), -np.ones(40), np.ones(40))
    else:
        prob = {"small": lambda: _small(30, 45, 61),
                "heavy": lambda: _heavy(200, 150, 31),
                "dense_rows": lambda: _dense_rows(300, 120, 4)}[case]()
    s = S.replace(**kw)
    got = solve_sparse_direct(*prob, s)
    want = jdirect(*prob, _js(s))
    _equal(got, want, cert=True)
    assert got.status == C.QPALM_SOLVED


def test_certificates_and_warm_start_match_reference():
    from qpalm_tpu.host_sparse import solve_sparse_direct as jdirect

    A = sp.csc_matrix(np.array([[1.0], [1.0]]))
    pinf = (sp.eye(1, format="csc"), A, np.zeros(1), np.array([1.0, -1e30]),
            np.array([1e30, 0.0]))
    got, want = solve_sparse_direct(*pinf, S), jdirect(*pinf, _js(S))
    _equal(got, want, cert=True)
    assert got.status == C.QPALM_PRIMAL_INFEASIBLE
    prob = _small(25, 40, 21)
    r = solve_sparse_direct(*prob, S)
    got = solve_sparse_direct(*prob, S, x0=r.x, y0=r.y)
    _equal(got, jdirect(*prob, _js(S), x0=r.x, y0=r.y))
    assert got.iterations < r.iterations


def test_sparse_qpalm_lifecycle_matches_reference():
    """tests/test_sparse_direct.py:95-128: setup, solve, update_q,
    update_bounds, re-solve with the symbolic analysis made once."""
    from qpalm_tpu import SparseQPALM as JSparseQPALM

    rng = np.random.default_rng(6)
    Q, A, q, bl, bu = _small(60, 90, 61)
    got = SparseQPALM(Q, A, q, bl, bu, settings=S)
    want = JSparseQPALM(Q, A, q, bl, bu, settings=_js(S))
    _equal(got.solve(), want.solve())
    handles = got._reuse["ldl"], got._reuse["ldl_kkt"]
    q2 = q + 0.1 * rng.standard_normal(60)
    for o in (got, want):
        o.update_q(q2)
    _equal(got.solve(), want.solve())
    assert (got._reuse["ldl"], got._reuse["ldl_kkt"]) == handles
    for o in (got, want):
        o.update_bounds(bl - 0.05, bu + 0.05)
    r, w = got.solve(), want.solve()
    _equal(r, w)
    kkt_check(Q.toarray(), A.toarray(), q2, bl - 0.05, bu + 0.05, r.x, r.y,
              tol=1e-5)


def test_solve_sparse_batch_matches_reference():
    from qpalm_tpu import solve_sparse_batch as jbatch

    rng = np.random.default_rng(3)
    probs = []
    for _ in range(3):  # a shared pattern, different values
        Q, A, q, bl, bu = _small(40, 60, 70)
        probs.append((Q, A, q + 0.1 * rng.standard_normal(40), bl, bu))
    probs += [_small(30, 45, 80 + i) for i in range(2)]
    got = solve_sparse_batch(probs, S, threads=2)
    for g, w in zip(got, jbatch(probs, _js(S), threads=1)):
        _equal(g, w)
        assert g.status == C.QPALM_SOLVED


@contextlib.contextmanager
def _routes(hs, api, log):
    """Record which route solve_sparse_auto of module `hs` takes."""
    patches = [(hs, "solve_sparse_direct", "direct"),
               (hs, "_solve_native_engine", "native"),
               (api, "solve", "cg")]
    saved = [getattr(mod, name) for mod, name, _ in patches]

    def wrap(fn, tag):
        def inner(*a, **k):
            log.append(tag)
            return fn(*a, **k)
        return inner

    for (mod, name, tag), fn in zip(patches, saved):
        setattr(mod, name, wrap(fn, tag))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(patches, saved):
            setattr(mod, name, fn)


def _auto(prob, s, **kw):
    import qpalm_tpu.api as japi
    import qpalm_tpu.host_sparse as jhs
    from qpalm_tpu_torch import api

    glog, wlog = [], []
    with _routes(host_sparse, api, glog):
        got = solve_sparse_auto(*prob, s, device="cpu", **kw)
    with _routes(jhs, japi, wlog):
        want = jhs.solve_sparse_auto(*prob, _js(s), **kw)
    return got, want, glog, wlog


@pytest.mark.parametrize("case, route", [
    ("banded", "native"), ("heavy", "direct"), ("dense_rows", "direct"),
    ("warm", "direct")])
def test_auto_routes_match_reference(case, route):
    """The selector picks the same route in both packages: the native C
    engine for light fill, the Python direct loop for supernodal fill,
    dense rows and warm starts, each with equal results."""
    prob = {"banded": lambda: _banded(300, 120, 0),
            "heavy": lambda: _heavy(200, 150, 31),
            "dense_rows": lambda: _dense_rows(300, 120, 4),
            "warm": lambda: _banded(300, 120, 0)}[case]()
    kw = {}
    if case == "warm":
        kw = dict(x0=np.zeros(300), y0=np.zeros(120))
    got, want, glog, wlog = _auto(prob, S, **kw)
    assert glog == wlog and glog[0] == route
    _equal(got, want, cert=True)
    assert got.status == C.QPALM_SOLVED


def test_auto_cg_fallback_runs_the_port_on_the_device():
    """Patterns past both direct budgets go to CG through the port's
    api.solve(device=...) (the CPU here): the certificate of a
    primal-infeasible problem survives, as tests/test_sparse_direct.py:
    398-417 asks of the reference; a solvable one agrees with the
    reference's CG run to the CG path's bar."""
    rng = np.random.default_rng(1)
    n, m = 120, 80
    # sparse rows: a dense A would take the direct KKT form whatever the
    # budgets (the dense-rows pre-check of host_sparse.py:889-899)
    Ar = sp.random(m, n, density=0.1, random_state=1,
                   data_rvs=rng.standard_normal).tocsc()
    A2 = sp.vstack([Ar, Ar[:1]]).tocsc()
    bl = np.concatenate([np.full(m, -1.0), [2.0]])
    bu = np.concatenate([np.full(m, 1.0), [3.0]])
    prob = (sp.eye(n).tocsc(), A2, rng.standard_normal(n), bl, bu)
    kw = dict(fill_ratio=0.0, direct_flop_budget=0.0)
    got, want, glog, wlog = _auto(prob, S, **kw)
    assert glog == wlog == ["cg"]
    assert got.status == want.status == C.QPALM_PRIMAL_INFEASIBLE
    dy = got.delta_y
    assert dy is not None
    assert np.abs(A2.T @ dy).max() <= 1e-4 * np.abs(dy).max()
    prob = _small(40, 60, 12)
    got, want, glog, wlog = _auto(prob, S, **kw)
    assert glog == wlog == ["cg"]
    assert got.status == want.status == C.QPALM_SOLVED
    assert np.abs(got.x - np.asarray(want.x)).max() < 5e-6


def test_api_solve_routes_large_sparse_problems():
    """solve() on a scipy problem from n = 2048 with default settings
    takes solve_sparse_auto (tests/test_sparse_direct.py:160-180), with
    the reference's answer bit for bit on the native route."""
    import qpalm_tpu

    prob = _banded(2100, 800, 2)
    got = solve(*prob, eps_abs=1e-6, eps_rel=1e-6, verbose=False,
                device="cpu")
    want = qpalm_tpu.solve(*prob, eps_abs=1e-6, eps_rel=1e-6, verbose=False)
    assert got.info.status == want.info.status == "solved"
    assert got.info.iter == int(want.info.iter) and got.state is None
    assert np.array_equal(got.solution.x, np.asarray(want.solution.x))
    assert got.info.run_time > 0


CVXQP_PUBLISHED = {  # tests/test_maros.py:96-106
    "CVXQP1_S": 1.1590718e4,
    "CVXQP2_S": 8.1209405e3,
    "CVXQP3_S": 1.1943432e4,
    "CVXQP1_M": 1.0875116e6,
}


@pytest.mark.parametrize("name", sorted(CVXQP_PUBLISHED))
def test_cvxqp_published_optimum(name):
    """tests/test_maros.py:109-121 through the port's parser and
    solve_sparse_auto: the published optimum within 1e-5 relative."""
    p = load_qps_python(os.path.join(MM_DIR, name + ".qps"))
    s = Settings(eps_abs=1e-7, eps_rel=1e-7, verbose=False, max_iter=5000)
    r = solve_sparse_auto(p.Q, p.A, p.q, p.bmin, p.bmax, settings=s, c=p.c,
                          device="cpu")
    assert r.status_str == "solved", (name, r.status_str)
    fstar = CVXQP_PUBLISHED[name]
    assert abs(r.objective - fstar) <= 1e-5 * abs(fstar)


def test_sequential_mpc_sparse_backend_matches_reference():
    """SequentialMPC(backend="sparse") through SparseQPALM, step for step
    the reference's."""
    from qpalm_tpu.workloads import SequentialMPC as JMPC
    from qpalm_tpu_torch.workloads import SequentialMPC

    got = SequentialMPC(3, 8, backend="sparse", device="cpu")
    want = JMPC(3, 8, backend="sparse")
    for _ in range(4):
        a, b = got.step(), want.step()
        assert a[0] == b[0] == "solved" and a[1] == b[1]
        assert np.array_equal(a[2], b[2])
    assert np.array_equal(got.x, want.x)
