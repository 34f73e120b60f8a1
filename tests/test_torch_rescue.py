"""The headline's host rescue and C baseline in the PyTorch port: the port's
build of native/qpalm_baseline.cpp against the JAX package's, `rescue_round`
against the same chain built from the JAX package's own modules, and the
bench entry point on the CPU at a tiny size.  Each test skips where the
baseline library does not load."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from helpers import kkt_check, random_convex_qp
from qpalm_tpu_torch import _build, baseline_c, bench
from qpalm_tpu_torch.batch import stack_problems
from qpalm_tpu_torch.types import QPData
from qpalm_tpu_torch.workloads import make_problems
import torch_support  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _port():
    if baseline_c.load_library() is None:
        pytest.skip("the port's baseline library does not load: "
                    + baseline_c.unavailable_reason())
    return baseline_c


def _reference():
    pytest.importorskip("jax")
    from qpalm_tpu import baseline_c as ref

    if ref.load_library() is None:
        pytest.skip("the JAX package's baseline library does not load")
    return ref


def _variants(n, m, seed):
    """tests/test_baseline_c.py's differential-sweep problems: boxes,
    anchored equalities, free and one-sided rows."""
    rng = np.random.default_rng(seed)
    Q, A, q, bl, bu = random_convex_qp(n, m, seed=seed, density=0.6)
    yield Q, A, q, bl, bu
    k = max(1, m // 6)
    Ax = A @ (0.1 * rng.standard_normal(n))
    bl2, bu2 = np.minimum(bl, Ax - 0.5), np.maximum(bu, Ax + 0.5)
    bl2[:k] = bu2[:k] = Ax[:k]
    yield Q, A, q, bl2, bu2
    bl3, bu3 = bl.copy(), bu.copy()
    bl3[k:2 * k] = -np.inf
    bu3[2 * k:3 * k] = np.inf
    bl3[3 * k:4 * k] = -np.inf
    bu3[3 * k:4 * k] = np.inf
    yield Q, A, q, bl3, bu3


# (problems, solve keywords) of tests/test_baseline_c.py
CASES = {
    **{f"jax_solver_seed{s}": (
        [random_convex_qp(24, 36, seed=s, density=0.5)],
        dict(eps_abs=1e-6, eps_rel=1e-6, scaling=2, delta=10.0))
       for s in range(3)},
    "differential_sweep": (
        [p for n, m in [(24, 36), (32, 16), (12, 48)] for s in range(4)
         for p in _variants(n, m, 1000 + s)],
        dict(eps_abs=1e-8, eps_rel=1e-8, scaling=2, delta=10.0)),
    "unscaled_default_delta": (
        [random_convex_qp(16, 24, seed=9)],
        dict(eps_abs=1e-8, eps_rel=1e-8, scaling=0, delta=100.0)),
    "max_iter_status": (
        [random_convex_qp(16, 24, seed=10)],
        dict(eps_abs=1e-12, eps_rel=0.0, max_iter=3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_baseline_is_bit_identical_to_the_reference(case):
    port, ref = _port(), _reference()
    probs, kw = CASES[case]
    for p in probs:
        got, want = port.solve(*p, **kw), ref.solve(*p, **kw)
        assert got.keys() == want.keys()
        for key in ("status", "iter", "objective"):
            assert got[key] == want[key], (case, key)
        for key in ("x", "y"):
            assert np.array_equal(got[key], want[key]), (case, key)


def test_baseline_builds_on_scipy_openblas(monkeypatch, tmp_path):
    """The route for a host without the system's LAPACK: scipy's bundled
    OpenBLAS under its `scipy_` names, taken after a route whose library
    links but does not load (its LAPACK lies outside the loader's path).
    Its sums round apart from the system BLAS, so the answers agree to the
    solve's tolerance."""
    _port()
    routes = [r for r in _build.blas_routes() if r[0].startswith("scipy")]
    if not routes:
        pytest.skip("scipy bundles no OpenBLAS here")
    stub = tmp_path / "libqpalm_stub_lapack.so"
    (tmp_path / "stub.c").write_text("int qpalm_stub_lapack;\n")
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(stub),
                    str(tmp_path / "stub.c")], check=True)
    routes = [("a LAPACK the loader cannot find",
               ["-Wl,--no-as-needed", f"-L{tmp_path}",
                f"-l:{stub.name}"])] + routes
    Q, A, q, bl, bu = random_convex_qp(24, 36, seed=1, density=0.5)
    kw = dict(eps_abs=1e-8, eps_rel=1e-8, scaling=2, delta=10.0)
    want = baseline_c.solve(Q, A, q, bl, bu, **kw)
    monkeypatch.setattr(_build, "blas_routes", lambda: routes)
    baseline_c._load.cache_clear()
    try:
        assert baseline_c.linked_blas().startswith("scipy's bundled")
        got = baseline_c.solve(Q, A, q, bl, bu, **kw)
    finally:
        monkeypatch.undo()
        baseline_c._load.cache_clear()
    assert got["status"] == want["status"] == 1
    kkt_check(Q, A, q, bl, bu, got["x"], got["y"], tol=1e-6)
    assert np.max(np.abs(got["x"] - want["x"])) < 1e-6


def _reference_rescue(data, caps):
    """bench.py:289-347's chain from the JAX package's modules."""
    from qpalm_tpu import baseline_c as rb
    from qpalm_tpu.finish_np import palm_finish_np
    from qpalm_tpu.polish import polish_batch_np
    from qpalm_tpu.types import QPData as JQPData

    d = JQPData(*data)
    xs, ys = np.zeros(data.q.shape), np.zeros(data.bmin.shape)
    for j in range(len(caps)):
        r = rb.solve(data.Q[j], data.A[j], data.q[j], data.bmin[j],
                     data.bmax[j], eps_abs=0.5e-6, eps_rel=0.5e-6,
                     max_iter=caps[j], scaling=2, delta=10.0)
        xs[j], ys[j] = r["x"], r["y"]
    pol = polish_batch_np(d, xs, ys, eps_abs=1e-6, eps_rel=1e-6, rounds=1)
    ok, x, y = (np.array(a) for a in (pol.ok, pol.x, pol.y))
    still = np.flatnonzero(~ok)
    sub = JQPData(*(a[still] for a in data))
    fin = palm_finish_np(sub, x[still], y[still], eps_abs=1e-6,
                         eps_rel=1e-6)
    pol2 = polish_batch_np(sub, fin.x, fin.y, eps_abs=1e-6, eps_rel=1e-6,
                           rounds=1, refine_steps=0)
    ok[still], x[still], y[still] = pol2.ok, pol2.x, pol2.y
    return ok, x, y, len(still)


def test_rescue_round_matches_the_reference_chain(monkeypatch):
    """Headline lanes handed in as the failing set, two of them with the C
    solve cut to 2 iterations so that its check fails and finish_np runs.
    Both polishes solve by the native Bunch-Kaufman factor: the rescued x,
    y and ok are equal."""
    _port()
    _reference()
    probs = make_problems(4, 64, 96, seed=11)
    data = QPData(*(a.numpy() for a in stack_problems(probs, np.float64)))
    caps = [10000, 2, 10000, 2]
    solve, calls = baseline_c.solve, []

    def capped(*args, **kw):  # the C solve of lanes 1 and 3 cut short
        calls.append(None)
        return solve(*args, **kw, max_iter=caps[len(calls) - 1])

    monkeypatch.setattr(bench.baseline_c, "solve", capped)
    got = bench.rescue_round(data)
    ok, x, y, n_finish = _reference_rescue(data, caps)
    assert n_finish == 2 and got.by_finish == 2 and got.by_c == 2
    assert got.ok.all()
    assert np.array_equal(got.ok, ok)
    assert np.array_equal(got.x, x) and np.array_equal(got.y, y)


def test_bench_prints_one_json_line_on_the_cpu():
    """python -m qpalm_tpu_torch.bench --device cpu at one round of 4
    problems: every lane certified and re-checked by the referee, the C
    baseline measured, and no device metric from a CPU run."""
    _port()
    proc = subprocess.run(
        [sys.executable, "-m", "qpalm_tpu_torch.bench", "--device", "cpu",
         "--rounds", "1", "--reps", "1", "--batch", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    d = out["detail"]
    assert out["metric"] == "qp_solves_per_sec_per_chip_at_1e-6"
    assert out["unit"] == "solves/s" and out["value"] is None
    assert d["device"] == "cpu" and d["path"] == "K1 on chip"
    assert d["solved"] == d["total"] == 4
    assert d["referee_reps"] == [{"checked": 4, "agree": 4}]
    assert d["baseline_solves_per_s"] > 0 and d["baseline_blas"]
    assert len(d["baseline_passes"]) == 4


def test_bench_needs_a_card_unless_told_cpu():
    proc = subprocess.run([sys.executable, "-c", (
        "import torch, qpalm_tpu_torch.bench as b\n"
        "torch.cuda.is_available = lambda: False\n"
        "b.main([])\n")], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "--device cpu" in proc.stderr
