"""The port's reference-binding shim (qpalm_tpu_torch.compat) and its
checkpoint utilities (qpalm_tpu_torch.checkpoint) against qpalm_tpu's,
mirroring tests/test_compat_checkpoint.py, on the CPU."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from helpers import random_convex_qp
from qpalm_tpu_torch import Settings, solve
from qpalm_tpu_torch import constants as C
from qpalm_tpu_torch.checkpoint import (load_batch, load_solution, save_batch,
                                        save_solution)
from qpalm_tpu_torch.compat import Qpalm
import torch_support  # noqa: F401

# the reference python demo (interfaces/python/qpalm_python_demo.py)
DEMO_Q = sp.csc_matrix((np.array([1.0, -1.0, -1.0, 2.0]),
                        (np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1]))),
                       shape=(3, 3))
DEMO_A = sp.csc_matrix((np.ones(6), (np.array([0, 1, 0, 2, 0, 3]),
                                     np.array([0, 0, 1, 1, 2, 2]))),
                       shape=(4, 3))
DEMO = dict(Q=DEMO_Q, A=DEMO_A, q=np.array([-2.0, -6.0, 1.0]),
            bmin=np.array([0.5, -10.0, -10.0, -10.0]),
            bmax=np.array([0.5, 10.0, 10.0, 10.0]))


def _demo_flow(solver):
    """tests/test_compat_checkpoint.py:15-50 on either package's shim;
    returns the infos and solutions of its three solves."""
    solver._settings.contents.eps_abs = 1e-10
    solver._settings.contents.eps_rel = 1e-10
    solver._settings.contents.verbose = False
    solver.set_data(**DEMO)
    out = []
    solver._solve()
    out.append((solver._work.info, solver._work.solution))
    solver._warm_start(solver._work.solution.x, solver._work.solution.y)
    solver._solve()
    out.append((solver._work.info, solver._work.solution))
    solver._update_q(np.array([0.0, -3.0, 2.0]))
    solver._update_bounds(np.array([0.4, -12.0, -12.0, -12.0]),
                          np.array([0.6, 12.0, 12.0, 12.0]))
    solver._solve()
    out.append((solver._work.info, solver._work.solution))
    return out


def test_compat_reference_python_demo():
    """The demo's asserted solution, the 0-iteration warm-started re-solve
    and the update paths, each solve equal to the reference shim's."""
    got = _demo_flow(Qpalm(device="cpu"))
    x = got[0][1].x
    assert abs(x[0] - 5.5) < 1e-5
    assert abs(x[1] - 5.0) < 1e-5
    assert abs(x[2] + 10.0) < 1e-5
    assert got[1][0].iter == 0
    assert got[2][0].status == "solved"
    pytest.importorskip("jax")
    from qpalm_tpu.compat import Qpalm as JQpalm

    for (info, sol), (rinfo, rsol) in zip(got, _demo_flow(JQpalm())):
        assert info.status_val == int(rinfo.status_val)
        assert info.iter == int(rinfo.iter)
        scale = np.maximum(1.0, np.abs(rsol.x))
        assert (np.abs(sol.x - np.asarray(rsol.x)) / scale).max() <= 1e-8
        scale = np.maximum(1.0, np.abs(rsol.y))
        assert (np.abs(sol.y - np.asarray(rsol.y)) / scale).max() <= 1e-7


def test_compat_settings_mirror():
    """_MutableSettings mirrors Settings: unknown names raise, and a
    settings update before the first solve is kept."""
    s = Qpalm(device="cpu")
    with pytest.raises(AttributeError):
        s._settings.not_a_setting = 1
    s._settings.max_iter = 7
    assert s._settings.freeze() == Settings(max_iter=7)
    with pytest.raises(RuntimeError):
        s._solve()


def test_checkpoint_roundtrip(tmp_path):
    """test_compat_checkpoint.py:53-65."""
    prob = random_convex_qp(5, 7, seed=9)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)
    res = solve(*prob, settings=s, device="cpu")
    p = str(tmp_path / "ck")
    save_solution(p, res)
    x, y, meta = load_solution(p)
    np.testing.assert_array_equal(x, res.solution.x)
    np.testing.assert_array_equal(y, res.solution.y)
    assert meta == {"status": C.QPALM_SOLVED, "iterations": res.info.iter,
                    "objective": res.info.objective}
    r2 = solve(*prob, settings=s, x0=x, y0=y, device="cpu")
    assert r2.info.iter < 12


def test_batch_checkpoint_roundtrip(tmp_path):
    """test_compat_checkpoint.py:68-77 with the port's BatchResult, whose
    tensors are copied off their device."""
    from qpalm_tpu_torch.batch import solve_batch

    probs = [random_convex_qp(5, 7, seed=i) for i in range(3)]
    res = solve_batch(probs, Settings(eps_abs=1e-6, eps_rel=1e-6,
                                      verbose=False), device="cpu")
    p = str(tmp_path / "batch.npz")
    save_batch(p, res)
    d = load_batch(p)
    np.testing.assert_array_equal(d["x"], res.x.numpy())
    assert d["status"].tolist() == [1, 1, 1]
    assert set(d) == {"x", "y", "status", "iterations", "objective"}
    assert torch.equal(torch.from_numpy(d["iterations"]), res.iterations)
