"""Parametric updates and re-solves of the port's QPALM (qpalm_update_*,
reference qpalm.c:739-871) against qpalm_tpu's, mirroring
tests/test_update.py, at the f64 bar of tests/test_torch_api.py.  An update
uploads the host's copies of the padded bounds and q and reads nothing
from the device."""

import dataclasses

import numpy as np
import pytest
import torch

from helpers import kkt_check, random_convex_qp
from qpalm_tpu_torch import QPALM, Settings
import torch_support  # noqa: F401

S = Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False)
PROB = random_convex_qp(5, 8, seed=4)


def _pair():
    """The port's solver and the reference's on PROB."""
    import qpalm_tpu

    return (QPALM(*PROB, settings=S, device="cpu"),
            qpalm_tpu.QPALM(*PROB, settings=qpalm_tpu.Settings(
                **dataclasses.asdict(S))))


def _match(ref, got):
    assert got.info.status_val == int(ref.info.status_val)
    assert got.info.iter == int(ref.info.iter)
    sx = np.maximum(1.0, np.abs(ref.solution.x))
    sy = np.maximum(1.0, np.abs(ref.solution.y))
    assert (np.abs(got.solution.x - ref.solution.x) / sx).max() <= 1e-8
    assert (np.abs(got.solution.y - ref.solution.y) / sy).max() <= 1e-7


def _both(solvers, method, *args):
    return [getattr(s, method)(*args) for s in solvers]


def test_update_bounds_resolve():
    pytest.importorskip("jax")
    Q, A, q, bmin, bmax = PROB
    solvers = _pair()
    r1 = _both(solvers, "solve")
    _match(r1[1], r1[0])
    bmin2, bmax2 = 2 * bmin, 2 * bmax
    _both(solvers, "update_bounds", bmin2, bmax2)
    for s, r in zip(solvers, r1):
        s.warm_start(r.solution.x, r.solution.y)
    r2 = _both(solvers, "solve")
    assert r2[0].info.status == "solved"
    _match(r2[1], r2[0])
    kkt_check(Q, A, q, bmin2, bmax2, r2[0].solution.x, r2[0].solution.y,
              tol=1e-4)


def test_update_q_resolve():
    pytest.importorskip("jax")
    Q, A, q, bmin, bmax = PROB
    solvers = _pair()
    r1 = _both(solvers, "solve")
    _both(solvers, "update_q", -q)
    for s, r in zip(solvers, r1):
        s.warm_start(r.solution.x, r.solution.y)
    r2 = _both(solvers, "solve")
    assert r2[0].info.status == "solved"
    _match(r2[1], r2[0])
    kkt_check(Q, A, -q, bmin, bmax, r2[0].solution.x, r2[0].solution.y,
              tol=1e-4)


def test_update_settings_tightening():
    pytest.importorskip("jax")
    import qpalm_tpu

    solvers = _pair()
    r1 = _both(solvers, "solve")
    tight = S.replace(eps_abs=1e-8, eps_rel=1e-8)
    solvers[0].update_settings(tight)
    solvers[1].update_settings(qpalm_tpu.Settings(
        **dataclasses.asdict(tight)))
    for s, r in zip(solvers, r1):
        s.warm_start(r.solution.x, r.solution.y)
    r2 = _both(solvers, "solve")
    assert r2[0].info.status == "solved"
    assert r2[0].info.dua_res_norm <= 1e-7
    _match(r2[1], r2[0])


def test_update_validation():
    """Decreasing scaling, crossed bounds and wrong lengths raise
    (test_update.py:55-75)."""
    _, _, _, bmin, bmax = PROB
    s = QPALM(*PROB, settings=S, device="cpu")
    with pytest.raises(ValueError):
        s.update_settings(S.replace(scaling=max(S.scaling - 1, 0)))
    with pytest.raises(ValueError):
        s.update_bounds(np.full_like(bmin, 2.0), np.full_like(bmax, 1.0))
    with pytest.raises(ValueError):
        s.update_bounds(bmin[:-1], None)
    with pytest.raises(ValueError):
        s.update_q(np.zeros(3))
    # a refused update leaves the bounds as they were
    r = s.solve()
    assert r.info.status == "solved"


def test_updates_match_fresh_setup():
    """test_update.py:78-93: an updated solver agrees with a fresh one."""
    Q, A, q, bmin, bmax = PROB
    s = QPALM(*PROB, settings=S, device="cpu")
    s.solve()
    q2, bmax2 = q + 0.5, bmax + 1.0
    s.update_q(q2)
    s.update_bounds(bmin, bmax2)
    r_upd = s.solve()
    r_fresh = QPALM(Q, A, q2, bmin, bmax2, settings=S, device="cpu").solve()
    assert r_upd.info.iter == r_fresh.info.iter
    np.testing.assert_array_equal(r_upd.solution.x, r_fresh.solution.x)


class _Reads:
    """Counts the tensor methods that read a tensor's values to the host."""

    NAMES = ("cpu", "numpy", "item", "tolist", "__bool__", "__int__",
             "__float__")

    def __init__(self, monkeypatch):
        self.counts = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def wrapped(t, *a, _orig=orig, _name=name, **k):
                self.counts[_name] += 1
                return _orig(t, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, wrapped)


def test_updates_read_nothing_from_the_device(monkeypatch):
    """update_bounds, update_q and warm_start read no tensor; a solve reads
    its result in one copy, beside the loop's done flags (one read every
    core.SYNC_STRIDE iterations)."""
    from qpalm_tpu_torch.solver.core import SYNC_STRIDE

    _, _, q, bmin, bmax = PROB
    s = QPALM(*PROB, settings=S, device="cpu")
    r = s.solve()
    reads = _Reads(monkeypatch)
    s.update_bounds(1.5 * bmin, 1.5 * bmax)
    s.update_q(q + 0.1)
    s.warm_start(r.solution.x, r.solution.y)
    assert sum(reads.counts.values()) == 0, reads.counts
    r2 = s.solve()
    monkeypatch.undo()
    assert r2.info.status == "solved"
    assert reads.counts["cpu"] == 1, reads.counts
    assert reads.counts["__bool__"] <= r2.info.iter // SYNC_STRIDE + 2
    assert sum(reads.counts[k] for k in ("item", "tolist", "__int__",
                                         "__float__")) == 0, reads.counts


def test_sequential_mpc_step_reads_only_its_result(monkeypatch):
    """A closed-loop step (workloads.SequentialMPC.step: warm start, solve,
    update_bounds) reads the device once for the solution and Info, beside
    the loop's done flags."""
    from qpalm_tpu_torch.solver.core import SYNC_STRIDE
    from qpalm_tpu_torch.workloads import SequentialMPC

    mpc = SequentialMPC(n_masses=2, horizon=4, seed=0, device="cpu")
    mpc.step()
    for _ in range(2):
        reads = _Reads(monkeypatch)
        status, it, _ = mpc.step()
        monkeypatch.undo()
        assert status == "solved"
        assert reads.counts["cpu"] == 1, reads.counts
        assert reads.counts["__bool__"] <= it // SYNC_STRIDE + 2
        assert sum(reads.counts[k] for k in ("item", "tolist", "__int__",
                                             "__float__")) == 0, reads.counts
