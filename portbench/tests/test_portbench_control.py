"""`correct` comes out false where it should: for the control (the
program's lower-precision path in place of the configuration's), and for
each fault the cells can have, planted underneath a run whose look for a
card is skipped (the program's plain twins on the CPU).  The control at
each cell's own size runs on the card (marker `cuda`)."""

import numpy as np
import pytest
import torch

from portbench import control, harness

from .conftest import BATCH_CELLS, MPC_CELL


def _run(root, name, seed=2 ** 32 + 3, seconds=1.0):
    torch.set_num_threads(2)
    return harness.run(harness.Cell(name, root=root), seed, seconds, False,
                       device="cpu")


@pytest.mark.parametrize("name", ["tiny.b4", "tiny.mpc"])
def test_control_is_not_correct(tiny_root, name):
    torch.set_num_threads(2)
    r = control.run_control(harness.Cell(name, root=tiny_root), 11, 1.0,
                            device="cpu")
    assert r["correct"] is False
    assert r["checks"]["worst_kkt_ratio"]["value"] > 3.0


def _polish_fault(kind):
    from qpalm_tpu_torch import bench
    from qpalm_tpu_torch.polish_device import DevicePolishResult

    polish = bench.polish_batch

    def faulty(data, x, y, **kwargs):
        if kind == "state_unchanged":
            # the polish's work skipped, its seed returned as certified
            ok = torch.ones(x.shape[0], dtype=torch.bool)
            return DevicePolishResult(x.double(), y.double(), ok, ok, ok, ok)
        if kind == "half_batch":
            # the polish run on the first half; the rest take its flags
            h = x.shape[0] // 2
            first = polish(type(data)(*(t[:h] for t in data)), x[:h], y[:h],
                           **kwargs)
            ok = torch.cat([first.ok, first.ok[:x.shape[0] - h]])
            return DevicePolishResult(torch.cat([first.x, x[h:].double()]),
                                      torch.cat([first.y, y[h:].double()]),
                                      ok, ok, ok, ok)
        out = polish(data, x, y, **kwargs)
        xs = out.x.clone()
        xs[0, 0] += 1e-2  # one answer altered where it is produced
        return out._replace(x=xs)

    return faulty


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered"])
def test_batch_faults_are_not_correct(tiny_root, monkeypatch, kind):
    from qpalm_tpu_torch import bench

    monkeypatch.setattr(bench, "polish_batch", _polish_fault(kind))
    assert _run(tiny_root, "tiny.b4")["correct"] is False


@pytest.mark.parametrize("kind", ["state_unchanged", "answer_altered"])
def test_mpc_faults_are_not_correct(tiny_root, monkeypatch, kind):
    from qpalm_tpu_torch.api import QPALM

    solve = QPALM.solve
    last = []

    def faulty(self):
        res = solve(self)
        if kind == "state_unchanged" and last:
            # the step returns the state it started from
            return last[0]
        if kind == "answer_altered":
            res.solution.x[0] += 1e-2
        last[:] = [res]
        return res

    monkeypatch.setattr(QPALM, "solve", faulty)
    assert _run(tiny_root, "tiny.mpc")["correct"] is False


def test_sound_runs_are_correct(tiny_root):
    for name in ("tiny.b4", "tiny.mpc"):
        r = _run(tiny_root, name)
        assert r["correct"] is True
        assert np.isfinite(r["checks"]["worst_kkt_ratio"]["value"])


@pytest.mark.cuda
@pytest.mark.parametrize("name,seconds", [(BATCH_CELLS[0], 4.0),
                                          (BATCH_CELLS[1], 4.0),
                                          (MPC_CELL, 6.0)])
def test_control_on_the_card(cuda, tiny_root, name, seconds):
    """The control at the cell's own size, on three seeds (the MPC cell
    put back by its entries)."""
    for seed in (3000000101, 3000000102, 3000000103):
        r = control.run_control(harness.Cell(name, root=tiny_root), seed,
                                seconds)
        assert r["correct"] is False, r["checks"]
