"""The correction of the device polish's rejected lanes
(polish_device.correct_rejected) on the CPU twins, and the shape gate by
which polish_batch runs it.

The problems are OSQP's random QP class (the benchmark's generator) cut
to n = 48, m = 480, where the polish rejects lanes for the reason it does
at n = 256: its margin act_tol takes a row just inside its bounds as
active.  The correction certifies only some of them at this size (its 10
sweeps at delta_hat 0.1 converge slowly here), so each batch also keeps
lanes for the rescue."""

import numpy as np
import pytest
import torch

from portbench.reference.generators import osqp_random_qp
from portbench.reference.kkt import kkt_ratio
from qpalm_tpu_torch import bench, trace
from qpalm_tpu_torch import polish_device as PD
from qpalm_tpu_torch.batch import stack_problems
from qpalm_tpu_torch.solver.fused import solve_batch_fused
from qpalm_tpu_torch.types import QPData
from torch_support import clean_recorder  # noqa: F401

CLASS = dict(n=48, m=480, density=0.15, alpha=0.01)
CORRECT = {k: v for k, v in bench.POLISH.items() if k != "refine_iters"}
_k1 = {}


def k1_answers(seed, batch=16):
    """The f64 stack of `batch` problems of the class from `seed`, and K1's
    f32 answers to them (the benchmark's f32 pass)."""
    if seed not in _k1:
        probs = osqp_random_qp.problems(CLASS, batch, seed)
        d64 = stack_problems(probs, np.float64)
        x, y = solve_batch_fused(QPData(*(t.float() for t in d64)),
                                 bench.S32)[:2]
        _k1[seed] = d64, x, y
    return _k1[seed]


@pytest.mark.parametrize("seed", [1, 7, 11])
def test_correction_certifies_rejected_lanes_and_keeps_the_rest(seed):
    d64, x, y = k1_answers(seed)
    pol = PD.polish_batch(d64, x, y, **bench.POLISH)
    cor = PD.correct_rejected(d64, x, y, pol, **CORRECT)
    ok, was = cor.ok.numpy(), pol.ok.numpy()

    assert (ok & ~was).any()       # a rejected lane is certified now
    assert (was <= ok).all()       # no certified lane is lost
    ratio = kkt_ratio(*(t.numpy() for t in d64[:5]), cor.x.numpy(),
                      cor.y.numpy(), 1e-6, 1e-6)
    assert (ratio[ok] <= 1.0).all()
    assert (ratio[~ok] > 1.0).all()  # what it cannot fix goes to the rescue
    assert (~ok).any()
    for a, b in zip(cor, pol):
        assert torch.equal(a[pol.ok], b[pol.ok])  # bit for bit


def test_certified_lanes_stay_where_the_correction_reads_better():
    """Certified lanes handed over at the limit (viol 1.0): the correction
    certifies some of them below it, and still returns every one bit for
    bit."""
    d64, x, y = k1_answers(1)
    pol = PD.polish_batch(d64, x, y, **bench.POLISH)
    true = PD._check(*d64, pol.x, pol.y, 1e-6, 1e-6)[0]
    viol = torch.where(pol.ok, torch.ones_like(true), true)
    cor = PD.correct_rejected(d64, x, y, pol, viol=viol, **CORRECT)
    again = PD.correct_rejected(d64, x, y, pol._replace(ok=~pol.ok),
                                viol=torch.full_like(true, 2.0), **CORRECT)
    better = again.ok & pol.ok      # lanes the correction certifies anew
    assert better.any()
    for a, b in zip(cor, pol):
        assert torch.equal(a[pol.ok], b[pol.ok])


def test_correction_is_polish_batchs_last_step_past_the_gate(monkeypatch):
    """With the gate at 0, polish_batch returns correct_rejected of what it
    returns below the gate."""
    d64, x, y = k1_answers(1)
    pol = PD.polish_batch(d64, x, y, **bench.POLISH)
    want = PD.correct_rejected(d64, x, y, pol, **CORRECT)
    monkeypatch.setattr(PD, "CORRECT_MIN_MN2", 0)
    got = PD.polish_batch(d64, x, y, **bench.POLISH)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _parents_polish(data, x32, y32, eps_abs, eps_rel, refine_iters,
                    second_round_k, seed_guard, residual32, accept_viol):
    """polish_batch as it was before the correction: round 1 from the seed
    and two rounds of the worst second_round_k lanes, with `_detect`."""
    Q, A, q, bmin, bmax, c = (t.to(torch.float64) for t in data)
    x0, y0 = x32.double(), y32.double()
    x, y, viol, pri, dua, obj = PD._polish_core(
        Q, A, q, bmin, bmax, c, x0, y0, eps_abs, eps_rel, 1e-4, 1e-2,
        refine_iters, fallback_to_seed=(seed_guard == "norm"),
        residual32=residual32)
    idx = torch.topk(viol, min(second_round_k, x.shape[0])).indices
    x2, y2 = x[idx], y[idx]
    for _ in range(2):
        x2, y2, viol2, pri2, dua2, obj2 = PD._polish_core(
            Q[idx], A[idx], q[idx], bmin[idx], bmax[idx], c[idx], x2, y2,
            eps_abs, eps_rel, 1e-4, 1e-1, 10,
            fallback_to_seed=bool(seed_guard), residual32=residual32)
    imp = viol2 < viol[idx]
    out = []
    for a, a2 in ((x, x2), (y, y2), (viol, viol2), (pri, pri2), (dua, dua2),
                  (obj, obj2)):
        a = a.clone()
        a[idx] = torch.where(imp[:, None] if a.dim() == 2 else imp, a2,
                             a[idx])
        out.append(a)
    x, y, viol, pri, dua, obj = out
    return PD.DevicePolishResult(x, y, viol <= accept_viol, pri, dua, obj)


@pytest.mark.parametrize("seed", [1, 7])
def test_below_the_gate_the_polish_is_the_parents(seed):
    d64, x, y = k1_answers(seed)
    assert 480 * 48 ** 2 < PD.CORRECT_MIN_MN2
    got = PD.polish_batch(d64, x, y, **bench.POLISH)
    want = _parents_polish(d64, x, y, **bench.POLISH)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,m,on", [(104, 104, False), (256, 2560, True)])
def test_gate_is_by_shape(n, m, on):
    """rqp100's padded shape stays under the gate, orqp256's is past it;
    the batch size plays no part."""
    probs = osqp_random_qp.problems(dict(CLASS, n=n, m=m), 2, 5)
    d64 = stack_problems(probs, np.float64)
    assert tuple(d64.A.shape[1:]) == (m, n)
    trace.enable()
    PD.polish_batch(d64, torch.zeros(2, n), torch.zeros(2, m),
                    **bench.POLISH)
    spans = [s.name for s in trace.drain().spans]
    assert ("polish.correct" in spans) == on
