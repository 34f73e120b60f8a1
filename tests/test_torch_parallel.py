"""Data-parallel batches and the multi-process dry run of the PyTorch port
(qpalm_tpu_torch/parallel/sharded.py, dryrun.py, mesh.py) on the CPU:
solve_batch_sharded against tests/test_batch.py:78-109, 188-211 (the JAX
package's vmapped solve of the same stacked batch), and one spawn of 4
gloo processes whose DistMesh(4) results are bit-identical to
LocalMesh(4)'s."""

import dataclasses

import numpy as np
import pytest
import torch

from qpalm_tpu_torch import Settings
from qpalm_tpu_torch import constants as C
from qpalm_tpu_torch.batch import solve_batch, stack_problems
from qpalm_tpu_torch.parallel import (LocalMesh, default_mesh,
                                      pad_batch_to_devices,
                                      solve_batch_sharded)

from helpers import random_convex_qp
import torch_support  # noqa: F401

SETTINGS = Settings(eps_abs=1e-6, eps_rel=1e-6)


def _problems(k, n=6, m=9, seed0=0):
    return [random_convex_qp(n, m, seed=seed0 + i) for i in range(k)]


def _zeros(data):
    B = data.q.shape[0]
    return (torch.zeros_like(data.q), torch.zeros_like(data.bmin),
            torch.full((B,), SETTINGS.gamma_init, dtype=data.q.dtype))


def test_default_mesh_is_local_without_a_process_group():
    mesh = default_mesh(8, device="cpu")
    assert isinstance(mesh, LocalMesh) and mesh.size == 8
    assert default_mesh(device="cpu").size == 1


def test_sharded_batch_matches_reference_vmap():
    """tests/test_batch.py:78-93 and 188-211: the shards' results equal the
    port's unsharded general loop bit for bit and the JAX package's vmapped
    solve at the f64 bar; the aggregates ride one packed collective, and
    aggregate=False gives the per-shard partials that reduce to them."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import qpalm_tpu
    from qpalm_tpu.batch import solve_batch_jit
    from qpalm_tpu.batch import stack_problems as jstack

    probs = _problems(16)
    data = stack_problems(probs, np.float64)
    x_ws, y_ws, gamma = _zeros(data)
    mesh = LocalMesh(8, device="cpu")
    res, agg = solve_batch_sharded(data, x_ws, y_ws, gamma, SETTINGS, False,
                                   False, mesh)
    one = solve_batch(probs, SETTINGS.replace(use_fused="never"),
                      device="cpu")
    assert torch.equal(res.x, one.x) and torch.equal(res.iterations,
                                                     one.iterations)
    jd = jstack(probs, np.float64)
    B, n_pad = data.q.shape
    ref = solve_batch_jit(jd, jnp.zeros((B, n_pad)),
                          jnp.zeros((B, data.bmin.shape[1])),
                          jnp.full((B,), SETTINGS.gamma_init),
                          qpalm_tpu.Settings(**dataclasses.asdict(SETTINGS)),
                          False, False)
    assert np.array_equal(res.status.numpy(), np.asarray(ref.status))
    assert np.array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    assert np.abs(res.x.numpy() - np.asarray(ref.x)).max() < 1e-8
    assert int(agg["n_solved"]) == 16 and agg["n_solved"].dtype == torch.int32
    assert int(agg["total_iters"]) == int(np.asarray(ref.iterations).sum())
    assert int(agg["max_iters"]) == int(np.asarray(ref.iterations).max())
    assert agg["total_iters"].dtype == torch.int64

    res2, part = solve_batch_sharded(data, x_ws, y_ws, gamma, SETTINGS,
                                     False, False, mesh, aggregate=False)
    assert torch.equal(res.x, res2.x)
    assert tuple(part["n_solved"].shape) == (8,)
    assert int(part["n_solved"].sum()) == int(agg["n_solved"])
    assert int(part["total_iters"].sum()) == int(agg["total_iters"])
    assert int(part["max_iters"].max()) == int(agg["max_iters"])
    iters = res.iterations.reshape(8, 2)
    assert torch.equal(part["max_iters"], iters.amax(-1))
    with pytest.raises(ValueError, match="pad_batch_to_devices"):
        solve_batch_sharded(data, x_ws, y_ws, gamma, SETTINGS, False, False,
                            LocalMesh(3, device="cpu"))


def test_sharded_warm_start_and_gamma_pins():
    """Warm starts and per-lane gamma pins reach each shard's lanes as
    they reach the unsharded loop."""
    from qpalm_tpu_torch.solver import core

    probs = _problems(4, seed0=40)
    data = stack_problems(probs, np.float64)
    cold = solve_batch(probs, SETTINGS.replace(use_fused="never"),
                       device="cpu")
    gamma = torch.full((4,), 1e3, dtype=torch.float64)
    s = SETTINGS.replace(proximal=True)
    res, agg = solve_batch_sharded(data, cold.x, cold.y, gamma, s, True,
                                   True, LocalMesh(2, device="cpu"))
    final, x, _, _ = core.full_solve(data, s, cold.x, cold.y, gamma, gamma)
    assert torch.equal(res.x, x) and torch.equal(res.iterations, final.iter)
    assert int(agg["total_iters"]) < int(cold.iterations.sum())


def test_pad_batch_to_devices():
    """tests/test_batch.py:96-109: dummy problems solve trivially, real
    ones match their solo solves."""
    probs = _problems(5)
    data = stack_problems(probs, np.float64)
    data2, mask = pad_batch_to_devices(data, 8)
    assert data2.q.shape[0] == 8 and mask.sum() == 5 and mask[:5].all()
    assert pad_batch_to_devices(data2, 4)[0] is data2
    x_ws, y_ws, gamma = _zeros(data2)
    res, agg = solve_batch_sharded(data2, x_ws, y_ws, gamma, SETTINGS, False,
                                   False, LocalMesh(8, device="cpu"))
    assert bool((res.status == C.QPALM_SOLVED).all())
    assert int(agg["n_solved"]) == 8
    solo = solve_batch(probs, SETTINGS.replace(use_fused="never"),
                       device="cpu")
    assert torch.equal(res.x[:5], solo.x)
    assert float(res.x[5:].abs().max()) == 0.0


def test_gloo_dryrun_four_processes_bit_identical(tmp_path):
    """The dry run (data-parallel batches with both aggregate modes,
    SPIKE, the stage-sharded loop, the constraint-sharded solve) over 4
    spawned gloo processes meeting
    through a FileStore: every rank's results bit-identical to
    LocalMesh(4)'s.  The process group and the join each wait at most
    60 s."""
    from qpalm_tpu_torch.parallel.dryrun import dryrun_processes

    checked = dryrun_processes(4, tmp_path, timeout=60.0)
    for key in ("sharded_dp_x", "dp_n_solved", "dp_total_iters",
                "dp_max_iters", "sharded_dp_part_max_iters",
                "sharded_spike_x", "sharded_mpc_z", "mpc_iterations",
                "schur_x", "schur_y", "schur_iterations"):
        assert checked.get(key), key
