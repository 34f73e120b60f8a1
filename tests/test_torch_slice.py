"""The port's whole slice (stack -> scale -> K1 -> finish -> device polish
-> host referee) against the same chain in the JAX package, at a small
size of the headline problem class."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from qpalm_tpu_torch.batch import stack_problems
from qpalm_tpu_torch.polish_device import polish_batch
from qpalm_tpu_torch.referee import referee
from qpalm_tpu_torch.solver.fused import solve_batch_fused
from qpalm_tpu_torch.types import Settings
from qpalm_tpu_torch.workloads import make_problems
import torch_support  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# the headline settings (bench.py:194-197)
S32 = dict(dtype="float32", eps_abs=5e-5, eps_rel=5e-5, max_iter=96,
           scaling=2, max_refine=0, delta=10.0)
POLISH = dict(eps_abs=1e-6, eps_rel=1e-6, refine_iters=2, second_round_k=64,
              seed_guard="norm")


def test_make_problems_is_the_bench_generator():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for a, b in zip(make_problems(3, 8, 12, seed=5),
                    bench.make_problems(3, 8, 12, seed=5)):
        for u, v in zip(a, b):
            assert np.array_equal(u, v)


def test_slice_matches_reference_chain():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import qpalm_tpu
    from qpalm_tpu.batch import stack_problems as jstack
    from qpalm_tpu.polish_device import polish_batch_tpu
    from qpalm_tpu.solver.fused import solve_batch_fused as jsolve

    probs = make_problems(128, 24, 36, seed=7)
    r = jsolve(jstack(probs, np.float32), qpalm_tpu.Settings(**S32),
               interpret=True)
    d64j = jax.tree.map(jnp.asarray, jstack(probs, np.float64))
    ok_ref = np.asarray(polish_batch_tpu(d64j, r[0], r[1], **POLISH).ok)

    x, y, status, iters = solve_batch_fused(
        stack_problems(probs, np.float32), Settings(**S32))[:4]
    assert np.array_equal(status.numpy(), np.asarray(r[2]))
    d64 = stack_problems(probs, np.float64)
    pol = polish_batch(d64, x, y, **POLISH)
    ok = pol.ok.numpy()
    assert (ok == ok_ref).sum() >= 125, (ok.sum(), ok_ref.sum())
    assert ok.sum() >= 0.95 * len(probs)
    assert referee(d64, pol.x, pol.y)[ok].all()
    assert torch.isfinite(pol.x[pol.ok]).all()
    assert torch.isfinite(pol.y[pol.ok]).all()
