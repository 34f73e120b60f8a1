"""The port's device polish (polish_device.polish_batch, kernel K2 inside)
against qpalm_tpu.polish_device.polish_batch_tpu on the inputs of
tests/test_polish.py:157-172, and the port's host referee against
qpalm_tpu.polish.polish_batch_np(rounds=0)."""

import numpy as np
import pytest
import torch

from helpers import random_convex_qp
from qpalm_tpu_torch.polish_device import polish_batch
from qpalm_tpu_torch.referee import referee
from qpalm_tpu_torch.types import qpdata_from_numpy
import torch_support  # noqa: F401

MODES = [
    dict(seed_guard="norm", refine_iters=3, second_round_k=8),
    dict(seed_guard="norm", refine_iters=3, second_round_k=8,
         residual32=True, accept_viol=0.5),
    dict(seed_guard=True, refine_iters=4),
]


@pytest.fixture(scope="module")
def seeds():
    """The f32 JAX solve the reference test polishes (test_polish.py:20)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from qpalm_tpu import Settings
    from qpalm_tpu.batch import solve_batch_jit, stack_problems

    probs = [random_convex_qp(24, 36, seed=500 + i, density=0.5)
             for i in range(32)]
    s32 = Settings(dtype="float32", eps_abs=5e-5, eps_rel=5e-5, max_iter=200,
                   scaling=2, max_refine=0, delta=10.0)
    d32 = stack_problems(probs, np.float32)
    B, n_pad = d32.q.shape
    m_pad = d32.bmin.shape[1]
    r32 = solve_batch_jit(
        d32, jnp.zeros((B, n_pad), jnp.float32),
        jnp.zeros((B, m_pad), jnp.float32),
        jnp.full((B,), s32.gamma_init, jnp.float32), s32, False, False)
    d64 = jax.tree.map(np.asarray, stack_problems(probs, np.float64))
    return d64, np.asarray(r32.x), np.asarray(r32.y)


@pytest.mark.parametrize("kw", MODES, ids=["norm", "residual32", "guard"])
def test_polish_matches_reference(seeds, kw):
    import jax.numpy as jnp
    from qpalm_tpu.polish_device import polish_batch_tpu

    d64, x32, y32 = seeds
    ref = polish_batch_tpu(type(d64)(*map(jnp.asarray, d64)),
                           jnp.asarray(x32), jnp.asarray(y32), **kw)
    data = qpdata_from_numpy(*d64, device="cpu")
    got = polish_batch(data, torch.from_numpy(x32), torch.from_numpy(y32),
                       **kw)
    ok_ref = np.asarray(ref.ok)
    ok = got.ok.numpy()
    assert (ok == ok_ref).sum() >= 30, (ok, ok_ref)
    assert referee(data, got.x, got.y)[ok].all()
    both = ok & ok_ref
    dx = np.max(np.abs(got.x.numpy()[both] - np.asarray(ref.x)[both]))
    assert dx < 1e-5, dx


def test_referee_matches_host_check(seeds):
    from qpalm_tpu.polish import polish_batch_np

    d64, x32, y32 = seeds
    data = qpdata_from_numpy(*d64, device="cpu")
    pol = polish_batch(data, torch.from_numpy(x32), torch.from_numpy(y32),
                       seed_guard="norm", refine_iters=2)
    # polished points (mostly certified) and raw f32 seeds (mostly not)
    for x, y in ((pol.x, pol.y), (torch.from_numpy(x32).double(),
                                  torch.from_numpy(y32).double())):
        ref = polish_batch_np(d64, x.numpy(), y.numpy(), rounds=0)
        assert np.array_equal(referee(data, x, y), np.asarray(ref.ok))
