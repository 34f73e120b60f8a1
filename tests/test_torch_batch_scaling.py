"""Padding, stacking and Ruiz scaling of the PyTorch port against
qpalm_tpu.batch.stack_problems and qpalm_tpu.scaling.scale_data."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from helpers import random_convex_qp
from qpalm_tpu_torch.batch import stack_problems
from qpalm_tpu_torch.scaling import scale_data
from qpalm_tpu_torch.types import qpdata_from_numpy


def _mixed_problems():
    probs = [random_convex_qp(n, m, seed=10 + i, density=0.5)
             for i, (n, m) in enumerate([(5, 7), (12, 3), (9, 18), (16, 24)])]
    Q, A, q, bl, bu = random_convex_qp(6, 4, seed=20)
    bl[0], bu[1] = -1e30, 1e30  # beyond the padding bound: clipped
    probs.append((sp.csc_matrix(Q), sp.csc_matrix(A), q, bl, bu, 2.5))
    return probs


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stack_problems_matches_reference(dtype):
    pytest.importorskip("jax")
    from qpalm_tpu.batch import stack_problems as jstack

    probs = _mixed_problems()
    ref = jstack(probs, dtype)
    got = stack_problems(probs, dtype)
    for name in ref._fields:
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert np.array_equal(g, r), name


def test_qpdata_from_numpy_keeps_arrays():
    probs = _mixed_problems()
    d = stack_problems(probs, np.float64)
    back = qpdata_from_numpy(*(t.numpy() for t in d), device="cpu")
    for a, b in zip(d, back):
        assert torch.equal(a, b)


@pytest.mark.parametrize("iters", [0, 2, 10])
def test_scale_data_matches_reference(iters):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from qpalm_tpu.batch import stack_problems as jstack
    from qpalm_tpu.scaling import scale_data as jscale

    probs = [random_convex_qp(12, 18, seed=30 + i, density=0.5)
             for i in range(8)]
    jd = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                      jstack(probs, np.float32))
    rs, rscal = jax.vmap(lambda d: jscale(d, iters))(jd)
    gs, gscal = scale_data(stack_problems(probs, np.float32), iters)

    def close(r, g, name):
        r = np.asarray(r)
        g = g.numpy()
        assert g.dtype == np.float32, name
        err = np.max(np.abs(g - r)) / max(np.max(np.abs(r)), 1e-30)
        assert err < 1e-6, (name, err)

    for name in ("D", "Dinv", "E", "Einv", "c", "cinv"):
        close(getattr(rscal, name), getattr(gscal, name), name)
    for name in ("Q", "A", "q"):
        close(getattr(rs, name), getattr(gs, name), name)
    # the bounds hold the +-1e21 padding; compare the finite rows
    for name in ("bmin", "bmax"):
        r = np.asarray(getattr(rs, name))
        g = getattr(gs, name).numpy()
        fin = np.abs(r) < 1e20
        assert np.allclose(g[fin], r[fin], rtol=1e-6, atol=0), name
        assert np.allclose(g[~fin], r[~fin], rtol=1e-6), name
