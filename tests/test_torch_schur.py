"""Constraint sharding in the PyTorch port (qpalm_tpu_torch/parallel/
schur.py) against the JAX package's (qpalm_tpu/parallel/schur.py) on the
8 virtual CPU devices of tests/conftest.py: the sharded Schur matrix, and
one QP solved with its rows split over LocalMesh(1, 2, 4, 8) and over 2
gloo processes."""

import numpy as np
import pytest

from helpers import random_convex_qp
from qpalm_tpu_torch import FACTORIZE_KKT, Settings
from qpalm_tpu_torch.batch import pad_problem
from qpalm_tpu_torch.parallel import LocalMesh, solve_constraint_sharded
from qpalm_tpu_torch.parallel.schur import sharded_schur_matrix
from qpalm_tpu_torch.workloads import random_qp
import torch_support  # noqa: F401

SETTINGS = dict(eps_abs=1e-6, eps_rel=1e-6)


def _case(name):
    """The reference's case (tests/test_batch.py:111-123: n=12, m=16,
    seed 11, padded to 16) or randomQP n=24, m=64."""
    if name == "test_batch":
        Q, A, q, lo, hi = random_convex_qp(12, 16, seed=11)
        return pad_problem(Q, A, q, lo, hi, 16, 16, np.float64) \
            + (np.zeros(()),)
    return tuple(np.asarray(a, np.float64) for a in random_qp(24, 64,
                                                               seed=5)) \
        + (np.zeros(()),)


@pytest.fixture(scope="module")
def reference():
    """The JAX solve_constraint_sharded of each case on the 8-device
    mesh."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import qpalm_tpu
    from qpalm_tpu.parallel import default_mesh
    from qpalm_tpu.parallel import solve_constraint_sharded as ref
    from qpalm_tpu.types import QPData

    assert len(jax.devices()) == 8
    mesh = default_mesh()
    out = {}
    for name in ("test_batch", "randomQP"):
        d = QPData(*(jnp.asarray(a) for a in _case(name)))
        x, y, status, iters, obj = ref(d, qpalm_tpu.Settings(**SETTINGS),
                                       mesh, "qp")
        out[name] = (np.asarray(x), np.asarray(y), int(status), int(iters),
                     float(obj))
    return out


def test_sharded_schur_matrix_matches_reference():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from qpalm_tpu.parallel import default_mesh
    from qpalm_tpu.parallel.schur import sharded_schur_matrix as ref

    rng = np.random.default_rng(3)
    A = rng.standard_normal((64, 24))
    ss = np.sqrt(rng.uniform(0.1, 10.0, 64))
    act = rng.random(64) < 0.6
    want = np.asarray(ref(jnp.asarray(A), jnp.asarray(ss), jnp.asarray(act),
                          default_mesh(), "qp"))
    for k in (1, 2, 4, 8):
        got = sharded_schur_matrix(A, ss, act, LocalMesh(k, device="cpu"))
        assert got.shape == (24, 24)
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert rel <= 1e-12, (k, rel)
    with pytest.raises(ValueError):
        sharded_schur_matrix(A[:63], ss[:63], act[:63],
                             LocalMesh(2, device="cpu"))


@pytest.mark.parametrize("name", ["test_batch", "randomQP"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_constraint_sharded_matches_reference(reference, name, k):
    """Equal status and iteration count, x within 1e-9, on LocalMesh(k)."""
    x_r, y_r, st_r, it_r, obj_r = reference[name]
    x, y, st, it, obj = solve_constraint_sharded(
        _case(name), Settings(**SETTINGS), LocalMesh(k, device="cpu"))
    assert int(st) == st_r == 1
    assert int(it) == it_r
    assert x.shape == x_r.shape and y.shape == y_r.shape
    assert np.abs(x.numpy() - x_r).max() <= 1e-9
    assert np.abs(y.numpy() - y_r).max() <= 1e-7
    assert abs(float(obj) - obj_r) <= 1e-9 * max(1.0, abs(obj_r))


def test_constraint_sharded_rejects_what_it_cannot_split():
    data = _case("test_batch")
    with pytest.raises(ValueError):
        solve_constraint_sharded(data, Settings(), LocalMesh(3, device="cpu"))
    with pytest.raises(ValueError):
        solve_constraint_sharded(
            data, Settings(factorization_method=FACTORIZE_KKT),
            LocalMesh(2, device="cpu"))


def test_two_gloo_processes_bit_identical_to_localmesh(tmp_path):
    """parallel/dryrun.py over 2 gloo processes: the constraint-sharded
    solve's x, y, iterations and objective bit for bit LocalMesh(2)'s
    (with the dry run's other paths)."""
    from qpalm_tpu_torch.parallel.dryrun import dryrun_processes

    checked = dryrun_processes(2, tmp_path, timeout=60.0)
    for key in ("schur_x", "schur_y", "schur_iterations", "schur_objective"):
        assert checked.get(key), key
