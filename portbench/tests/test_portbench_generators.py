"""The benchmark's input generators make what their sources state: the
random QP class at its sizes and density, and the oscillating masses'
sampled dynamics, MPC problem and disturbances."""

import json

import numpy as np
import pytest
import scipy.linalg

from portbench.reference.generators import oscillating_masses as om
from portbench.reference.generators import random_qp

from .conftest import ROOT

RQP = json.loads((ROOT / "portbench/configs/randomqp_n100.json").read_text())
OM = json.loads((ROOT / "portbench/configs/masses6_t30.json").read_text())


@pytest.mark.parametrize("seed", [7, [3000000011, 0], [2 ** 33 + 5, 15]])
def test_random_qp_class(seed):
    probs = random_qp.problems(RQP, 6, seed)
    again = random_qp.problems(RQP, 6, seed)
    n, m = RQP["n"], RQP["m"]
    nnz = 0
    for (Q, A, q, lo, hi), p2 in zip(probs, again):
        for u, v in zip((Q, A, q, lo, hi), p2):
            np.testing.assert_array_equal(u, v)  # the same seed, the same
        assert Q.shape == (n, n) and A.shape == (m, n) and q.shape == (n,)
        np.testing.assert_array_equal(Q, Q.T)
        assert np.linalg.eigvalsh(Q).min() > 0
        assert np.all(lo == -hi) and np.all((hi >= 0) & (hi < 2))
        nnz += np.count_nonzero(A)
    assert abs(nnz / (6 * m * n) - RQP["density"]) < 0.02
    other = random_qp.problems(RQP, 1, 12345)[0][1]
    assert not np.array_equal(other, probs[0][1])


def test_oscillating_masses_plant_is_the_sampled_chain():
    Ad, Bd = om.plant(OM)
    nm = OM["n_masses"]
    assert Ad.shape == (2 * nm, 2 * nm) and Bd.shape == (2 * nm, 3)
    K = (np.diag(np.full(nm, -2.0)) + np.diag(np.ones(nm - 1), 1)
         + np.diag(np.ones(nm - 1), -1))
    Ac = np.block([[np.zeros((nm, nm)), np.eye(nm)], [K, np.zeros((nm, nm))]])
    Bc = np.zeros((2 * nm, 3))
    for j, (a, b) in enumerate(OM["actuator_pairs"]):
        Bc[nm + a - 1, j], Bc[nm + b - 1, j] = 1.0, -1.0
    np.testing.assert_allclose(Ad, scipy.linalg.expm(OM["ts"] * Ac),
                               atol=1e-13)
    # the zero-order hold: Bd = Ac^-1 (Ad - I) Bc for an invertible Ac
    np.testing.assert_allclose(
        Bd, np.linalg.solve(Ac, (Ad - np.eye(2 * nm)) @ Bc), atol=1e-12)


def test_oscillating_masses_qp_layout():
    Ad, Bd = om.plant(OM)
    nx, nu, T = 12, 3, OM["horizon"]
    x0 = np.random.default_rng(3).uniform(-1, 1, nx)
    H, A, q, lo, hi = om.qp(OM, Ad, Bd, x0)
    assert H.shape == (450, 450) and A.shape == (810, 450)
    assert (OM["variables"], OM["constraints"]) == A.shape[::-1]
    # a trajectory under any inputs meets the dynamics rows exactly
    u = np.random.default_rng(4).uniform(-0.5, 0.5, (T, nu))
    xs, x = [], x0
    for k in range(T):
        x = Ad @ x + Bd @ u[k]
        xs.append(x)
    z = np.concatenate([np.concatenate(xs), u.ravel()])
    r = A @ z
    np.testing.assert_allclose(r[:T * nx], lo[:T * nx], atol=1e-12)
    np.testing.assert_array_equal(lo[:T * nx], hi[:T * nx])
    np.testing.assert_array_equal(hi[T * nx:], np.r_[np.full(T * nx, 4.0),
                                                     np.full(T * nu, 0.5)])
    # the cost: sum x'Qx + u'Ru over the horizon (Q = R = Qf = I)
    assert np.isclose(0.5 * z @ H @ z, z @ z) and not q.any()


def test_disturbances_are_on_the_velocities():
    w = om.disturbances(OM, {"amplitude": 0.5}, 4000, 2 ** 33 + 1)
    assert w.shape == (4000, 12) and not w[:, :6].any()
    assert np.abs(w[:, 6:]).max() <= 0.5
    assert abs(w[:, 6:].std() - 0.5 / np.sqrt(3)) < 0.01
    np.testing.assert_array_equal(
        w, om.disturbances(OM, {"amplitude": 0.5}, 4000, 2 ** 33 + 1))
