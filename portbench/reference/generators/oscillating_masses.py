"""The oscillating masses of Wang and Boyd (Fast model predictive control
using online optimization, IEEE TCST 18(2), 2010, section V): a row of
unit masses joined to each other and to walls at both ends by unit
springs, no damping; actuators exert tensions between pairs of masses.
The continuous system is sampled with a zero-order hold.

The MPC problem at state x(t): minimise the sum over tau = t .. t+T-1 of
x(tau)' Q x(tau) + u(tau)' R u(tau), plus x(t+T)' Qf x(t+T), subject to
the dynamics and |x| <= xmax, |u| <= umax on every predicted state and
input.  As a QP in z = [x(t+1) .. x(t+T), u(t) .. u(t+T-1)], the dynamics
are equality rows and the boxes identity rows; rows [0, nx) of the bounds
are A x(t), the only ones that change from step to step."""

from __future__ import annotations

import numpy as np


def _expm(M):
    """exp(M) by scaling and squaring a Taylor series (plain numpy)."""
    norm = np.abs(M).sum(axis=1).max()
    s = max(0, int(np.ceil(np.log2(max(norm, 1e-300)))) + 1)
    X = M / 2.0 ** s
    E, term = np.eye(len(M)), np.eye(len(M))
    for k in range(1, 30):
        term = term @ X / k
        E = E + term
    for _ in range(s):
        E = E @ E
    return E


def plant(cfg):
    """(Ad, Bd): the sampled dynamics of `cfg`'s masses and actuators."""
    nm = int(cfg["n_masses"])
    k, lam = float(cfg["spring"]), float(cfg["damping"])
    nx, nu = 2 * nm, len(cfg["actuator_pairs"])
    K = np.diag(np.full(nm, -2.0 * k)) + np.diag(np.full(nm - 1, k), 1) \
        + np.diag(np.full(nm - 1, k), -1)
    D = np.diag(np.full(nm, -2.0 * lam)) + np.diag(np.full(nm - 1, lam), 1) \
        + np.diag(np.full(nm - 1, lam), -1)
    Ac = np.zeros((nx, nx))
    Ac[:nm, nm:] = np.eye(nm)
    Ac[nm:, :nm] = K
    Ac[nm:, nm:] = D
    Bc = np.zeros((nx, nu))
    for j, (a, b) in enumerate(cfg["actuator_pairs"]):  # 1-based masses
        Bc[nm + a - 1, j] = 1.0
        Bc[nm + b - 1, j] = -1.0
    # zero-order hold: exp([[Ac, Bc], [0, 0]] ts) = [[Ad, Bd], [0, I]]
    aug = np.zeros((nx + nu, nx + nu))
    aug[:nx, :nx], aug[:nx, nx:] = Ac, Bc
    E = _expm(aug * float(cfg["ts"]))
    return E[:nx, :nx], E[:nx, nx:]


def qp(cfg, Ad, Bd, x0):
    """The MPC QP (H, A, q, bmin, bmax) at state x0."""
    nx, nu = Bd.shape
    T = int(cfg["horizon"])
    nz = T * (nx + nu)
    Qw = float(cfg["q_weight"]) * np.eye(nx)
    H = np.zeros((nz, nz))
    for k in range(T):
        H[k * nx:(k + 1) * nx, k * nx:(k + 1) * nx] = Qw
        off = T * nx + k * nu
        H[off:off + nu, off:off + nu] = float(cfg["r_weight"]) * np.eye(nu)
    H[(T - 1) * nx:T * nx, (T - 1) * nx:T * nx] = \
        float(cfg["qf_weight"]) * np.eye(nx)
    H *= 2.0  # the QP's 0.5 z'Hz is the cost's z'(H/2)z
    Aeq = np.zeros((T * nx, nz))
    for k in range(T):
        rows = slice(k * nx, (k + 1) * nx)
        Aeq[rows, k * nx:(k + 1) * nx] = np.eye(nx)
        if k > 0:
            Aeq[rows, (k - 1) * nx:k * nx] = -Ad
        Aeq[rows, T * nx + k * nu:T * nx + (k + 1) * nu] = -Bd
    beq = np.zeros(T * nx)
    beq[:nx] = Ad @ np.asarray(x0, np.float64)
    lim = np.concatenate([np.full(T * nx, float(cfg["xmax"])),
                          np.full(T * nu, float(cfg["umax"]))])
    A = np.vstack([Aeq, np.eye(nz)])
    return (H, A, np.zeros(nz), np.concatenate([beq, -lim]),
            np.concatenate([beq, lim]))


def disturbances(cfg, traffic, steps, seed):
    """(steps, nx) disturbances w(t): i.i.d. uniform on [-a, a] on the
    velocities, none on the positions (a = traffic's `amplitude`)."""
    nm = int(cfg["n_masses"])
    w = np.zeros((steps, 2 * nm))
    a = float(traffic["amplitude"])
    w[:, nm:] = a * (2.0 * np.random.default_rng([seed, 1]).random(
        (steps, nm)) - 1.0)
    return w
