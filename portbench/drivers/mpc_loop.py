"""Entry driver: one closed-loop MPC controller through the program's
single-problem front end, `qpalm_tpu_torch.api.QPALM`.

A request is one control period: warm start from the last solution,
`solve`, apply u(t) to the plant, step the plant with that period's
disturbance, shift the initial-state rows of the bounds and
`update_bounds`; it is complete when `update_bounds` has returned.  The
plant starts at rest and is disturbed at every step, as the source's
simulation does, so the mix stays stationary: a faster program does not
drift into a settled, easier regime.

The plant, the QP and the disturbances come from the generator the
configuration names (reference/generators/<generator>.py): `plant(cfg)`
gives (Ad, Bd); `qp(cfg, Ad, Bd, x)` the QP (H, A, q, bmin, bmax) at
state x, in z = [x(t+1) .. x(t+T), u(t) .. u(t+T-1)], whose bounds' rows
[0, nx) are Ad x and the only ones that change; `disturbances(cfg,
traffic, steps, seed)` the (steps, nx) disturbances, drawn from the seed.
The program sees only the QP and its bound updates.

The reference (portbench/reference/kkt.py) replays the plant from its
first state, the disturbances and the program's u(t), rebuilds every
step's bounds and judges every step's x and y on them.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.reference.kkt import kkt_ratio


def setup(cfg, traffic, seed, device, tracer, gen):
    from qpalm_tpu_torch.api import QPALM
    from qpalm_tpu_torch.linalg import chol
    from qpalm_tpu_torch.types import Settings

    Ad, Bd = gen.plant(cfg)
    nx, nu = Bd.shape
    x_plant = np.zeros(nx)  # at rest, as the source's simulation starts
    W = gen.disturbances(cfg, traffic, int(traffic["max_steps"]), seed)
    H, A, q, bmin, bmax = gen.qp(cfg, Ad, Bd, x_plant)
    settings = Settings(**cfg["settings"])
    solver = QPALM(H, A, q, bmin, bmax, settings=settings, device=device)
    st = dict(cfg=cfg, traffic=traffic, solver=solver, W=W, x=x_plant,
              Ad=Ad, Bd=Bd, nx=nx, nu=nu, N=int(cfg["horizon"]),
              bmin=bmin.copy(), bmax=bmax.copy(), H=H, A=A, q=q, prev=None,
              k=0, steps=[], chol=chol, device=device)
    # warm-up, untimed by the window: the kernels' build and first launches
    # at this shape, a cold solve and warm-started steps of the same loop
    for _ in range(int(traffic["warmup_steps"])):
        _step(st, tracer)
    st["steps"].clear()
    return st


CONTROL_MAX_ITER = 400


def use_control(st):
    """The control of `correct`: the program's float32 path in place of
    the configuration's float64.  It cannot meet 1e-6 (on the CPU at a
    small size it ran its 10,000 iterations and read 16), so it stops at
    CONTROL_MAX_ITER iterations, some twenty times the float64 path's
    mean a step on the H100 (18-20)."""
    from qpalm_tpu_torch.api import QPALM
    from qpalm_tpu_torch.types import Settings

    settings = Settings(**{**st["cfg"]["settings"], "dtype": "float32",
                           "max_iter": CONTROL_MAX_ITER})
    st["solver"] = QPALM(st["H"], st["A"], st["q"], st["bmin"], st["bmax"],
                         settings=settings, device=st["device"])
    st["prev"] = None


def _step(st, tracer):
    """One control period.  Returns its record."""
    solver, nx, nu, N = st["solver"], st["nx"], st["nu"], st["N"]
    k = st["k"]
    rec = dict(x_plant=st["x"].copy(), k=k, t_in=time.perf_counter())
    if st["prev"] is not None:
        tracer.span("warm_start", solver.warm_start, *st["prev"])
    res = tracer.span("solve", solver.solve)
    z, y = res.solution.x, res.solution.y
    st["prev"] = (z, y)
    u0 = z[N * nx:N * nx + nu].copy()
    st["x"] = st["Ad"] @ st["x"] + st["Bd"] @ u0 + st["W"][k]
    st["k"] = k + 1
    st["bmin"][:nx] = st["Ad"] @ st["x"]
    st["bmax"][:nx] = st["bmin"][:nx]
    tracer.span("update_bounds", solver.update_bounds, st["bmin"],
                st["bmax"])
    rec.update(t_out=time.perf_counter(), status=res.info.status,
               iters=res.info.iter, z=z, y=y, u0=u0)
    st["steps"].append(rec)
    return rec


def window(st, seconds, tracer):
    chol = st["chol"]
    launches0 = chol.cholesky_upper.launches + chol.cholesky_solve.launches
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        tracer.span("step", _step, st, tracer)
    t_end = st["steps"][-1]["t_out"]
    k2 = chol.cholesky_upper.launches + chol.cholesky_solve.launches \
        - launches0
    return dict(t0=t0, t_end=t_end, k2_launches=k2)


def collect(st, out):
    steps = st["steps"]
    rec = dict(steps=list(steps), window_s=out["t_end"] - out["t0"],
               latency_s=[s["t_out"] - s["t_in"] for s in steps],
               iterations=sum(s["iters"] for s in steps),
               k2_launches=out["k2_launches"], requests=len(steps),
               H=st["H"], A=st["A"], q=st["q"], bmin=st["bmin"],
               bmax=st["bmax"], Ad=st["Ad"], Bd=st["Bd"], W=st["W"],
               nx=st["nx"], nu=st["nu"], N=st["N"])
    st["solver"] = None
    return rec


def judge(cfg, rec):
    """Every step of the window: the plant replayed from its first state,
    the disturbances and the program's u(t) has to be the plant the step
    saw, and x, y have to meet the configuration's tolerance on the
    step's problem."""
    nx, nu, N = rec["nx"], rec["nu"], rec["N"]
    Ad, Bd, W = rec["Ad"], rec["Bd"], rec["W"]
    eps = cfg["settings"]["eps_abs"], cfg["settings"]["eps_rel"]
    steps = rec["steps"]
    x = steps[0]["x_plant"]
    plant_gap = 0.0
    bl, bu = rec["bmin"].copy(), rec["bmax"].copy()
    zs, ys, bls, bus = [], [], [], []
    for s in steps:
        plant_gap = max(plant_gap, float(np.max(np.abs(s["x_plant"] - x))))
        bl[:nx] = bu[:nx] = Ad @ x
        zs.append(s["z"])
        ys.append(s["y"])
        bls.append(bl.copy())
        bus.append(bu.copy())
        # the program's u(t) is the slice of its own answer the plant takes
        x = Ad @ x + Bd @ s["z"][N * nx:N * nx + nu] + W[s["k"]]
    B = len(steps)
    ratio = np.empty(B)
    for i in range(0, B, 64):  # blocks of steps, so that it fits
        j = min(B, i + 64)
        same = lambda a: np.broadcast_to(a, (j - i,) + a.shape)  # noqa: E731
        ratio[i:j] = kkt_ratio(same(rec["H"]), same(rec["A"]),
                               same(rec["q"]), np.stack(bls[i:j]),
                               np.stack(bus[i:j]), np.stack(zs[i:j]),
                               np.stack(ys[i:j]), *eps)
    worst = float(ratio.max()) if B else 0.0
    solved = np.array([s["status"] == "solved" for s in steps], bool)
    return dict(attempted=B, failed=int(B - solved.sum()),
                certified=int((solved & (ratio <= cfg["limit"])).sum()),
                checks={"worst_kkt_ratio": {"value": worst,
                                            "limit": cfg["limit"]},
                        "plant_gap": {"value": plant_gap, "limit": 0.0}})
