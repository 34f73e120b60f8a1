"""Checkpoint and resume of solver results and warm starts (counterpart of
qpalm_tpu/checkpoint.py).

The reference has no serialization; its functional equivalent is the
warm-start and parametric-update API that keeps a workspace alive across
solves (reference qpalm.c:322-399, 739-871).  Here a checkpoint is the
(x, y) pair and the status of a solve in an .npz file; resume by warm
starting.  A `BatchResult`'s tensors may lie on the card: they are copied
to the host to be saved.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import SolveResult


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_solution(path: str, result: SolveResult) -> None:
    """Persist a solve's warm-start payload (x, y) plus status metadata."""
    np.savez(
        path,
        x=_host(result.solution.x),
        y=_host(result.solution.y),
        status=_host(result.info.status_val),
        iterations=_host(result.info.iter),
        objective=_host(result.info.objective),
    )


def load_solution(path: str):
    """Load a saved solution; returns (x, y, meta dict).  Feed (x, y) to
    `QPALM.warm_start` to resume."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        return (
            z["x"],
            z["y"],
            {
                "status": int(z["status"]),
                "iterations": int(z["iterations"]),
                "objective": float(z["objective"]),
            },
        )


def save_batch(path: str, result) -> None:
    """Persist a BatchResult (stacked warm starts and statuses) for a
    sweep."""
    np.savez(
        path,
        x=_host(result.x),
        y=_host(result.y),
        status=_host(result.status),
        iterations=_host(result.iterations),
        objective=_host(result.objective),
    )


def load_batch(path: str) -> dict:
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        return {k: z[k] for k in z.files}
