"""qpalm_tpu_torch: the PyTorch and CUDA port of qpalm_tpu, for one NVIDIA
H100.

The port mirrors qpalm_tpu's module paths and names, so each module has a
counterpart in the JAX package that it is held against in the tests.  It
imports torch and numpy, never jax and never qpalm_tpu.  Two paths are
ported so far.  The certified batched pipeline of bench.py:

    batch.stack_problems -> scaling.scale_data -> solver.fused (kernel K1)
    -> polish_device.polish_batch (kernel K2) -> referee.referee

and the batch front end, for convex and nonconvex batches, with
dual-objective termination, warm starts and host chunking:

    batch.solve_batch / solve_many -> stack_problems
    -> [nonconvex] solver.nonconvex.batch_gamma_pins (LOBPCG on scaled Q)
    -> batch._fused_eligible -> solver.fused.solve_batch_fused (kernel K1)
    -> batch.BatchResult

Every Pallas kernel on these paths is a CUDA C++ kernel here (csrc/),
built by nvcc at first use (_build.py).  A CPU tensor runs each kernel's
plain PyTorch twin instead; a CUDA tensor runs the kernel or raises.  What
is not ported raises NotImplementedError naming its ROADMAP.md item.

    minimize   0.5 x' Q x + q' x + c
    subject to bmin <= A x <= bmax
"""

from . import constants
from .types import QPData, ScalingInfo, Settings, qpdata_from_numpy, \
    settings_from

__version__ = "0.1.0"

__all__ = ["constants", "QPData", "ScalingInfo", "Settings",
           "qpdata_from_numpy", "settings_from"]
