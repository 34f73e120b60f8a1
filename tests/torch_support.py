"""What the port's test files share: one thread rule for every process that
runs them, and the helpers they would otherwise each copy.

The thread rule runs once, when the module is first imported.  Each process
gets its share of the host's cores, ``max(1, cpu_count // workers)``, where
``workers`` is the number of pytest-xdist workers (1 without xdist).  Left
alone, every worker brings up torch's intra-op pool and the BLAS pools at
the host's full width, and six workers on eight cores then run some 48
compute threads that mostly wait for one another.  The share goes to
torch, to the BLAS pools already loaded, and, through ``OMP_NUM_THREADS``,
``OPENBLAS_NUM_THREADS`` and ``MKL_NUM_THREADS`` where the caller has not
set them, to the BLAS pools loaded later and to every interpreter a test
starts.  Every ``tests/test_torch_*.py`` file and ``test_portbench_osqp.py``
import this module, so the rule holds whichever file a worker collects
first; it sets no thread count anywhere else.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from qpalm_tpu_torch.types import Settings

THREADS = max(1, (os.cpu_count() or 1)
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

for _name in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_name, str(THREADS))
torch.set_num_threads(THREADS)
try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the pools loaded before this import keep their width
    pass
else:
    threadpool_limits(THREADS, user_api="blas")


def _settings(scaling=2, **kw):
    """K1's f32 settings in the tests of tests/test_fused.py."""
    base = dict(dtype="float32", eps_abs=1e-4, eps_rel=1e-4, max_iter=100,
                scaling=scaling, max_refine=0, delta=10.0)
    return Settings(**{**base, **kw})


def _js(s):
    """The port's Settings as the JAX package's."""
    import qpalm_tpu

    return qpalm_tpu.Settings(**dataclasses.asdict(s))


def _scaled(a, b):
    return np.abs(a - b) / np.maximum(1.0, np.abs(a))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def clean_recorder():
    """The trace recorder off and empty around each test."""
    from qpalm_tpu_torch import trace

    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()
