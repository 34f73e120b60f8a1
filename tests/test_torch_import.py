"""The PyTorch port imports neither jax nor the JAX package, and keeps the
reference's settings."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "qpalm_tpu_torch", "qpalm_tpu_torch.batch", "qpalm_tpu_torch.scaling",
    "qpalm_tpu_torch.linalg.chol", "qpalm_tpu_torch.solver.fused",
    "qpalm_tpu_torch.polish_device", "qpalm_tpu_torch.referee",
    "qpalm_tpu_torch.workloads", "qpalm_tpu_torch.precision",
    "qpalm_tpu_torch.solver.nonconvex", "qpalm_tpu_torch.linalg.dense",
    "qpalm_tpu_torch.polish", "qpalm_tpu_torch.finish_np",
    "qpalm_tpu_torch.sweep", "qpalm_tpu_torch.probe",
    "qpalm_tpu_torch.baseline_c", "qpalm_tpu_torch.bench",
    "qpalm_tpu_torch.solver.core", "qpalm_tpu_torch.solver.linesearch",
    "qpalm_tpu_torch.api", "qpalm_tpu_torch.validate",
    "qpalm_tpu_torch.checkpoint", "qpalm_tpu_torch.compat",
    "qpalm_tpu_torch.large", "qpalm_tpu_torch.diff",
    "qpalm_tpu_torch.linalg.sparse", "qpalm_tpu_torch.linalg.cg",
    "qpalm_tpu_torch.linalg.sparse_direct", "qpalm_tpu_torch.host_sparse",
    "qpalm_tpu_torch.io", "qpalm_tpu_torch.io.qps",
    "qpalm_tpu_torch.io.mtx", "qpalm_tpu_torch.io.native",
    "qpalm_tpu_torch.io.settings_io", "qpalm_tpu_torch.io.cli",
    "qpalm_tpu_torch.parallel", "qpalm_tpu_torch.parallel.mesh",
    "qpalm_tpu_torch.parallel.block_tridiag",
    "qpalm_tpu_torch.parallel.mpc_loop", "qpalm_tpu_torch.parallel.sharded",
    "qpalm_tpu_torch.parallel.dryrun", "qpalm_tpu_torch.parallel.schur",
    *(f"qpalm_tpu_torch.scripts.{m}" for m in (
        "run_qps_suite", "bench_mpc", "bench_scenarios", "bench_sparse",
        "bench_large_single", "bench_large_batch", "bench_nonconvex",
        "bench_cross_solver", "bench_scaling")),
    *(f"qpalm_tpu_torch.examples.{m}" for m in (
        "demo", "batch_demo", "sparse_demo", "nonconvex_demo",
        "branch_and_bound_demo", "distributed_demo")),
]


def test_import_leaves_jax_out():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "bad = [k for k in sys.modules if k == 'jax' or "
              "k.startswith(('jax.', 'qpalm_tpu.')) or k == 'qpalm_tpu']\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "qpalm_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "qpalm_tpu"), \
                (path, name)


def test_settings_defaults_match_reference():
    pytest.importorskip("jax")
    import qpalm_tpu
    from qpalm_tpu_torch import Settings, settings_from

    ref = dataclasses.asdict(qpalm_tpu.Settings())
    assert dataclasses.asdict(Settings()) == ref
    custom = qpalm_tpu.Settings(eps_abs=5e-5, max_iter=96, scaling=2,
                                delta=10.0, dtype="float32")
    assert dataclasses.asdict(settings_from(custom)) == \
        dataclasses.asdict(custom)


@pytest.mark.parametrize("sub", ["", ".linalg", ".solver", ".parallel"])
def test_public_surface_matches_reference(sub):
    """Every name of the reference package's __all__ is in the port's
    __all__ and is an attribute of the port's package."""
    import importlib

    pytest.importorskip("jax")
    ref = importlib.import_module("qpalm_tpu" + sub)
    port = importlib.import_module("qpalm_tpu_torch" + sub)
    missing = [n for n in ref.__all__
               if n not in port.__all__ or not hasattr(port, n)]
    assert not missing, missing
    assert all(hasattr(port, n) for n in port.__all__)


def test_top_level_constants_match_reference():
    pytest.importorskip("jax")
    import qpalm_tpu
    import qpalm_tpu_torch

    names = [n for n in qpalm_tpu.__all__
             if n.startswith(("QPALM_", "FACTORIZE_"))]
    assert len(names) == 13
    for n in names:
        assert getattr(qpalm_tpu_torch, n) == getattr(qpalm_tpu, n), n
    assert qpalm_tpu_torch.QPALM_SOLVED == qpalm_tpu.QPALM_SOLVED


def test_import_builds_nothing_and_leaves_cuda_alone():
    """import qpalm_tpu_torch and its subpackages start no process (no
    nvcc, no g++), load no kernel library and initialise no CUDA."""
    code = ("import os, subprocess, torch\n"
            "run, popen = subprocess.run, subprocess.Popen\n"
            "def refuse(real):\n"
            "    def f(cmd, *a, **k):\n"
            "        prog = os.path.basename(str(cmd[0]))\n"
            "        assert prog not in ('nvcc', 'g++', 'gcc', 'c++'), cmd\n"
            "        return real(cmd, *a, **k)\n"
            "    return f\n"
            "subprocess.run, subprocess.Popen = refuse(run), refuse(popen)\n"
            "import qpalm_tpu_torch, qpalm_tpu_torch.linalg\n"
            "import qpalm_tpu_torch.solver, qpalm_tpu_torch.parallel\n"
            "from qpalm_tpu_torch import _build\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert _build.kernels.cache_info().currsize == 0\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
