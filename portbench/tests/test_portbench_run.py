"""The harness runs a cell end to end on the program's plain twins (CPU),
prints the result line the contract asks for, refuses to run without a
card, and loads neither JAX nor the JAX package."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness

from .conftest import BATCH_CELLS, MPC_CELL, ROOT

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


@pytest.mark.parametrize("cell", ["tiny.b4", "tiny.mpc"])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_runs_on_the_twins(tiny_root, cell, trace):
    torch.set_num_threads(2)
    c = harness.Cell(cell, root=tiny_root)
    r = harness.run(c, 2 ** 33 + 7, 1.0, bool(trace), device="cpu")
    assert list(r) == RESULT_KEYS
    assert r["correct"] is True and r["attempted"] > 0
    assert r["device"]["platform"] == "cpu" and r["device"]["count"] == 1
    if trace:
        names = {m["name"] for m in c.per_layer()}
        # the device's readers read nothing off the CPU
        assert set(r["metrics"]) <= names and r["metrics"]
    else:
        # the device's trace reads nothing off the CPU: the host's clock
        # gives every other end-to-end metric
        host = {m["name"] for m in c.end_to_end()
                if m["source"] == "host_clock"}
        assert set(r["metrics"]) == host and "setup_s" in host
        if cell == "tiny.b4":
            assert "certified_solves_per_s" in host
        assert all(m["value"] > 0 for m in r["metrics"].values())
    json.dumps(r)


def _command(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", BATCH_CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return proc.returncode != 0 and not (lines and lines[-1].startswith("{"))


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _command(ROOT)
    assert _no_result(proc), proc.stdout
    assert "no CUDA device" in proc.stderr


def test_command_refuses_without_the_program(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    assert _no_result(_command(tmp_path))


def test_nothing_loads_jax(tmp_path):
    """Everything the harness runs, imported and run in one process on the
    CPU: no module whose top-level name is jax, jaxlib, flax or qpalm_tpu
    (compared whole: qpalm_tpu_torch is the port)."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from pathlib import Path
from portbench import harness, control
from portbench.tests.conftest import make_tiny_root
root = make_tiny_root(Path({str(tmp_path)!r}))
for name in {(*BATCH_CELLS, MPC_CELL)!r}:
    cell = harness.Cell(name, root=root)
    for m in cell.per_layer():
        cell.reader(m["name"])
for name in ("tiny.b4", "tiny.mpc"):
    harness.run(harness.Cell(name, root=root), 3, 0.5, True, device="cpu")
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
