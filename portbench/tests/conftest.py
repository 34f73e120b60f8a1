"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
throwaway cells at a tiny size, added by new files and new BENCHMARK.json
entries alone."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_B = {"clients": 1, "loop": "closed", "batch": 4, "pool": 2,
          "rounds_per_join": 2, "warmup_rounds": 1}
TINY_MPC = {"clients": 1, "loop": "closed", "amplitude": 0.5,
            "warmup_steps": 1, "max_steps": 1000}
BATCH_CELLS = ("rqp100.b512", "rqp100.b64")
MPC_CELL = "masses6.closed_loop"
# The MPC cell's BENCHMARK.json entries.  The cell runs and is correct on
# the card but is left out of the benchmark (PERF.md, section 7); its
# driver, generator, configuration, traffic and readers are here, so these
# entries alone put it back.
MPC_ENTRIES = json.loads(
    (Path(__file__).parent / "masses6_closed_loop.json").read_text())


def _add_config(bench, pb, base, name, **changes):
    cfg = json.loads((pb / "configs" / f"{base}.json").read_text())
    cfg.update(name=name, **changes)
    (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": name, "source": "a test",
                             "file": f"portbench/configs/{name}.json",
                             "reduced": [], "why": "a test"})


def make_tiny_root(root: Path) -> Path:
    """A checkout at `root` with the MPC cell put back by its entries
    (MPC_ENTRIES) and two throwaway cells of two new configurations,
    added by new files and new BENCHMARK.json entries alone: `tiny.b4`
    (the batch pipeline on random QPs at n = m = 20, 4 lanes a batch) and
    `tiny.mpc` (the MPC loop on 2 masses, one actuator, horizon 3), each
    reporting the metrics of its driver's cells."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for section, entries in MPC_ENTRIES.items():
        bench[section] += json.loads(json.dumps(entries))
    pb = root / "portbench"
    (pb / "traffic" / "tiny_b4.json").write_text(json.dumps(TINY_B))
    (pb / "traffic" / "tiny_mpc.json").write_text(json.dumps(TINY_MPC))
    _add_config(bench, pb, "randomqp_n100", "randomqp_tiny", n=20, m=20)
    _add_config(bench, pb, "masses6_t30", "masses_tiny", n_masses=2,
                actuator_pairs=[[1, 2]], horizon=3)
    bench["workloads"] += [
        {"name": "tiny.b4", "config": "randomqp_tiny",
         "traffic": "tiny_b4", "chips": 1, "why": "a test"},
        {"name": "tiny.mpc", "config": "masses_tiny", "traffic": "tiny_mpc",
         "chips": 1, "why": "a test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if MPC_CELL in m.get("workloads", []):
            m["workloads"].append("tiny.mpc")
        if BATCH_CELLS[0] in m.get("workloads", []):
            m["workloads"].append("tiny.b4")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def cuda():
    """Skips where there is no card; decided inside the test."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
