"""The reference's benchmark scripts and examples on the port
(qpalm_tpu_torch/scripts/, qpalm_tpu_torch/examples/): each `main` on the
CPU at the smallest size its flags allow, the reference script's record
keys in what it prints, and nothing written outside its output
directory (benchmarks/ above all)."""

import importlib
import json
import os
from pathlib import Path

import pytest
import torch_support  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

# the record keys of the reference scripts' JSON lines (scripts/*.py)
LARGE_SINGLE = {"n", "m", "density", "device_s", "device_reps",
                "device_certified", "device_iters", "host_s",
                "host_certified", "host_iters", "speedup"}
BOXQP = {"family", "n", "B", "path", "solved", "stationary_certified",
         "certify_eps", "escalated_lanes", "time_s", "t_pass_s",
         "t_polish_s", "t_rescue_s", "solves_per_s"}
SCRIPTS = {
    "run_qps_suite": ([str(ROOT / "benchmarks" / "maros"), "--max-n", "6",
                       "--json", "suite.json"], None),
    "bench_mpc": (["--masses", "2", "--horizon", "4", "--steps", "2"], None),
    "bench_scenarios": (["--batch", "16"], [
        {"metric", "value", "unit", "detail"}]),
    "bench_sparse": (["--scale", "0.05"], [{"cases", "fills", "report"}]),
    # the banded counter-case runs the f32 pass to max_iter (2000) at
    # every n, the reference's too (status -2 at n=24): skipped here
    "bench_large_single": (["--sizes", "16", "--banded-n", "0"],
                           [LARGE_SINGLE, {"rows", "banded"}]),
    "bench_large_batch": (["--configs", "16:2", "--reps", "1"], [
        {"n", "m", "B", "solves_per_s", "certified", "t_total_reps",
         "t_device_reps", "t_polish_reps"}]),
    # the f32 pass cut to 20 iterations: its stragglers take the polish
    # and the f64 re-solve
    "bench_nonconvex": (["--boxqp", "8:4", "--sparse-sizes", "20",
                         "--reps", "1", "--max-iter", "20"], [BOXQP, {
                             "family", "n", "B", "path", "solved",
                             "stationary_certified", "time_s",
                             "solves_per_s"}]),
    "bench_cross_solver": (["--cases", "HS21,HS35"], [
        {"agree", "total", "report"}]),
    "bench_scaling": (["--sizes", "2", "--per-shard", "2", "--chain",
                       "2:4", "--reps", "1"], [
        {"dp", "stage", "report", "note"}]),
}
EXAMPLES = {
    "demo": [], "batch_demo": ["--batch", "8"],
    "sparse_demo": ["--scale", "0.05"], "nonconvex_demo": [],
    "branch_and_bound_demo": [], "distributed_demo": ["--shards", "2"],
}


def _snapshot(root: Path) -> dict:
    return {str(p): p.stat().st_mtime_ns for p in root.rglob("*")
            if p.is_file()}


@pytest.fixture
def sandbox(tmp_path, monkeypatch):
    """Run in an empty directory; the output directory under it."""
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    bench = _snapshot(ROOT / "benchmarks")
    yield work, work / "out"
    assert _snapshot(ROOT / "benchmarks") == bench
    assert {p.name for p in work.iterdir()} <= {"out"}


def _json_lines(text):
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{"):
            out.append(json.loads(line))
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_on_the_cpu(name, sandbox, capsys):
    work, out = sandbox
    argv, keys = SCRIPTS[name]
    mod = importlib.import_module(f"qpalm_tpu_torch.scripts.{name}")
    rc = mod.main(argv + ["--device", "cpu", "--out-dir", str(out)])
    assert rc in (0, None)
    text = capsys.readouterr().out
    records = _json_lines(text)
    if keys is not None:
        # every expected record shape printed, each with the reference's
        # keys exactly
        for want in keys:
            assert any(set(r) == want for r in records), (want, records)
    if name == "run_qps_suite":
        with open(out / "suite.json") as f:
            res = json.load(f)
        assert res["results"] and all(
            {"name", "n", "m", "status", "iter", "objective", "time_s",
             "kkt", "expected", "correct"} <= set(r)
            for r in res["results"])
        assert all(r["correct"] for r in res["results"])
        assert "correct" in text
    if name == "bench_mpc":
        assert text.count("solves/s") == 3
    if name == "bench_scaling":
        assert "not k devices" in text
    for r in records:  # reports stay in the output directory
        if "report" in r:
            assert Path(r["report"]).resolve().parent == out.resolve()


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_on_the_cpu(name, sandbox, capsys):
    mod = importlib.import_module(f"qpalm_tpu_torch.examples.{name}")
    assert mod.main(EXAMPLES[name] + ["--device", "cpu"]) in (0, None)
    text = capsys.readouterr().out
    assert text.strip()
    if name == "distributed_demo":
        assert "not 2 devices" in text


def test_scripts_default_to_the_card_and_never_import_the_reference():
    """Every script and example parses --device cuda by default and names
    no module of the JAX package."""
    for sub, names in (("scripts", SCRIPTS), ("examples", EXAMPLES)):
        for name in names:
            src = (ROOT / "qpalm_tpu_torch" / sub / f"{name}.py").read_text()
            assert "qpalm_tpu." not in src.replace("qpalm_tpu_torch", "")
            assert "import jax" not in src
    from qpalm_tpu_torch.scripts._common import parser

    assert parser("x").parse_args([]).device == "cuda"
    assert os.path.basename(parser("x").parse_args([]).out_dir) == "results"
