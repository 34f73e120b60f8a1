"""The benchmark's configuration of OSQP's random QP class
(portbench/configs/osqp_randomqp_n256.json, cell orqp256.b128): its
generator follows the class's recipe; a tiny copy of the configuration
runs through the harness and the batch pipeline on the program's plain
twins (CPU) and is judged correct, and a planted wrong answer is not; the
streaming roofline's arithmetic and the polish roofline's count of
matrices."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.metrics import k1_stream_roofline, k2_polish_roofline
from portbench.reference import roofline, roofline_stream
from portbench.reference.generators import osqp_random_qp
from qpalm_tpu_torch import baseline_c, bench
import torch_support  # noqa: F401

ROOT = harness.ROOT
CFG = json.loads((ROOT / "portbench/configs/osqp_randomqp_n256.json")
                 .read_text())
CELL = "orqp256.b128"
TINY = "tiny.o24"


@pytest.mark.parametrize("seed", [7, [3000000011, 0], [2 ** 33 + 5, 3]])
def test_generator_follows_the_recipe(seed):
    """m = 10 n; M and A at density 0.15 over the batch; P - 1e-2 I =
    M M' (symmetric, positive semidefinite); l < 0 < u; the same seed gives
    the same problems, another seed others."""
    cfg = dict(CFG, n=32, m=320)
    probs = osqp_random_qp.problems(cfg, 8, seed)
    again = osqp_random_qp.problems(cfg, 8, seed)
    n, m = cfg["n"], cfg["m"]
    assert m == 10 * n and CFG["m"] == 10 * CFG["n"]
    nnz_a = nnz_p = 0
    for (P, A, q, lo, hi), p2 in zip(probs, again):
        for u, v in zip((P, A, q, lo, hi), p2):
            np.testing.assert_array_equal(u, v)
        assert P.shape == (n, n) and A.shape == (m, n) and q.shape == (n,)
        np.testing.assert_array_equal(P, P.T)
        MMt = P - CFG["alpha"] * np.eye(n)
        assert np.linalg.eigvalsh(MMt).min() > -1e-10 * np.abs(MMt).max()
        assert np.linalg.eigvalsh(P).min() > 0.5 * CFG["alpha"]
        assert np.all(lo < 0) and np.all(hi > 0)
        assert np.all(lo >= -1) and np.all(hi <= 1)
        assert not np.array_equal(-lo, hi)  # l and u drawn apart
        nnz_a += np.count_nonzero(A)
        nnz_p += np.count_nonzero(P - np.diag(np.diag(P)))
    assert abs(nnz_a / (8 * m * n) - CFG["density"]) < 0.01
    # M M' of a 15% M: an off-diagonal entry is nonzero where two rows of M
    # share a column, 1 - (1 - 0.15^2)^n of them
    share = 1 - (1 - CFG["density"] ** 2) ** n
    assert abs(nnz_p / (8 * n * (n - 1)) - share) < 0.05
    other = osqp_random_qp.problems(cfg, 1, 12345)[0][1]
    assert not np.array_equal(other, probs[0][1])


def _tiny_root(root):
    """A checkout at `root` with a throwaway cell of a tiny copy of the
    configuration (n = 24, m = 240, batch 4, pool 2), added as a cell is
    added: new files and new BENCHMARK.json entries alone, the cell
    appended to every metric that lists orqp256.b128."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    traffic = dict(json.loads((pb / "traffic" / "b128.json").read_text()),
                   batch=4, pool=2, rounds_per_join=2, warmup_rounds=1)
    (pb / "traffic" / "tiny_o24.json").write_text(json.dumps(traffic))
    cfg = dict(CFG, name="osqp_tiny", n=24, m=240)
    (pb / "configs" / "osqp_tiny.json").write_text(json.dumps(cfg))
    bench_json["configs"].append({"name": "osqp_tiny", "source": "a test",
                                  "file": "portbench/configs/osqp_tiny.json",
                                  "reduced": ["n", "m"], "why": "a test"})
    bench_json["workloads"].append({"name": TINY, "config": "osqp_tiny",
                                    "traffic": "tiny_o24", "chips": 1,
                                    "why": "a test"})
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))
    return root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    if baseline_c.load_library() is None:
        pytest.skip("the port's baseline library does not load (the "
                    "rescue needs it): " + baseline_c.unavailable_reason())
    return _tiny_root(tmp_path_factory.mktemp("checkout"))


# the planted fault: one certified lane's x moved by 1e-2 where the polish
# returns it
_FAULT = """
from qpalm_tpu_torch import bench
polish = bench.polish_batch
def altered(data, x, y, **kwargs):
    out = polish(data, x, y, **kwargs)
    xs = out.x.clone()
    xs[0, 0] += 1e-2
    return out._replace(x=xs, ok=torch.ones_like(out.ok))
bench.polish_batch = altered
"""


def _run(root, trace, fault=False, seed=2 ** 33 + 17):
    """harness.run of the tiny cell in a fresh interpreter (the tests'
    own process has loaded JAX, which the harness refuses), with the fault
    planted if asked; the result line, and what the process loaded of
    JAX."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
import torch
from portbench import harness
{_FAULT if fault else ""}
r = harness.run(harness.Cell({TINY!r}, root=Path({str(root)!r})), {seed},
                1.0, {bool(trace)}, device="cpu")
print(json.dumps(dict(r, loaded=harness.forbidden_modules())))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_copy_runs_and_is_correct(tiny_root, trace):
    cell = harness.Cell(TINY, root=tiny_root)
    assert cell.config["generator"] == "osqp_random_qp"
    assert cell.config["driver"] == "batch_pipeline"
    r = _run(tiny_root, trace)
    assert r["loaded"] == []
    assert r["correct"] is True and r["attempted"] > 0
    assert 0.0 <= r["checks"]["worst_kkt_ratio"]["value"] <= 1.0
    if trace:
        # off the card the device's readers read nothing; the host's do
        names = {m["name"] for m in cell.per_layer()}
        assert {"stack_ms.o256", "copy_ms.o256", "enqueue_ms.o256",
                "rescue_lane_pct.o256"} <= set(r["metrics"]) <= names
    else:
        assert set(r["metrics"]) == {"certified_solves_per_s", "setup_s"}
        assert r["metrics"]["certified_solves_per_s"]["value"] > 0


def test_a_planted_wrong_answer_is_not_correct(tiny_root):
    r = _run(tiny_root, False, fault=True)
    assert r["correct"] is False
    assert r["checks"]["worst_kkt_ratio"]["value"] > 1.0


@pytest.mark.parametrize("nb,n,m,iters", [(512, 64, 96, 40000),
                                          (128, 256, 2560, 9000),
                                          (128, 352, 352, 3840)])
def test_k1_stream_bound(nb, n, m, iters):
    """The operations are k1_bound's (its time with no bytes); the bytes
    grow linearly in the iterations, by two reads of A and one of Q an
    iteration."""
    b = roofline_stream.k1_stream_bound(nb, n, m, iters)
    ops_ms = roofline.k1_bound(0, n, m, iters)["bound_ms"]
    assert ops_ms == pytest.approx(
        1e3 * (m * n * (n + 1) + n * n + n ** 3 / 3 + 4 * n * n + 4 * m * n
               + 168 * m + 40 * (n + m)) * iters / roofline.F32_PEAK,
        rel=1e-12)
    b0 = roofline_stream.k1_stream_bound(nb, n, m, 0)
    b2 = roofline_stream.k1_stream_bound(nb, n, m, 2 * iters)
    step = b["nbytes"] - b0["nbytes"]
    assert b2["nbytes"] - b["nbytes"] == pytest.approx(step, rel=1e-12)
    assert step == 4 * iters * (2 * m * n + n * n)
    bytes_ms = 1e3 * b["nbytes"] / roofline.HBM_RATE
    assert b["bound_ms"] == max(ops_ms, bytes_ms)
    assert b["bound_by"] == ("operations" if ops_ms >= bytes_ms
                             else "bytes")


def test_k1_stream_roofline_reads_the_record():
    rec = dict(k1_iterations=128 * 90, k1_ms_total=200.0, batch=128,
               requests=1, n=256, m=2560)
    b = roofline_stream.k1_stream_bound(128, 256, 2560, 128 * 90)
    # two reads of A and one of Q an iteration take less than its work
    assert b["bound_by"] == "operations"
    assert k1_stream_roofline.read(rec) == pytest.approx(
        100 * b["bound_ms"] / 200.0)
    assert k1_stream_roofline.read(dict(rec, k1_ms_total=None)) is None


def test_k2_polish_roofline_counts_the_polish():
    """B + 2 min(k, B) matrices a request, k the configuration's second
    round (the program's: 64); the kernels' time by their names in the
    trace, others left out."""
    assert k2_polish_roofline.second_round_k() == \
        CFG["certify"]["polish"]["second_round_k"] == \
        bench.POLISH["second_round_k"] == 64
    b = k2_polish_roofline.k2_polish_bound(128, 256, 3)
    assert b["flops"] == 3 * 256 * (5 / 3) * 256 ** 3
    assert b["nbytes"] == 3 * 256 * 20 * 256 ** 2
    names = {
        "void (anonymous namespace)::chol_cluster_kernel<float, false>"
        "(float const*, float*, int, int, long long*)": 0.002,
        "void (anonymous namespace)::chol_solve_global_kernel<float, 8>"
        "(float const*, float const*, float*, int, int)": 0.003,
        "void (anonymous namespace)::fused_palm_kernel<true, false>": 9.0}
    rec = dict(requests=3, batch=128, n=256,
               trace=dict(by_name=names, n_ops=3, busy_s=9.005))
    assert k2_polish_roofline.read(rec) == pytest.approx(
        100 * b["bound_ms"] / 5.0)
    rec["trace"]["by_name"] = {"other": 1.0}
    assert k2_polish_roofline.read(rec) is None
