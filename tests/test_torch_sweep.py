"""The workloads sweep's host side in the PyTorch port: the generators, the
f64 host polish and the finisher against the JAX package's, the sweep on
the CPU at tiny rows, and the memory-plan probes' plain versions against
scripts/probe_mosaic_scratch.py's formula."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import random_convex_qp
from qpalm_tpu_torch import probe, sweep, workloads
from qpalm_tpu_torch.batch import stack_problems
from qpalm_tpu_torch.finish_np import palm_finish_np
from qpalm_tpu_torch.polish import polish_batch_np
from qpalm_tpu_torch.solver.fused import solve_batch_fused
from qpalm_tpu_torch.types import QPData

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("family,args", [
    ("random_qp", (12, None, 0.5, 7)), ("random_qp", (20, 30, 0.3, 201)),
    ("lasso", (5, 1.0, 63)), ("portfolio", (30, 1.0, 211))])
def test_generators_are_the_reference_generators(family, args):
    pytest.importorskip("jax")
    from qpalm_tpu import workloads as ref

    for u, v in zip(getattr(workloads, family)(*args),
                    getattr(ref, family)(*args)):
        assert np.array_equal(u, v)


def _f32_solutions(probs):
    """f64 stack and the f32 pass's x, y from the port's twin."""
    d32 = stack_problems(probs, np.float32)
    x, y = solve_batch_fused(d32, sweep.S32.replace(max_iter=100))[:2]
    d64 = QPData(*(a.numpy() for a in stack_problems(probs, np.float64)))
    return d64, x.numpy(), y.numpy()


@pytest.fixture(scope="module")
def polish_inputs():
    probs = [random_convex_qp(12, 18, seed=500 + i, density=0.5)
             for i in range(24)]
    d64, x, y = _f32_solutions(probs)
    # a few seeds far off, so that some lanes fail the first round
    x[::7] += 0.05
    return d64, x, y


def _reference_data(d64):
    from qpalm_tpu.types import QPData as JQPData

    return JQPData(*d64)


@pytest.mark.parametrize("compress", [False, True])
def test_polish_matches_reference_polish(polish_inputs, compress):
    """compress=False is the reference's full-system path operation for
    operation, and compress=True solves by the same native Bunch-Kaufman
    factor: bit-identical both."""
    pytest.importorskip("jax")
    from qpalm_tpu.polish import polish_batch_np as ref_polish

    d64, x, y = polish_inputs
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, rounds=2, refine_steps=1,
              threads=3, compress=compress)
    got = polish_batch_np(d64, x, y, **kw)
    ref = ref_polish(_reference_data(d64), x, y, **kw)
    assert got.ok.sum() >= 20
    assert np.array_equal(got.ok, np.asarray(ref.ok))
    for f in got._fields:
        assert np.array_equal(getattr(got, f), np.asarray(getattr(ref, f))), f


def test_finisher_matches_reference_finisher(polish_inputs):
    pytest.importorskip("jax")
    from qpalm_tpu.finish_np import palm_finish_np as ref_finish

    d64, x, y = polish_inputs
    x = x.copy()
    x[3, 0] = np.nan  # a non-finite seed restarts its lane cold
    d8 = QPData(*(a[:8] for a in d64))
    got = palm_finish_np(d8, x[:8], y[:8], max_iter=60)
    ref = ref_finish(_reference_data(d8), x[:8], y[:8], max_iter=60)
    for a, b in zip(got, ref):
        assert np.array_equal(a, np.asarray(b))
    assert (got.status == 1).sum() >= 6


def test_sweep_certifies_tiny_rows_on_the_cpu():
    """The sweep's pipeline on the twin: an on-chip row and a lasso row
    forced small; every lane certified, the referee agreeing."""
    for family, size in (("randomQP", 16), ("lasso", 4)):
        row = sweep.run_row(family, size, device="cpu", batch=8)
        assert row["certified"] == row["batch"] == 8, row
        assert row["referee_disagreements"] == 0
        assert row["tier"] == "smem" and row["k1_ms"] is None


def test_sweep_row_runs_the_streaming_twin(monkeypatch):
    """A row whose plan streams takes the streaming twin: the sweep asks
    fused_palm for the tier from the shape."""
    from qpalm_tpu_torch.solver import fused as F

    seen = []
    plain = F.fused_palm_plain
    monkeypatch.setattr(F, "pick_tier", lambda n, m: "stream")
    monkeypatch.setattr(F, "fused_palm_plain", lambda *a: seen.append(a[-1])
                        or plain(*a))
    row = sweep.run_row("randomQP", 12, device="cpu", batch=4)
    assert row["tier"] == "stream" and seen == [True]
    assert row["certified"] == 4 and row["referee_disagreements"] == 0


@pytest.mark.cuda
def test_cuda_sweep_row_runs_the_streaming_kernel():
    """A streaming row of the sweep through batch.solve_batch on the card:
    one launch of the CUDA streaming kernel, timed by its events, every
    certified lane agreed by the referee."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from qpalm_tpu_torch.solver import fused as F

    before = F.fused_palm.stream_launches
    row = sweep.run_row("lasso", 50, device="cuda", batch=16)
    assert row["tier"] == "stream" and row["n_pad"] == 200
    assert F.fused_palm.stream_launches == before + 1
    assert row["k1_ms"] > 0 and F.fused_palm.events is None
    assert row["certified"] >= 15 and row["referee_disagreements"] == 0


def _reference_probe_script():
    spec = importlib.util.spec_from_file_location(
        "probe_mosaic_scratch", ROOT / "scripts" / "probe_mosaic_scratch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [16, 40])
def test_probe_plain_versions_match_the_script(n):
    pytest.importorskip("jax")
    script = _reference_probe_script()
    seed, A, w = probe.probe_inputs(n, n * 3 // 2, B=script.LANES, seed=n,
                                    device="cpu")
    want = script.expected(seed.numpy(), n).T  # (LANES, n) -> batch first
    got = probe.scratch_probe(seed, n)
    assert torch.allclose(got, torch.from_numpy(want), rtol=1e-5, atol=1e-3)
    A64, w64 = A.double().numpy(), w.double().numpy()
    M = np.einsum("bmi,bm,bmj->bij", A64, w64, A64)
    for fn in (probe.assembly_probe, probe.assembly_probe_library):
        got = fn(A, w).double().numpy()
        assert np.abs(got - M.sum(-1)).max() <= 1e-5 * np.abs(M.sum(-1)).max()
    assert probe.scratch_probe.launches == probe.assembly_probe.launches == 0


def _scratch_probe_blocks(seed, n, rows):
    """The on-chip scratch probe (csrc/probe_stream.cu,
    scratch_probe_kernel) in float32 numpy: each problem's rows dealt to
    blocks of `rows`, each block's rows filled with seed + j, 8 passes of
    M[j, k] -= (j / n) (k / n), then each row summed as a warp sums it
    (lane t adds entries t, t + 32, ... in turn, then an xor butterfly).
    Returns the sums and every row index each block held."""
    f = np.float32
    B = seed.shape[0]
    out = np.full((B, n), np.nan, f)
    held = []
    fn = f(n)
    kk = np.arange(n, dtype=f) / fn
    for blk in range(-(-n // rows)):
        j0 = blk * rows
        js = np.arange(j0, min(n, j0 + rows))
        held.append(js)
        M = (seed[:, None, None] + js.astype(f)[None, :, None]) \
            * np.ones((1, 1, n), f)
        vj = js.astype(f) / fn
        for _ in range(probe.RANK1_UPDATES):
            M = M - vj[None, :, None] * kk[None, None, :]
        lanes = np.zeros((B, len(js), 32), f)
        for k in range(n):
            lanes[:, :, k % 32] += M[:, :, k]
        o = 16
        while o:
            lanes = lanes + lanes[:, :, np.arange(32) ^ o]
            o >>= 1
        out[:, js] = lanes[:, :, 0]
    return out, held


@pytest.mark.parametrize("n,rows", [(16, 32), (40, 32), (40, 7), (352, 32),
                                    (33, 1)])
def test_on_chip_scratch_probe_order_matches_plain(n, rows):
    """The on-chip plan's blocks cover every row once, and its order (the
    plain subtractions, a warp's sums) is within the probe's 1e-5 relative
    error of the plain version."""
    seed, _, _ = probe.probe_inputs(n, 4, B=3, seed=n, device="cpu")
    got, held = _scratch_probe_blocks(seed.numpy(), n, rows)
    assert sorted(np.concatenate(held).tolist()) == list(range(n))
    want = probe.scratch_probe_plain(seed, n).double().numpy()
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel < 1e-5


def test_scratch_probe_rows_mirror_the_kernel():
    """scratch_rows is csrc/probe_stream.cu's: SCRATCH_ROWS rows a block
    and the row of k / n while they fit SMEM_LIMIT, fewer past it, none
    past one row (refused); the probe's sizes keep the full 32."""
    src = (ROOT / "qpalm_tpu_torch" / "csrc" / "probe_stream.cu").read_text()
    assert f"SCRATCH_ROWS = {probe.SCRATCH_ROWS};" in src
    assert f"SMEM_LIMIT = {probe.SMEM_LIMIT};" in src
    for n in probe.SIZES:
        assert probe.scratch_rows(n) == probe.SCRATCH_ROWS
    assert "const int smem = (rows + 1) * n * (int)sizeof(float);" in src
    for n in (1, 100, 1761, 1762, 5000, 29056, 29057):
        r = probe.scratch_rows(n)
        assert 4 * n * (r + 1) <= probe.SMEM_LIMIT or r < 1
        assert r == probe.SCRATCH_ROWS or 4 * n * (r + 2) > probe.SMEM_LIMIT
    assert probe.scratch_rows(29056) == 1 and probe.scratch_rows(29057) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 40, 352])
def test_cuda_scratch_probe_keeps_its_scratch_on_chip(n):
    """The kernel against its plain version on the card, within the
    probe's 1e-5 relative error, allocating nothing but its (B, n) sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    seed, _, _ = probe.probe_inputs(n, 4, B=probe.BATCH, seed=n)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches = probe.scratch_probe.launches
    got = probe.scratch_probe(seed, n)
    torch.cuda.synchronize()
    assert probe.scratch_probe.launches == launches + 1
    assert torch.cuda.max_memory_allocated() - before <= 4 * probe.BATCH * n \
        + 512
    want = probe.scratch_probe_plain(seed, n)
    rel = ((got.double() - want.double()).abs().max()
           / want.double().abs().max().clamp(min=1.0)).item()
    assert rel < 1e-5
