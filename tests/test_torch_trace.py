"""The port's spans and counters (qpalm_tpu_torch/trace.py): nothing is
recorded while tracing is off; on, the batch pipeline's round, its
stacking, its polish and the rescue on another thread record spans that
nest and share the round's request id; the bytes stacked page-locked;
self time; the native builds' compile counters against a fake compiler;
drain; many threads at once."""

import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qpalm_tpu_torch import _build, baseline_c, bench, trace
from qpalm_tpu_torch.batch import stack_problems
from qpalm_tpu_torch.types import QPData
from qpalm_tpu_torch.workloads import make_problems
from torch_support import clean_recorder  # noqa: F401

ROUND_PHASES = ["stack", "copy", "enqueue.k1", "enqueue.polish",
                "flag_fetch"]


def _rescue_lib():
    if baseline_c.load_library() is None:
        pytest.skip("the port's baseline library does not load: "
                    + baseline_c.unavailable_reason())


def _round_and_rescue(rid=None):
    """One round of 4 problems on the CPU twins, then the rescue of all
    its lanes on a worker thread, as bench._rep hands them over."""
    probs = make_problems(4, 16, 24, seed=3)
    ok, pol, h64, phases, _ = bench._round(probs, torch.device("cpu"),
                                           False, rid)
    with ThreadPoolExecutor(max_workers=1) as pool:
        res = pool.submit(bench.rescue_round, QPData(*h64), rid).result()
    return ok, phases, res


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id),
                  key=lambda s: s.start)


def test_off_records_nothing():
    _rescue_lib()
    assert trace.span("round") is trace.span("stack")
    assert trace.new_request() is None
    ok, phases, res = _round_and_rescue()
    assert sorted(phases) == ["copy", "enqueue", "flag_fetch", "stack"]
    assert res.ok.all()
    rec = trace.drain()
    assert rec.spans == [] and rec.counters == {}


def test_round_and_rescue_spans_nest_and_share_the_request():
    _rescue_lib()
    trace.enable()
    rid = trace.new_request()
    _round_and_rescue(rid)
    spans = trace.drain().spans
    main = threading.get_ident()
    (root,) = [s for s in spans if s.name == "round"]
    assert root.parent is None and root.request == rid
    kids = _children(spans, root)
    assert [s.name for s in kids] == ROUND_PHASES
    for a, b in zip(kids, kids[1:]):
        assert root.start <= a.start <= a.end <= b.start <= b.end <= root.end
    stack = kids[0]
    assert [s.name for s in _children(spans, stack)] == ["stack.pad"]
    polish = kids[3]
    assert [s.name for s in _children(spans, polish)] == [
        "polish.round1", "polish.second_round"]
    on_main = [s for s in spans if s.thread == main]
    assert {s.request for s in on_main} == {rid}
    for s in on_main:
        if s is not root:
            (up,) = [p for p in on_main if p.id == s.parent]
            assert up.start <= s.start <= s.end <= up.end

    (rescue,) = [s for s in spans if s.name == "rescue"]
    assert rescue.thread != main and rescue.request == rid
    assert rescue.parent is None
    lanes = [s for s in spans if s.name == "rescue.c_solve"]
    assert len(lanes) == 4
    assert all(s.parent == rescue.id and s.request == rid for s in lanes)
    (pol,) = [s for s in spans if s.name == "rescue.polish"]
    assert pol.parent == rescue.id and pol.thread == rescue.thread


def test_a_round_without_an_id_starts_a_request_and_counts_lanes():
    _rescue_lib()
    trace.enable()
    _round_and_rescue()
    _round_and_rescue()
    rec = trace.drain()
    roots = [s for s in rec.spans if s.name == "round"]
    assert len(roots) == 2 and roots[0].request != roots[1].request
    for root in roots:
        assert all(s.request == root.request for s in rec.spans
                   if s.thread == root.thread and root.start <= s.start
                   and s.end <= root.end)
    assert rec.counters["rescue.lanes"] == 8


@pytest.mark.parametrize("on", [True, False])
def test_correction_spans_and_counts_inside_the_polish(monkeypatch, on):
    """With the shape gate forced open, a round's polish ends with the
    span "polish.correct" under "enqueue.polish", and counts the rejected
    lanes it polished again and those it certified (OSQP's random QP
    class at n = 48, m = 480, where the polish rejects lanes); off,
    nothing is recorded."""
    from portbench.reference.generators import osqp_random_qp
    from qpalm_tpu_torch import polish_device

    monkeypatch.setattr(polish_device, "CORRECT_MIN_MN2", 0)
    probs = osqp_random_qp.problems(
        dict(n=48, m=480, density=0.15, alpha=0.01), 16, 1)
    if on:
        trace.enable()
    ok = bench._round(probs, torch.device("cpu"), False)[0]
    rec = trace.drain()
    if not on:
        assert rec.spans == [] and rec.counters == {}
        return
    (polish,) = [s for s in rec.spans if s.name == "enqueue.polish"]
    assert [s.name for s in _children(rec.spans, polish)] == [
        "polish.round1", "polish.second_round", "polish.correct"]
    lanes = rec.counters["polish.correct.lanes"]
    certified = rec.counters["polish.correct.certified"]
    # every lane is among the worst 64, so every rejected lane is retried
    assert 1 <= certified <= lanes
    assert lanes - certified == int((~ok).sum())


def test_stack_counts_the_bytes_it_pins(monkeypatch):
    """"stack.pinned_bytes": the bytes of the stacks allocated
    page-locked, nothing for a stack that is not.  An allocator that
    records the request and allocates plain memory stands in for the
    page-locked one, which needs a card."""
    asked = []
    empty = torch.empty

    def record(*shape, pin_memory=False, **kwargs):
        asked.append(pin_memory)
        return empty(*shape, **kwargs)

    monkeypatch.setattr(torch, "empty", record)
    probs = make_problems(4, 16, 24, seed=3)
    trace.enable()
    stack_problems(probs, np.float32)
    assert asked == [False] * 6 and trace.drain().counters == {}
    host = [stack_problems(probs, dtype, pin_memory=True)
            for dtype in (np.float32, np.float64)]
    assert asked[6:] == [True] * 12
    assert trace.drain().counters == {"stack.pinned_bytes": sum(
        t.nbytes for h in host for t in h)}


def _span(name, start, end, id, parent=None):
    return trace.Span(name, start, end, id, parent, 0, 1)


def test_self_time_subtracts_only_the_childrens_cover():
    top = _span("top", 0, 100, 1)
    spans = [top,
             _span("a", 10, 30, 2, 1),
             _span("b", 20, 40, 3, 1),    # overlaps a: counted once
             _span("a.1", 12, 14, 4, 2),  # a grandchild, inside a
             _span("c", 90, 120, 5, 1),   # clipped to top's end
             _span("other", 0, 100, 6)]   # not a child
    assert trace.self_ns(top, spans) == 100 - 30 - 10
    assert trace.self_ns(spans[1], spans) == 20 - 2
    assert trace.self_ns(spans[5], spans) == 100


def test_self_time_of_recorded_spans():
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            pass
    spans = trace.drain().spans
    inner, outer = spans
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent == outer.id and outer.parent is None
    assert trace.self_ns(outer, spans) == \
        (outer.end - outer.start) - (inner.end - inner.start)


@pytest.fixture
def fake_gxx(monkeypatch, tmp_path):
    """build_native against one source file, with a g++ that fails to
    link "-lmissing" and otherwise writes its output file, and a loader
    that loads anything."""
    native = tmp_path / "native"
    native.mkdir()
    (native / "a.cpp").write_text("int a;\n")
    runs = []

    def run(cmd, **kwargs):
        runs.append(cmd)
        if "-lmissing" in cmd:
            return subprocess.CompletedProcess(
                cmd, 1, "", "ld: cannot find -lmissing")
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("built")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "NATIVE", native)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: "/fake/g++")
    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build, "ctypes",
                        SimpleNamespace(CDLL=lambda path: ("lib", path)))
    return runs


def test_build_native_counts_a_failing_route(fake_gxx):
    trace.enable()
    with pytest.raises(RuntimeError, match="does not build and load"):
        _build.build_native("libx", ["a.cpp"], ["-shared"],
                            [("missing", ["-lmissing"])])
    rec = trace.drain()
    assert rec.counters == {"build.compiles": 1,
                            "build.compile_failures": 1}
    (build,) = [s for s in rec.spans if s.name == "build"]
    (compile_,) = [s for s in rec.spans if s.name == "build.compile"]
    assert compile_.parent == build.id and build.parent is None


def test_build_native_compiles_nothing_once_built(fake_gxx):
    routes = [("missing", ["-lmissing"]), ("plain", [])]
    trace.enable()
    lib, route = _build.build_native("libx", ["a.cpp"], ["-shared"], routes)
    assert route == "plain" and lib[0] == "lib"
    assert trace.drain().counters == {"build.compiles": 2,
                                      "build.compile_failures": 1}
    # built: loaded without a compile
    _build.build_native("libx", ["a.cpp"], ["-shared"], routes[1:])
    rec = trace.drain()
    assert rec.counters == {}
    assert [s.name for s in rec.spans] == ["build"]
    assert len(fake_gxx) == 2


def test_kernel_build_counts_each_nvcc_run(monkeypatch, tmp_path):
    """`build()` of the kernels: the nvcc runs of the sources, which run
    together, are one compile step and their link another; every nvcc
    process counts."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text("// " + name)

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            with open(cmd[cmd.index("-o") + 1], "w") as f:
                f.write("o")

        def communicate(self):
            return "", ""

        def poll(self):
            return 0

    def run(cmd, **kwargs):
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("so")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "/fake/nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(_build.subprocess, "run", run)
    trace.enable()
    path, _ = _build.build()
    assert path.exists()
    rec = trace.drain()
    assert rec.counters == {"build.compiles": 3}
    assert [s.name for s in rec.spans] == ["build.compile"] * 2


def test_drain_empties_the_recorder():
    trace.enable()
    with trace.span("a"):
        trace.count("n", 2)
    trace.count("n")
    rec = trace.drain()
    assert [s.name for s in rec.spans] == ["a"] and rec.counters == {"n": 3}
    assert trace.drain() == trace.Record([], {})
    trace.disable()
    with trace.span("b"):
        trace.count("n")
    assert trace.drain() == trace.Record([], {})


def test_many_threads_lose_no_span_or_count():
    """More threads than cores, switching every microsecond: every span
    and every count arrives, and each span's parent is on its thread."""
    threads, per = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable()
    try:
        def work():
            for _ in range(per):
                with trace.span("outer"):
                    with trace.span("inner"):
                        trace.count("n")

        with ThreadPoolExecutor(max_workers=threads) as pool:
            futures = [pool.submit(work) for _ in range(threads)]
            for f in futures:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    rec = trace.drain()
    assert rec.counters == {"n": threads * per}
    assert len(rec.spans) == 2 * threads * per
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans)
    for s in rec.spans:
        if s.name == "inner":
            up = by_id[s.parent]
            assert up.name == "outer" and up.thread == s.thread
            assert up.request == s.request
        else:
            assert s.parent is None
    assert len({s.request for s in rec.spans}) == threads * per
    assert all(s.start <= s.end for s in rec.spans)


class _FakeKernels:
    """Stands in for the CUDA library: every entry point returns success
    and launches nothing."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors take the wrappers' CUDA path with the kernel library
    faked: the dispatch and its counters run, nothing is launched."""
    import contextlib

    from qpalm_tpu_torch.linalg import chol
    from qpalm_tpu_torch.solver import fused as F

    for mod in (chol, F):
        monkeypatch.setattr(mod, "kernels", _FakeKernels)
    monkeypatch.setattr(chol, "_check_cuda", lambda *args: None)
    monkeypatch.setattr(F, "_check_cuda_f32", lambda tensors: None)
    monkeypatch.setattr(chol, "_stream", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    return chol, F


def _k1_inputs_on_meta(F, n, m):
    """K1's scaled data, scaling and state of 4 problems at (n, m), made
    on the CPU and moved to the meta device."""
    from qpalm_tpu_torch.types import ScalingInfo

    probs = make_problems(4, n, m, seed=5)
    sd, scal, st = F._prepare(stack_problems(probs, np.float32), bench.S32)

    def meta(tup):
        return type(tup)(*(t.to("meta") for t in tup))
    return meta(sd), ScalingInfo(*meta(scal)), meta(st)


@pytest.mark.parametrize("on", [True, False])
def test_k1_counts_its_streaming_launches(fake_card, on):
    """"k1.stream_launches": one a launch of the streaming tier, none on
    chip, nothing while tracing is off."""
    _, F = fake_card
    sd, scal, st = _k1_inputs_on_meta(F, 16, 160)
    if on:
        trace.enable()
    before = F.fused_palm.stream_launches
    F.fused_palm(sd, scal, st, 3, bench.S32, qa_panel=8)
    F.fused_palm(sd, scal, st, 3, bench.S32, qa_panel=8)
    F.fused_palm(sd, scal, st, 3, bench.S32, qa_panel=0)
    assert F.fused_palm.stream_launches == before + 2
    assert trace.drain().counters == ({"k1.stream_launches": 2} if on
                                      else {})


@pytest.mark.parametrize("B,n,factor,solve", [
    (128, 256, "global", "global"),   # the polish at n = 256: past smem
    (512, 104, "smem", "panel"),      # the polish at rqp100's padded n
    (64, 480, "global", "global"),
    (2, 1024, "wide", "global")])     # the grid factor: few matrices
def test_chol_counts_the_plan_each_call_took(fake_card, B, n, factor, solve):
    """"chol.plan.factor_<plan>" and "chol.plan.solve_<plan>": the plans
    linalg.chol picked for the polish's f32 factor and identity solve,
    one a call; nothing while tracing is off."""
    chol, _ = fake_card
    M = torch.empty((B, n, n), dtype=torch.float32, device="meta")
    chol.cholesky_solve(chol.cholesky_upper(M), M)
    assert trace.drain().counters == {}
    trace.enable()
    R = chol.cholesky_upper(M)
    chol.cholesky_solve(R, M)
    chol.cholesky_solve(R, M)
    assert trace.drain().counters == {f"chol.plan.factor_{factor}": 1,
                                      f"chol.plan.solve_{solve}": 2}


@pytest.mark.cuda
def test_counters_on_the_card():
    """The same counters from the kernels' own launches on a card: the
    streaming K1 at n = 256, m = 2560 and the polish's factor and
    identity solve at (128, 256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from qpalm_tpu_torch.linalg import chol
    from qpalm_tpu_torch.solver import fused as F

    probs = make_problems(2, 256, 2560, seed=9)
    data = stack_problems(probs, np.float32, device="cuda")
    trace.enable()
    F.solve_batch_fused(data, bench.S32.replace(max_iter=2))
    M = torch.eye(256, device="cuda").expand(128, 256, 256).contiguous()
    chol.cholesky_solve(chol.cholesky_upper(M), M)
    torch.cuda.synchronize()
    counters = {k: v for k, v in trace.drain().counters.items()
                if not k.startswith("build.")}  # a first call builds
    assert counters == {"k1.stream_launches": 1,
                        "chol.plan.factor_global": 1,
                        "chol.plan.solve_global": 1}
