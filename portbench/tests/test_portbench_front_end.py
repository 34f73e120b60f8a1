"""The batch front end's two per-layer metrics, `stack_ms` and `copy_ms`:
`_round`'s `stack` and `copy` phases apart, which `stack_copy_ms` adds
together, so a change to the stacking and one to the copy move different
numbers.  And the harness's gap labels take the program's own spans
(qpalm_tpu_torch/trace.py) as they take its own."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness
from qpalm_tpu_torch import bench, trace
from qpalm_tpu_torch.workloads import make_problems

from .conftest import BATCH_CELLS

SPLIT = ("stack_ms", "copy_ms")


def test_tiny_traced_cell_reports_the_split(tiny_root):
    torch.set_num_threads(2)
    c = harness.Cell("tiny.b4", root=tiny_root)
    names = {f"{q}.b512" for q in SPLIT}
    assert names <= {m["name"] for m in c.per_layer()}
    r = harness.run(c, 2 ** 33 + 11, 1.0, True, device="cpu")
    m = r["metrics"]
    assert r["correct"] is True
    for name in names:
        assert m[name]["unit"] == "ms" and m[name]["value"] > 0
    whole = m["stack_copy_ms.b512"]["value"]
    parts = m["stack_ms.b512"]["value"] + m["copy_ms.b512"]["value"]
    assert parts == pytest.approx(whole, rel=1e-12)


@pytest.mark.parametrize("quantity", SPLIT)
def test_reader_reads_its_phase(quantity):
    cell = harness.Cell(BATCH_CELLS[0])
    read = cell.reader(f"{quantity}.b512").read
    phase = quantity.split("_")[0]
    rec = dict(requests=4, phases_s=dict(stack=0.8, copy=0.2, enqueue=0.1,
                                         flag_fetch=0.05))
    assert read(rec) == pytest.approx(1e3 * rec["phases_s"][phase] / 4)
    assert read(dict(rec, requests=0)) is None
    assert read(dict(requests=4)) is None


def _profile(intervals):
    """A stand-in for a torch.profiler run whose device operations are
    `intervals` ((start, end) in ns)."""
    events = [SimpleNamespace(device_type=lambda: DeviceType.CUDA,
                              start_ns=lambda s=s: s,
                              duration_ns=lambda s=s, t=t: t - s,
                              name=lambda: "kernel")
              for s, t in intervals]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_program_spans_label_the_idle_gaps():
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        bench._round(make_problems(4, 16, 24, seed=3), torch.device("cpu"),
                     False)
    finally:
        trace.disable()
    spans = trace.drain().spans
    (root,) = [s for s in spans if s.name == "round"]
    pad = min((s for s in spans if s.name == "stack.pad"),
              key=lambda s: s.start)
    # the device is busy over the whole round but for the first stack.pad
    t0, t1 = root.start - 1000, root.end + 1000
    prof = _profile([(t0, pad.start), (pad.end, t1)])
    dt = harness.device_trace(prof, t0, t1,
                              [(s.name, s.start, s.end) for s in spans])
    assert dt["gaps"] == {"stack.pad": pytest.approx(
        (pad.end - pad.start) * 1e-9)}
    assert dt["busy_s"] == pytest.approx(
        (t1 - t0 - (pad.end - pad.start)) * 1e-9)
