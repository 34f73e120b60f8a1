"""The benchmark's harness: finds a cell's configuration, traffic, driver
and per-layer readers by their names in BENCHMARK.json, runs the cell, and
prints one JSON result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

    configs/<config>.json   the configuration as it is run; its "driver"
                            names the entry driver
    traffic/<traffic>.json  one traffic mix's parameters
    drivers/<driver>.py     one entry driver: setup(), window(),
                            collect(), judge(), use_control()
    reference/generators/<generator>.py
                            one input generator, named by the
                            configuration's "generator"
    metrics/<quantity>.py   one per-layer reader: read(record) -> number
                            or None; a metric named <quantity>.<cells>
                            (k1_ms.b512, k1_ms.b64) shares the reader of
                            its quantity, the part before the first "."

A run: set-up (import, build, inputs from the seed, warm-up: `setup_s`),
the measured window of `--seconds` (under the profiler with `--trace 1`,
and in every run of a cell with an end-to-end metric of `device_trace`),
the device's peak memory, then the plain reference judges every answer of
the window, and the last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import bisect
import importlib.util
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qpalm_tpu")  # whole top-level names
TOP_OPS = 10


def load_module(path: Path):
    """Import one file of the benchmark by its path."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of `workloads` with its configuration and traffic."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        bench = json.loads((root / "BENCHMARK.json").read_text())
        self.bench = bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json "
                             f"has {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads(
            (root / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads((root / "portbench" / "traffic" /
                                   f"{self.entry['traffic']}.json")
                                  .read_text())
        self.driver = load_module(root / "portbench" / "drivers" /
                                  f"{self.config['driver']}.py")
        self.generator = load_module(root / "portbench" / "reference" /
                                     "generators" /
                                     f"{self.config['generator']}.py")

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        """The per-layer metrics this cell reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end()}

        def applies(m):
            if "workloads" in m:
                return self.name in m["workloads"]
            return m["moves"] in e2e
        return [m for m in self.bench["per_layer"] if applies(m)]

    def reader(self, metric: str):
        """The reader of a per-layer metric: metrics/<quantity>.py, where
        the quantity is the metric's name up to its first "."."""
        return load_module(self.root / "portbench" / "metrics" /
                           f"{metric.split('.')[0]}.py")


class Tracer:
    """Host spans (name, start, end in time.time_ns, the profiler's
    clock), recorded only in a traced run."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.spans: list[tuple[str, int, int]] = []

    def span(self, name: str, fn, *args, **kwargs):
        """fn(*args, **kwargs) under a span of `name`."""
        if not self.enabled:
            return fn(*args, **kwargs)
        t0 = time.time_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def wrap(self, name: str, fn):
        """fn wrapped in a span of `name` (fn itself when not enabled)."""
        if not self.enabled:
            return fn
        return lambda *a, **k: self.span(name, fn, *a, **k)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values, p):
    """The p-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return float("nan")
    k = (len(v) - 1) * p / 100.0
    lo = int(k)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


def device_trace(prof, t_start_ns: int, t_end_ns: int, spans,
                 detail: bool = True):
    """Device busy time, and with `detail` kernel time by name and idle
    gaps by host span, from a torch.profiler run over the window.
    Returns a dict with busy_s, by_name {name: seconds}, gaps {label:
    seconds}, n_ops (by_name and gaps empty without `detail`)."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    ivals, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        s, d = e.start_ns(), e.duration_ns()
        if d <= 0:
            continue
        ivals.append((s, s + d))
        if detail:
            name = e.name()
            by_name[name] = by_name.get(name, 0.0) + d * 1e-9
    ivals.sort()
    busy, merged = 0, []
    for s, t in ivals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    if not detail:
        return dict(busy_s=busy * 1e-9, by_name={}, gaps={},
                    n_ops=len(ivals))
    # idle gaps inside the window, each labelled by the innermost host span
    # that covers its middle
    gaps = []
    edge = t_start_ns
    for s, t in merged + [[t_end_ns, t_end_ns]]:
        if s > edge:
            gaps.append((edge, min(s, t_end_ns)))
        edge = max(edge, t)
        if edge >= t_end_ns:
            break
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [sp[1] for sp in spans]
    labelled: dict[str, float] = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        label, width = "no host span", None
        i = bisect.bisect_right(starts, mid)
        # the innermost covering span: the shortest among those that
        # started before the middle and end after it (spans nest shallowly)
        for name, s0, s1 in spans[max(0, i - 64):i]:
            if s0 <= mid <= s1 and (width is None or s1 - s0 < width):
                label, width = name, s1 - s0
        labelled[label] = labelled.get(label, 0.0) + (g1 - g0) * 1e-9
    return dict(busy_s=busy * 1e-9, by_name=by_name, gaps=labelled,
                n_ops=len(ivals))


def check_card(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark measures the port "
                         "on an NVIDIA card and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} found")


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_process: float | None = None) -> dict:
    """Run one cell and return the result line's object.  `device` "cpu"
    runs the program's plain twins (tests only: no device metric is
    taken there)."""
    import torch

    t0 = time.perf_counter() if t_process is None else t_process
    cuda = device == "cuda"
    tracer = Tracer(trace)
    state = cell.driver.setup(cell.config, cell.traffic, seed, device,
                              tracer, cell.generator)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the profiler runs over the window in a traced run, and in every run
    # of a cell with an end-to-end metric taken from the device's trace
    device_e2e = any(m["source"] == "device_trace"
                     for m in cell.end_to_end())
    prof = None
    if (trace or device_e2e) and cuda:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    w0_ns = time.time_ns()
    out = cell.driver.window(state, seconds, tracer)
    if cuda:
        torch.cuda.synchronize()
    w1_ns = time.time_ns()
    dt = None
    if prof is not None:
        t_read = time.perf_counter()
        prof.__exit__(None, None, None)
        t_exit = time.perf_counter()
        dt = device_trace(prof, w0_ns, w1_ns, tracer.spans, detail=trace)
        print(f"trace read: {t_exit - t_read:.1f} s to stop the profiler, "
              f"{time.perf_counter() - t_exit:.1f} s to reduce "
              f"{dt['n_ops']} device operations", file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the window loaded {found}: the benchmark "
                         "measures the PyTorch port alone")
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the program's state is freed before the reference runs
    record = cell.driver.collect(state, out)
    del state
    if cuda:
        torch.cuda.empty_cache()
    verdict = cell.driver.judge(cell.config, record)
    record["certified"] = verdict["certified"]

    result = {"correct": bool(all(c["value"] <= c["limit"]
                                  for c in verdict["checks"].values())),
              "attempted": int(verdict["attempted"]),
              "failed": int(verdict["failed"])}
    metrics = {}
    if not trace:
        e2e = dict(certified_solves_per_s=verdict["certified"]
                   / record["window_s"],
                   request_p95_ms=1e3 * percentile(record["latency_s"], 95),
                   setup_s=setup_s)
        if dt is not None and dt["n_ops"] and record["requests"]:
            # the device's busy time over the window, a request answered
            e2e["device_ms_per_request"] = \
                1e3 * dt["busy_s"] / record["requests"]
        for m in cell.end_to_end():
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        window_s = (w1_ns - w0_ns) * 1e-9
        record["trace"] = dt
        record["window_s_traced"] = window_s
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if dt is not None:
            dev["busy_s"] = dt["busy_s"]
            dev["window_s"] = window_s
            top = sorted(dt["by_name"].items(), key=lambda kv: -kv[1])
            gaps = sorted(dt["gaps"].items(), key=lambda kv: -kv[1])
            breakdown = {"device_ops": [[n[:120], s] for n, s in
                                        top[:TOP_OPS]],
                         "idle_gaps": [[n, s] for n, s in gaps[:TOP_OPS]]}
    result["metrics"] = metrics
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = verdict["checks"]
    summary = {k: v for k, v in record.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    summary.update({k: v for k, v in record.get("phases_s", {}).items()})
    print("record: " + json.dumps(summary), file=sys.stderr)
    return result


def main(argv=None, t_process: float | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    check_card(int(cell.entry["chips"]))
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 t_process=t_process)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the process loaded {found}: the benchmark "
                         "measures the PyTorch port alone")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
