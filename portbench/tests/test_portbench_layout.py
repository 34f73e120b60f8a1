"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration, traffic mix, driver and per-layer reader it names is a file
of its own that loads."""

import json
import re

import pytest

from portbench import harness

from .conftest import MPC_ENTRIES, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = BENCH[section] + MPC_ENTRIES[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                               "higher")
            assert e["source"] in SOURCES
        for k in ("why", "layer"):
            if k in e:
                assert _line(e[k]), e


def test_configs_and_cells_are_files():
    for c in BENCH["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (ROOT / "portbench" / "drivers" /
                f"{cfg['driver']}.py").is_file()
        assert (ROOT / "portbench" / "reference" / "generators" /
                f"{cfg['generator']}.py").is_file()
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.Cell(w["name"])
        for fn in ("setup", "window", "collect", "judge", "use_control"):
            assert callable(getattr(cell.driver, fn))
        assert isinstance(cell.traffic, dict)
    assert {w["config"] for w in BENCH["workloads"]} == configs
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        reader = harness.load_module(ROOT / "portbench" / "metrics" /
                                     f"{m['name'].split('.')[0]}.py")
        assert callable(reader.read)
        assert reader.read({"requests": 0, "lanes": 0}) is None
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    for name in cells:
        cell = harness.Cell(name)
        reported = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer()
        assert all(m["moves"] in reported for m in cell.per_layer())


def test_a_cell_is_added_by_new_files_alone(tiny_root):
    """The throwaway cells of `tiny_root`, on configurations of other
    sizes, are new files and new entries; every file the benchmark had is
    unchanged."""
    for f in (ROOT / "portbench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            copy = tiny_root / f.relative_to(ROOT)
            assert copy.read_bytes() == f.read_bytes()
    cell = harness.Cell("tiny.mpc", root=tiny_root)
    assert cell.config["n_masses"] == 2 and cell.config["horizon"] == 3
    assert {m["name"] for m in cell.per_layer()} == {
        m["name"] for m in MPC_ENTRIES["per_layer"]}
    cell = harness.Cell("tiny.b4", root=tiny_root)
    assert (cell.config["n"], cell.config["m"]) == (20, 20)
    probs = cell.generator.problems(cell.config, 3, 5)
    assert [p[0].shape + p[1].shape for p in probs] == [(20, 20, 20, 20)] * 3


def test_metrics_of_one_quantity_share_a_reader():
    """k1_ms.b512 and k1_ms.b64 read through metrics/k1_ms.py; every
    reader file serves some metric of the benchmark or of the MPC cell's
    entries."""
    cell = harness.Cell(BENCH["workloads"][0]["name"])
    names = [m["name"] for m in BENCH["per_layer"]
             + MPC_ENTRIES["per_layer"]]
    files = {f.stem for f in (ROOT / "portbench" / "metrics").glob("*.py")}
    assert files == {n.split(".")[0] for n in names}
    assert cell.reader("k1_ms.b64") is not None
