"""BENCHMARK.json against the benchmark's contract, and every cell's
configuration, traffic and metric files found by name."""

import json
import re

import pytest

from conftest import REPO
from gpubench import harness, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_the_contracts_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"] and BENCH["command"][1] == "gpubench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("gpubench/") and (REPO / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_its_files_by_name(cell):
    c = harness.load_cell(cell, REPO)
    e2e = [m["name"] for m, _ in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m, _ in c.per_layer:        # each per-layer metric's moves is reported here
        assert m["moves"] in e2e
    params = harness.solver_params(c.config)
    traffic.Traffic(c.traffic, params.depth[0].global_lattice)


def test_a_throwaway_cell_and_metric_come_from_files_alone(tiny_root):
    c = harness.load_cell("tiny.solve", tiny_root)
    read = {m["name"]: mod for m, mod in c.per_layer}
    assert "tiny_rhs" in read and "outer_iters.tiny" in read
    assert read["outer_iters.tiny"].__file__.endswith("outer_iters.py")
    assert c.config["name"] == "tiny" and c.traffic["batch"] == 1
    wall = harness.load_cell("tiny.wall", tiny_root)
    assert wall.traffic["support"] == "timeslice" and "rhs_per_s" in [
        m["name"] for m, _ in wall.end_to_end]
    for sub in ("configs", "traffic", "metrics", "end_to_end"):
        for f in (REPO / "gpubench" / sub).iterdir():
            if f.suffix in (".json", ".py"):
                assert (tiny_root / "gpubench" / sub / f.name).read_bytes() == f.read_bytes()


def test_a_split_metric_is_read_by_its_own_module_first(tmp_path):
    """torch_ms.props reads gpubench/metrics/torch_ms.props.py where there
    is one, torch_ms.py where there is none."""
    (tmp_path / "torch_ms.py").write_text("def read(rec):\n    return 1\n")
    assert harness._reader(tmp_path, "torch_ms.props", "t").read(None) == 1
    (tmp_path / "torch_ms.props.py").write_text("def read(rec):\n    return 2\n")
    assert harness._reader(tmp_path, "torch_ms.props", "t").read(None) == 2
    assert harness._reader(tmp_path, "torch_ms", "t").read(None) == 1
