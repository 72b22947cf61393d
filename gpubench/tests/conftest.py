"""Fixtures of the benchmark's CPU tests: a throwaway checkout root that
holds BENCHMARK.json and gpubench/'s data files and metric modules, plus a
tiny configuration (4^4, two levels) and its cells, added from files alone
(no file of the benchmark edited)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_INI = {
    "antiperiodic_boundary_conditions": 1, "number_of_levels": 2,
    "d0_global_lattice": [4, 4, 4, 4], "d0_local_lattice": [4, 4, 4, 4],
    "d0_block_lattice": [2, 2, 2, 2], "d0_post_smooth_iter": 2, "d0_block_iter": 4,
    "d0_test_vectors": 8, "d0_setup_iter": 2, "d1_global_lattice": [2, 2, 2, 2],
    "m0": -0.5, "csw": 1.0, "tolerance_for_relative_residual": 1e-10,
    "iterations_between_restarts": 50, "maximum_of_restarts": 20,
    "coarse_grid_tolerance": 0.05, "coarse_grid_iterations": 100, "coarse_grid_restarts": 5,
    "method": 2, "mixed_precision": 1, "randomize_test_vectors": 0,
}
TINY_CELLS = {"tiny.solve": "tiny_solve", "tiny.props": "tiny_props", "tiny.wall": "tiny_wall"}


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout root with the benchmark's files and the throwaway cells
    tiny.solve (one Z4 source a request), tiny.props (12 point sources) and
    tiny.wall (3 wall sources on a time slice), that report the metrics of
    rough16.solve / rough16.props, a throwaway per-layer metric tiny_rhs with
    a module of its own, and outer_iters.tiny, read by outer_iters.py."""
    dst = tmp_path / "gpubench"
    for sub in ("configs", "traffic", "metrics", "end_to_end"):
        shutil.copytree(REPO / "gpubench" / sub, dst / sub)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (dst / "configs" / "tiny.json").write_text(json.dumps({
        "name": "tiny", "ini": TINY_INI, "slim_for_solve": False,
        "field": {"kind": "rough_su3", "seed": 0, "target_plaquette": 1.7867,
                  "tolerance": 0.005},
        "options": {"coarse_block_bf16": False, "coarsest_direct": False,
                    "smoother_direct": False}}))
    (dst / "traffic" / "tiny_solve.json").write_text(json.dumps(
        {"support": "lattice", "entries": "z4", "batch": 1, "trace_requests": 1,
         "check_share": 1.0}))
    (dst / "traffic" / "tiny_props.json").write_text(json.dumps(
        {"support": "site", "entries": "unit", "batch": 12, "trace_requests": 1,
         "check_share": 0.5}))
    (dst / "traffic" / "tiny_wall.json").write_text(json.dumps(
        {"support": "timeslice", "entries": "unit", "batch": 3, "trace_requests": 1,
         "check_share": 1.0}))
    (dst / "metrics" / "tiny_rhs.py").write_text(
        'def read(rec):\n'
        '    return sum(r["batch"] for r in rec["requests"])\n')
    bench["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/1303.1377",
                             "file": "gpubench/configs/tiny.json", "reduced": [],
                             "why": "a CPU test's size"})
    like = {"tiny.solve": "rough16.solve", "tiny.props": "rough16.props",
            "tiny.wall": "rough16.props"}
    for cell, traffic in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": traffic,
                                   "chips": 1, "why": "a CPU test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        for cell, twin in like.items():
            if "workloads" in m and twin in m["workloads"]:
                m["workloads"].append(cell)
    bench["per_layer"].append({"name": "tiny_rhs", "unit": "rhs", "better": "higher",
                               "source": "program_counter", "layer": "API / outer loop",
                               "moves": "solve_s", "workloads": ["tiny.solve"]})
    bench["per_layer"].append({"name": "outer_iters.tiny", "unit": "iters", "better": "lower",
                               "source": "program_counter", "layer": "API / outer loop",
                               "moves": "solve_s", "workloads": ["tiny.solve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path
