"""Runs of the throwaway 4^4 cells on the CPU (the harness's look for a
card skipped): the result line against the contract, and the faults a cell
can have coming out not correct."""

import json
import math
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import REPO
from gpubench import harness

NUM = (int, float)


def run(root, cell, trace=False, seconds=0.5, seed=2**31 + 7):
    c = harness.load_cell(cell, root)
    return harness.run_cell(c, seed, seconds, trace, "cpu", time.perf_counter())


def check_line(result, cell, trace):
    """The last line's keys and types as the contract has them."""
    out = json.loads(json.dumps(result))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "checks"
    assert isinstance(out["correct"], bool)
    assert isinstance(out["attempted"], int) and isinstance(out["failed"], int)
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], NUM)
        assert math.isfinite(m["value"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] >= dev["busy_s"] or dev["platform"] == "cpu"
        bd = out["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in bd.values())
    else:
        assert "breakdown" not in out
    return out


def test_a_solve_run_is_correct_and_reports_its_metrics(tiny_root):
    res = run(tiny_root, "tiny.solve")
    out = check_line(res["result"], "tiny.solve", False)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"solve_s", "setup_s"}
    assert out["metrics"]["solve_s"]["value"] > 0
    assert res["record"]["checked"] == out["attempted"]
    assert out["checks"]["worst_relres"]["value"] < 1e-10


def test_a_traced_run_reports_the_per_layer_metrics(tiny_root):
    res = run(tiny_root, "tiny.solve", trace=True)
    out = check_line(res["result"], "tiny.solve", True)
    assert out["correct"]
    assert {"outer_iters.solve", "solve_p95_s", "mg_setup_s", "coarse_avg.solve",
            "tiny_rhs"} <= set(out["metrics"])
    tr = res["record"]["trace"]
    assert tr["requests"] == 1 and tr["window_s"] > 0


def test_a_props_run_checks_the_drawn_requests(tiny_root):
    res = run(tiny_root, "tiny.props", seconds=0.1)
    out = check_line(res["result"], "tiny.props", False)
    assert out["correct"] and set(out["metrics"]) == {"rhs_per_s", "setup_s"}
    assert out["attempted"] % 12 == 0 and res["record"]["checked"] >= 12


def test_a_wall_source_run_from_data_files_alone_is_correct(tiny_root):
    res = run(tiny_root, "tiny.wall", seconds=0.1)
    out = check_line(res["result"], "tiny.wall", False)
    assert out["correct"] and set(out["metrics"]) == {"rhs_per_s", "setup_s"}
    assert out["attempted"] % 3 == 0 and res["record"]["checked"] == out["attempted"]


def _unchanged(x):
    return np.zeros_like(x)


def _half_batch(x):
    x = x.copy()
    x[x.shape[0] // 2:] = 0
    return x


def _altered(x):
    x = x.copy()
    x.reshape(-1)[17] += 1e-6 * np.abs(x).max()
    return x


@pytest.mark.parametrize("cell,fault", [("tiny.solve", _unchanged), ("tiny.solve", _altered),
                                        ("tiny.props", _unchanged), ("tiny.props", _half_batch),
                                        ("tiny.props", _altered)],
                         ids=["solve-unchanged", "solve-altered", "props-unchanged",
                              "props-half-batch", "props-altered"])
def test_a_fault_in_the_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    """solve_multi broken underneath: the state returned unchanged (x0 = 0),
    half of the batch left out, or one entry of an answer altered; the
    solver still says converged."""
    from ddalphaamg_tpu_torch import api

    real = api.Solver.solve_multi

    def broken(self, rhs, *a, **k):
        x, infos = real(self, rhs, *a, **k)
        return fault(x), infos

    monkeypatch.setattr(api.Solver, "solve_multi", broken)
    out = run(tiny_root, cell, seconds=0.1)["result"]
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"]["worst_relres"]["value"] >= out["checks"]["worst_relres"]["limit"]


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, str(REPO / "gpubench" / "run.py"), "--workload",
                          "rough16.solve", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    code = ("import sys, time; sys.path.insert(0, {repo!r}); from gpubench import harness; "
            "c = harness.load_cell('tiny.solve', {root!r}); "
            "harness.run_cell(c, 3, 0.1, False, 'cpu', time.perf_counter()); "
            "print(harness.banned_modules())").format(repo=str(REPO), root=str(tiny_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd="/")
    assert out.stdout.strip().splitlines()[-1] == "[]"
