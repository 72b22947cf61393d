"""The port's tracer in a traced run (gpubench/program_trace.py) and the
per-layer metrics that read it (gpubench/metrics/replay_ms.py,
replay_p95_ms.py, torch_span_ms.py, coarse_span_ms.py, outer_idle_ms.py):
each reads a synthetic record and returns None where record["program"] is
absent; a ProgramTrace over a throwaway 4^4 cell on the CPU gives every one
of them a number."""

import time

import numpy as np
import pytest

from conftest import REPO
from gpubench import field, harness, program_trace
from gpubench.traffic import Traffic

METRICS = REPO / "gpubench" / "metrics"
PROGRAM = {
    "window": {"rhs": [1, 1, 2], "replay_s": [0.010, 0.012, 0.030], "request_s": [0.1] * 3,
               "launches": {}, "counters": {}},
    "ranges": {"rhs": 2, "span_s": 0.1, "busy_s": 0.09, "idle_s": {"outer iteration": 0.004},
               "outer_idle_s": 0.004},
    "marks": {"rhs": 2, "cost_ns": 1500.0, "coarse_s": 0.05, "torch_s": 0.02,
              "families_s": {}, "sections": {}, "launches": {}, "replay_s": 0.1,
              "request_s": 0.2},
}
WANT = {"replay_ms": 13.0, "replay_p95_ms": float(np.percentile([10.0, 12.0, 15.0], 95)),
        "torch_span_ms": 10.0, "coarse_span_ms": 25.0, "outer_idle_ms": 2.0}


def _read(name, rec):
    return harness._reader(METRICS, f"{name}.solve", "test").read(rec)


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_program_metric_reads_a_record_or_none(name):
    assert _read(name, {"program": PROGRAM}) == pytest.approx(WANT[name])
    assert _read(name, {"trace": None, "requests": []}) is None
    assert _read(name, {"program": None}) is None


def test_a_program_trace_of_a_cpu_run_feeds_every_metric(tiny_root):
    cell = harness.load_cell("tiny.solve", tiny_root)
    params = harness.solver_params(cell.config)
    lattice = tuple(params.depth[0].global_lattice)
    fld = cell.config["field"]
    pt = program_trace.ProgramTrace("cpu")           # before the solver, as in a run
    from ddalphaamg_tpu_torch import api, profiling

    assert profiling.PROF.level == profiling.SPANS
    U = field.rough_su3(lattice, int(fld["seed"]), float(fld["target_plaquette"]),
                        float(fld["tolerance"]), "cpu")
    solver = api.Solver(params, device="cpu")
    solver.set_conf(U.numpy())
    solver.setup()
    traffic = Traffic(cell.traffic, lattice)
    seed = 2**31 + 11
    solver.solve_multi(traffic.request(seed, 0))
    pt.warmed_up()
    for i in range(3):
        solver.solve_multi(traffic.request(seed, i))
    pt.window_done()
    assert profiling.PROF.level == profiling.OFF
    t = time.perf_counter()
    prog = pt.reruns(lambda: solver.solve_multi(traffic.request(seed, 0)), 1)
    assert time.perf_counter() - t > 0 and profiling.PROF.level == profiling.OFF
    assert prog["window"]["rhs"] == [1, 1, 1]
    assert set(prog["ranges"]["idle_s"]) >= {"outer iteration", "gather", "scatter"}
    assert prog["marks"]["cost_ns"] > 0 and prog["marks"]["launches"]
    assert "fine GCR d0" in prog["marks"]["sections"]
    idle = prog["ranges"]["idle_s"]
    assert prog["ranges"]["outer_idle_s"] == pytest.approx(
        sum(v for k, v in idle.items() if k in program_trace.OUTER_OWN))
    for name in WANT:
        assert _read(name, {"program": prog}) is not None, name


def test_idle_under_the_outer_loops_reads_scatter_and_gather_is_its_own():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, a, b, device=DeviceType.CPU):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=a, end=b))

    events = [ev("ddaamg:solve_multi", 0, 110), ev("ddaamg:scatter", 2, 10),
              ev("ddaamg:outer iteration", 10, 90), ev("ddaamg:read norms", 20, 30),
              ev("ddaamg:replay InnerRestartGraph", 40, 42),
              ev("ddaamg:replay InnerRestartGraph", 40, 80, DeviceType.CUDA),
              ev("ddaamg:gather", 90, 100), ev("ddaamg:residual", 85, 88, DeviceType.CUDA)]
    r = program_trace.idle_by_span(events, 2)
    us = 1e-6
    assert r["span_s"] == pytest.approx(110 * us) and r["busy_s"] == pytest.approx(40 * us)
    assert r["idle_s"] == pytest.approx({"scatter": 8 * us, "outer iteration": 30 * us,
                                         "read norms": 10 * us, "gather": 10 * us,
                                         "solve_multi": 12 * us})
    assert r["outer_idle_s"] == pytest.approx(58 * us)
