"""A cell on a process grid, from files alone: the throwaway 4^4 cell split
over a (1, 1, 2, 2) grid of four gloo ranks on the CPU (grid.py, the
harness's look for cards skipped).  Every rank runs the same requests, the
result line and record are the one-card run's, and a slab left out of the
answer comes out not correct.  On the cards (marked gpu): the same faults
and the control at the sizes of rough32grid.solve and of
gpubench/configs/rough32t64.json."""

import json
import sys
import time

import numpy as np
import pytest
import torch

from conftest import TINY_INI
from gpubench import grid, harness

GRID = (1, 1, 2, 2)


def add_grid_cell(root, config: str, cell: str):
    """The four-card cell `cell` of gpubench/configs/<config>.json under
    root, with traffic "solve", from files alone: its configuration entry,
    solve_s.<config> and setup_s, and the per-layer metrics outer_iters,
    coarse_avg, torch_ms, coarse_ms, idle_pct and k8_ms split by <config>."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": config, "source": "https://arxiv.org/abs/1303.1377",
                             "file": f"gpubench/configs/{config}.json",
                             "reduced": json.loads((root / "gpubench" / "configs" /
                                                    f"{config}.json").read_text())["reduced"],
                             "why": "a grid cell of a test"})
    bench["workloads"].append({"name": cell, "config": config, "traffic": "solve", "chips": 4,
                               "why": "a grid cell of a test"})
    bench["end_to_end"].append({"name": f"solve_s.{config}", "unit": "s", "better": "lower",
                                "bound": 0.05, "source": "host_clock", "workloads": [cell]})
    for name, unit in (("outer_iters", "iters"), ("coarse_avg", "iters"), ("torch_ms", "ms/rhs"),
                       ("coarse_ms", "ms/rhs"), ("idle_pct", "%"), ("k8_ms", "ms/rhs")):
        bench["per_layer"].append({"name": f"{name}.{config}", "unit": unit, "better": "lower",
                                   "source": "device_trace", "layer": "Ranks",
                                   "moves": f"solve_s.{config}", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def grid_root(tiny_root):
    """tiny_root plus the configuration tinygrid (tiny's keys, each slab
    4 x 4 x 2 x 2) and the four-card cell tinygrid.solve."""
    cfg = json.loads((tiny_root / "gpubench" / "configs" / "tiny.json").read_text())
    cfg["name"], cfg["reduced"] = "tinygrid", []
    cfg["ini"] = dict(TINY_INI, d0_local_lattice=[g // n for g, n in
                                                   zip(TINY_INI["d0_global_lattice"], GRID)])
    (tiny_root / "gpubench" / "configs" / "tinygrid.json").write_text(json.dumps(cfg))
    return add_grid_cell(tiny_root, "tinygrid", "tinygrid.solve")


@pytest.fixture
def t64_root(tiny_root):
    """tiny_root plus the cell rough32t64.solve of gpubench/configs/rough32t64.json
    (32^3 x 64 over (1, 1, 2, 2)), which BENCHMARK.json does not hold: its
    run outlasts a run's 360 s (PERF.md)."""
    return add_grid_cell(tiny_root, "rough32t64", "rough32t64.solve")


def _run(root, traced=False, seconds=0.5, seed=2**31 + 11, name="tinygrid.solve",
         device_type="cpu", rank=grid._rank):
    cell = harness.load_cell(name, root)
    return grid.run(cell, root, seed, seconds, traced, time.perf_counter(), device_type, rank)


def test_a_grid_cell_loads_its_grid_and_refuses_another_card_count(grid_root):
    cell = harness.load_cell("tinygrid.solve", grid_root)
    assert cell.grid == GRID and cell.chips == 4
    assert harness.load_cell("tiny.solve", grid_root).grid is None
    bench = json.loads((grid_root / "BENCHMARK.json").read_text())
    bench["workloads"][-1]["chips"] = 1
    (grid_root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(SystemExit, match="process grid"):
        harness.load_cell("tinygrid.solve", grid_root)


def test_a_grid_run_is_correct_with_the_one_card_records_keys(grid_root):
    ranks = _run(grid_root, seconds=8.0)        # a request takes 3-4 s here
    assert len(ranks) == 4 and all(r["result"] is None for r in ranks[1:])
    counts = [len(r["record"]["requests"]) for r in ranks]
    assert counts[0] >= 2 and len(set(counts)) == 1        # the same requests on every rank
    assert all(r["banned"] == [] for r in ranks)
    out = ranks[0]["result"]
    assert out["correct"] and out["failed"] == 0 and out["device"]["count"] == 4
    assert out["checks"]["worst_relres"]["value"] < 1e-10
    assert set(out["metrics"]) == {"solve_s.tinygrid", "setup_s"}
    assert ranks[0]["record"]["checked"] == counts[0]
    one = harness.run_cell(harness.load_cell("tiny.solve", grid_root), 3, 0.1, False, "cpu",
                           time.perf_counter())
    assert set(ranks[0]["record"]) == set(one["record"])
    assert list(out) == list(one["result"])


def test_a_traced_grid_run_reruns_the_request_on_every_rank(grid_root):
    """Rank 0 traces; every rank reruns the first request with host loops."""
    ranks = _run(grid_root, traced=True, seconds=0.1)
    out = ranks[0]["result"]
    assert out["correct"] and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"outer_iters.tinygrid", "coarse_avg.tinygrid", "mg_setup_s"} <= set(out["metrics"])
    assert "k8_ms.tinygrid" not in out["metrics"]          # no K8 on gloo
    assert ranks[0]["record"]["trace"]["host_loops"]["rhs"] == 1


def _rank_with_a_zeroed_slab(mesh, device, *args):
    """grid._rank with rank 1's slab of every solution zeroed where
    solve_multi gathers it."""
    from ddalphaamg_tpu_torch import api

    real = api.Solver._gather

    def gather(self, x):
        return real(self, torch.zeros_like(x) if mesh.rank == 1 else x)

    api.Solver._gather = gather
    return grid._rank(mesh, device, *args)


def test_a_zeroed_slab_of_one_rank_is_not_correct(grid_root):
    ranks = _run(grid_root, seconds=0.1, seed=5, rank=_rank_with_a_zeroed_slab)
    out = ranks[0]["result"]
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"]["worst_relres"]["value"] > 0.1     # a quarter of the answer gone


def _slab_zeroed(x, mesh):
    """Rank 1's slab of the global solutions x [B, T, Z, Y, X, 4, 3] zeroed."""
    from ddalphaamg_tpu_torch.parallel import mesh as pmesh

    one = pmesh.SolverMesh(mesh.dims, 1)
    loc = pmesh.local_lattice(one, x.shape[1:5])
    x = x.copy()
    x[(slice(None), *(slice(c * n, (c + 1) * n) for c, n in zip(one.coords, loc)))] = 0
    return x


def _off_by_1e6(x, mesh):
    x = x.copy()
    x.reshape(-1)[17] += 1e-6 * np.abs(x).max()
    return x


FAULTS = {"state unchanged": lambda x, mesh: np.zeros_like(x),
          "one rank's slab zeroed": _slab_zeroed, "an answer off by 1e-6": _off_by_1e6}


def _rank_judging_faults(mesh, device, *args):
    """grid._rank whose check on rank 0 also judges the kept solutions with
    each fault of FAULTS planted in them: the worst true relative residual
    of each, beside the run's own."""
    real = harness.check_solutions
    worst = {}

    def check(links, params, traffic, seed, kept, device):
        for name, fault in FAULTS.items():
            rel, _ = real(links, params, traffic, seed,
                          {i: fault(x, mesh) for i, x in kept.items()}, device)
            worst[name] = max(rel.values())
        return real(links, params, traffic, seed, kept, device)

    harness.check_solutions = check
    res = grid._rank(mesh, device, *args)
    res["faults"] = worst
    return res


def _judged(root, name, seed, seconds, device_type):
    ranks = _run(root, seconds=seconds, seed=seed, name=name, device_type=device_type,
                 rank=_rank_judging_faults)
    out, worst = ranks[0]["result"], ranks[0]["faults"]
    limit = out["checks"]["worst_relres"]["limit"]
    print(f"{name} seed {seed}: correct {out['correct']}, worst relres "
          f"{out['checks']['worst_relres']['value']!r}; planted: " + "; ".join(
              f"{k} {v!r} ({'not correct' if not v < limit else 'CORRECT'})"
              for k, v in worst.items()) + f" (limit {limit!r})", file=sys.stderr)
    assert out["correct"]
    assert all(not v < limit for v in worst.values())


def test_each_fault_planted_in_a_grid_run_is_not_correct(grid_root):
    _judged(grid_root, "tinygrid.solve", 7, 0.1, "cpu")


def _cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"the grid cell runs on {n} CUDA card(s)")


@pytest.mark.gpu
@pytest.mark.parametrize("cell,seed", [("rough32grid.solve", 3000002101),
                                       ("rough32t64.solve", 3000000101)])
def test_each_fault_of_a_grid_cell_is_not_correct_at_its_size(t64_root, cell, seed):
    """A grid cell on its four cards, a short window: the state left
    unchanged, rank 1's slab zeroed and an answer off by 1e-6 each fail."""
    _cards(4)
    _judged(t64_root, cell, seed, 10.0, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["rough32grid.solve", "rough32t64.solve"])
def test_the_control_fails_at_a_grid_cells_size(t64_root, cell):
    """The complex64 reference in the solver's place over the whole
    lattice, which one card holds."""
    _cards(1)
    from gpubench import control

    rows, limit = control.control_readings(harness.load_cell(cell, t64_root), [1, 2, 3], "cuda")
    assert all(not worst < limit for _, worst, _, _ in rows)
