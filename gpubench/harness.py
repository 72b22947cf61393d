"""One run of one benchmark cell of ddalphaamg_tpu_torch (gpubench/run.py).

A cell of BENCHMARK.json names a configuration (gpubench/configs/<name>.json:
the solver's ini keys, the gauge field's seed and target plaquette, the
accelerator options the CUDA defaults have to choose, slim_for_solve) and a
traffic mix (gpubench/traffic/<name>.json, traffic.py).  Each metric is
read by a module, gpubench/end_to_end/<name>.py or gpubench/metrics/<name>.py,
whose read(record) returns the number or None; a metric split by the cells
it is reported in (torch_ms.solve, torch_ms.props) without a module of its
own is read by the module of its name up to the first dot (torch_ms.py).

A run: the field on the device (field.py, the configuration's seed), then
api.Solver(params, device), set_conf, setup, slim_for_solve where the
configuration says so, and one warm-up request of the cell's own shape
(the graphs' captures and the kernels' build or load from build/
torch_kernels/ inside the checkout).  That is set-up, counted from the
process's start.  Then a closed loop with one client: request i + 1 is sent
when request i has returned, until --seconds have passed.  --seed draws the
right-hand sides only.  With --trace 1 the first trace_requests requests of
the window run under torch.profiler with the benchmark's spans.

After the window the device's peak memory is read, the solver is freed, and
the reference (reference.py, complex128, from the links the benchmark made)
computes the true relative residual of every checked solution: a run is
correct when every solve returned converged and every checked residual is
below the configuration's tolerance.  The numbers compared are printed with
their limits as the last lines on standard error and last in the result's
line, which is the last line on standard output.

A configuration whose d0_local_lattice is smaller than its
d0_global_lattice runs on a process grid of global // local ranks, one a
card (grid.py): every rank runs run_cell with its mesh.  Rank 0 makes the
field and every rank receives its bits; every rank builds its Solver on the
whole field and draws every request itself; rank 0's clock decides, before
each request, whether the window goes on, and every rank learns it through
one host collective, so all run the same requests.  Rank 0 times the
requests (solve_multi gathers the global solution), keeps the checked
solutions, traces, and checks them on its card once every rank has freed
its solver; the peak memory is the fullest rank's.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import field, reference, trace
from .traffic import WARM_UP, Traffic

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent.name
# top-level module names no run may load (the JAX package and JAX itself)
BANNED = ("jax", "jaxlib", "flax", "ddalphaamg_tpu")
REF_LANES = 12             # right-hand sides a reference apply takes at once


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # [(metric entry, module)]
    per_layer: list
    grid: tuple = None      # the process grid (t, z, y, x), None on one card


def _module(path: Path, kind: str):
    spec = importlib.util.spec_from_file_location(
        f"{BENCH}_{kind}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(folder: Path, name: str, kind: str):
    """The module that reads metric `name`: folder/<name>.py, else
    folder/<name up to its first dot>.py."""
    path = folder / f"{name}.py"
    if not path.is_file():
        path = folder / f"{name.split('.')[0]}.py"
    return _module(path, kind)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration,
    traffic and metric modules, found by name under root/gpubench/."""
    root = Path(root)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / BENCH / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [(m, _reader(root / BENCH / "end_to_end", m["name"], "e2e"))
           for m in bench["end_to_end"] if _applies(m, name)]
    layer = [(m, _reader(root / BENCH / "metrics", m["name"], "layer"))
             for m in bench["per_layer"] if _applies(m, name)]
    grid = process_grid(config)
    if (math.prod(grid) if grid else 1) != int(w["chips"]):
        raise SystemExit(f"{name}: the process grid {grid} of {conf['file']} does not "
                         f"take the cell's {w['chips']} card(s)")
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer, grid)


def process_grid(config: dict):
    """The ranks (t, z, y, x) of a configuration, d0_global_lattice //
    d0_local_lattice per axis (the port's cli._process_grid), or None where
    the local lattice is the global one."""
    ini = config["ini"]
    glob, loc = ini["d0_global_lattice"], ini.get("d0_local_lattice", ini["d0_global_lattice"])
    if any(g % n for g, n in zip(glob, loc)):
        raise SystemExit(f"d0_local_lattice {loc} does not divide d0_global_lattice {glob}")
    dims = tuple(g // n for g, n in zip(glob, loc))
    return dims if math.prod(dims) > 1 else None


def solver_params(config: dict):
    """The port's SolverParams of a configuration's "ini" keys (the ini
    file's keys with '_' for ' '; lattices as lists)."""
    from ddalphaamg_tpu_torch import config as pconfig

    lines = []
    for key, val in config["ini"].items():
        if isinstance(val, list):
            val = " ".join(str(v) for v in val)
        lines.append(f"{key.replace('_', ' ')}: {val}")
    return pconfig.parse_ini("\n".join(lines) + "\n")


def banned_modules() -> list:
    """Loaded modules whose top-level name is a banned one, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Ticks:
    """Set-up phases' seconds: each call closes the phase since the last."""

    def __init__(self, phases: dict, device):
        self.phases, self.device, self.t = phases, device, time.perf_counter()

    def __call__(self, name: str):
        _sync(self.device)
        now = time.perf_counter()
        self.phases[name] = now - self.t
        self.t = now


def _grid_max(mesh, value: float) -> float:
    """The largest of a host number over a grid's ranks (one host
    collective; the number itself on one card)."""
    if mesh is None:
        return value
    from ddalphaamg_tpu_torch.parallel import comm

    return comm.all_reduce_max(mesh, value)


def _go_on(mesh, requests: list, deadline: float) -> bool:
    """Whether the window sends another request: the first always, then
    until the deadline on rank 0's clock, which every rank of a grid learns
    through one host collective."""
    go = not requests or time.perf_counter() < deadline
    return _grid_max(mesh, float(go and (mesh is None or mesh.rank == 0))) > 0


def _links(lattice, fld: dict, device, mesh):
    """The configuration's field on the host (what set_conf takes) and its
    plaquette: made on the card, by rank 0 of a grid and sent to every rank."""
    if mesh is None or mesh.rank == 0:
        U = field.rough_su3(lattice, int(fld["seed"]), float(fld["target_plaquette"]),
                            float(fld["tolerance"]), device)
    else:
        U = torch.empty((4, *lattice, 3, 3), dtype=torch.complex128, device=device)
    if mesh is not None:
        from ddalphaamg_tpu_torch.parallel import comm

        U = comm.broadcast(mesh, U)
    return U.cpu().numpy(), field.plaquette(U)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             started: float, mesh=None) -> dict:
    """One run of `cell` on `device`; `started`: time.perf_counter() at the
    process's start.  Returns the result (the last line is its JSON).  On a
    process grid (`mesh`) every rank calls it (module note); ranks other
    than 0 return only their record's requests."""
    from ddalphaamg_tpu_torch import api, kernels

    lead = mesh is None or mesh.rank == 0
    cfg = cell.config
    params = solver_params(cfg)
    lattice = tuple(params.depth[0].global_lattice)
    phases = {"start": time.perf_counter() - started}   # imports, CUDA initialised
    tick = _Ticks(phases, device)
    links, plaq = _links(lattice, cfg["field"], device, mesh)
    tick("field")
    solver = api.Solver(params, device=device, mesh=mesh)
    solver.set_conf(links)
    tick("set_conf")
    mg_setup_s = solver.setup().setup_time
    tick("setup")
    chosen = {k: on for k, (on, _) in solver.options.items()}
    if chosen != cfg["options"]:
        raise RuntimeError(f"the solver chose the options {chosen}, the configuration "
                           f"states {cfg['options']}")
    if cfg["slim_for_solve"]:
        solver.slim_for_solve()
    traffic = Traffic(cell.traffic, lattice)
    solver.solve_multi(traffic.request(seed, WARM_UP, reuse=True))
    tick("warm-up")
    tracer = trace.Tracer(solver, kernels.counts, device) if traced and lead else None
    if tracer is not None:
        tracer.start()
        tick("profiler")

    requests, kept = [], {}
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while _go_on(mesh, requests, deadline):
        i = len(requests)
        profiled = tracer is not None and i < traffic.trace_requests
        with trace.span("request"):
            td = time.perf_counter()
            with trace.span("draw"):
                rhs = traffic.request(seed, i, reuse=True)
            with trace.span("solve"):
                ts = time.perf_counter()
                xs, infos = solver.solve_multi(rhs)
                te = time.perf_counter()
            with trace.span("keep"):
                if lead and traffic.checked(seed, i):
                    kept[i] = xs
        requests.append(dict(latency_s=te - ts, end=te, draw_s=ts - td, batch=len(infos),
                             iterations=[info.iterations for info in infos],
                             relres=[info.relres for info in infos],
                             converged=[bool(info.converged) for info in infos],
                             coarse_average=infos[0].coarse_average, profiled=profiled))
        if profiled and i + 1 == traffic.trace_requests:
            tracer.stop()
    window_s = requests[-1]["end"] - t0
    setup_s = t0 - started
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    peak = int(_grid_max(mesh, peak))       # the fullest card's
    if tracer is not None:
        tracer.stop()               # a window shorter than trace_requests
    tr = None

    def rerun():
        solver.solve_multi(traffic.request(seed, 0))

    if tracer is not None:
        loops = tracer.host_loops(rerun, requests[0]["batch"])
        profiled = [r for r in requests if r["profiled"]]
        tr = tracer.summarize(sum(r["batch"] for r in profiled), loops)
        tr["profiled_request_s"] = float(np.mean([r["latency_s"] for r in profiled]))
        rest = [r["latency_s"] for r in requests if not r["profiled"]]
        tr["unprofiled_request_s"] = float(np.mean(rest)) if rest else None
        del tracer
    elif traced:                    # a grid's other ranks rerun along with rank 0
        with trace.graphs_off():
            rerun()
    del solver, rerun
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    _grid_max(mesh, 0.0)            # every rank's solver freed
    if not lead:
        return dict(result=None, record=dict(requests=requests), check_s=None)
    t = time.perf_counter()
    rel, checked = check_solutions(links, params, traffic, seed, kept, device)
    check_s = time.perf_counter() - t
    record = dict(window_s=window_s, setup_s=setup_s, mg_setup_s=mg_setup_s,
                  phases=phases, requests=requests, trace=tr, plaquette=plaq,
                  options=chosen, checked=checked, relres=rel)
    unconverged = sum(not c for r in requests for c in r["converged"])
    attempted = sum(r["batch"] for r in requests)
    over = sum(1 for v in rel.values() if not v < params.tol)
    failed_rhs = {(i, lane) for i, r in enumerate(requests)
                  for lane, c in enumerate(r["converged"]) if not c}
    failed_rhs |= {key for key, v in rel.items() if not v < params.tol}
    checks = {"worst_relres": {"value": max(rel.values()), "limit": params.tol},
              "unconverged": {"value": unconverged, "limit": 0},
              "over_limit": {"value": over, "limit": 0}}
    correct = unconverged == 0 and over == 0 and checked >= 1
    metrics = (cell.per_layer if traced else cell.end_to_end)
    out = {}
    for m, mod in metrics:
        v = mod.read(record)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device) if torch.device(device).type == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": len(failed_rhs),
              "metrics": out, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = tr["breakdown"]
    result["checks"] = checks
    return dict(result=result, record=record, check_s=check_s)


def check_solutions(links, params, traffic: Traffic, seed: int, kept: dict, device):
    """The reference's true relative residual of every kept solution, in
    complex128 on `device`, REF_LANES right-hand sides at a time: returns
    ({(request, lane): relres}, the number checked)."""
    bc = params.bc if params.bc is not None else (2 if params.anti_pbc else 1)
    if bc not in (1, 2):
        raise ValueError("the reference takes periodic or anti-periodic time boundaries")
    op = reference.WilsonClover(torch.as_tensor(links, device=device), params.m0, params.csw,
                                antiperiodic=bc == 2)
    out = {}
    for i, xs in kept.items():
        b = traffic.request(seed, i)
        for l0 in range(0, xs.shape[0], REF_LANES):
            x = torch.as_tensor(xs[l0:l0 + REF_LANES], device=device)
            rel = reference.relres(op, x, torch.as_tensor(b[l0:l0 + REF_LANES], device=device))
            for k, v in enumerate(rel.tolist()):
                out[(i, l0 + k)] = v if math.isfinite(v) else math.inf
    del op
    return out, len(out)


def _families_text(families: dict) -> str:
    return "; ".join(f"{f} {n} events {s:.6f} s" for f, (n, s) in
                     sorted(families.items(), key=lambda kv: -kv[1][1]))


def report(res: dict, err=sys.stderr):
    """The run's notes, then the numbers compared with their limits, on
    standard error (the last lines there)."""
    rec, result = res["record"], res["result"]
    lat = [r["latency_s"] for r in rec["requests"]]
    print(f"plaquette {rec['plaquette']:.10f}; options {rec['options']}; set-up "
          f"{rec['setup_s']:.4f} s: " + ", ".join(f"{k} {v:.4f}" for k, v in rec["phases"].items())
          + f" s (multigrid setup_time {rec['mg_setup_s']:.4f} s)", file=err)
    gap = max(abs(v - rec["requests"][i]["relres"][lane])
              / max(rec["requests"][i]["relres"][lane], 1e-300)
              for (i, lane), v in rec["relres"].items())
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    print(f"window {rec['window_s']:.4f} s, {len(lat)} requests, latency median {p50:.6f} s, "
          f"mean {float(np.mean(lat)):.6f} s, p95 {p95:.6f} s, p99 {p99:.6f} s, first "
          f"{lat[0]:.6f} s, max {max(lat):.6f} s; draw mean "
          f"{float(np.mean([r['draw_s'] for r in rec['requests']])):.6f} s; the reference's "
          f"relres against the solver's: largest relative gap {gap:.3e}; "
          f"iterations {sorted({n for r in rec['requests'] for n in r['iterations']})}; "
          f"reference check of {rec['checked']} rhs {res['check_s']:.2f} s", file=err)
    tr = rec["trace"]
    if tr is not None:
        def cov(c):
            return "; ".join(f"{f} {ev} / {n}" for f, (ev, n) in c.items() if ev or n)

        hl = tr["host_loops"]
        n, annotated, timed = tr["replays"]
        print(f"trace (window, replays): {tr['requests']} requests, {tr['rhs']} rhs, window "
              f"{tr['window_s']:.6f} s, busy {tr['busy_s']:.6f} s; a request "
              f"{tr['profiled_request_s']:.6f} s profiled, {tr['unprofiled_request_s']} s not; "
              f"{n} replays, {annotated:.6f} s annotated, {timed:.6f} s by CUDA events; "
              f"events / launches: {cov(tr['coverage'])}", file=err)
        print("trace (window) visible: " + _families_text(tr["visible"]), file=err)
        print(f"trace (host loops, {hl['rhs']} rhs): " + _families_text(hl["families"])
              + f"; events / launches: {cov(hl['coverage'])}", file=err)
        hl_s = sum(sec for _, sec in hl["families"].values())
        print("trace (window against host loops), a rhs: launches " + "; ".join(
            f"{f} {n / tr['rhs']:.2f} / {hl['coverage'][f][1] / hl['rhs']:.2f}"
            for f, (_, n) in tr["coverage"].items() if n or hl["coverage"][f][1])
            + f"; device s: window busy {tr['busy_s'] / tr['rhs']:.6f} (replays by CUDA "
            f"events {timed / tr['rhs']:.6f}), host loops' events {hl_s / hl['rhs']:.6f}",
            file=err)
        print("trace (host loops) top kernels: " + "; ".join(
            f"{name[:90]} [{f}] {k} {sec:.6f} s" for name, f, k, sec in hl["top_events"]),
            file=err)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=err)
    err.flush()
