"""Parameter-scan ("evaluation") mode: rerun setup and solve while sweeping one
parameter, and print a table of the results (reference var_table.c:68-128,
SCAN_VAR macro var_table.h, ini keys src/init.c:914-941; the JAX package's
evaluation.py, whose table this prints).

Scan variables are named as in the ini file: a global key ("m0",
"tolerance for relative residual", ...) or a per-depth key ("d0 setup iter",
"d0 test vectors", ...).  A scan of m0 with `shift update: 1` keeps one
setup and moves the mass with Solver.shift_update; otherwise
`setup update: 1` builds a Solver and its setup anew at every point.
"""

from __future__ import annotations

import dataclasses
import re
import time

import numpy as np

from .config import (SolverParams, _BOOL_KEYS, _DEPTH_KEYS, _FLOAT_KEYS,
                     _INT_KEYS, make_rhs)


@dataclasses.dataclass
class ScanConfig:
    """Mirror of the reference vt struct (ini keys src/init.c:914-941)."""
    scan_variable: str = ""
    start_val: float = 0.0
    end_val: float = 0.0
    step_size: float = 1.0
    multiplicative: bool = False
    shift_update: bool = True      # a scan of m0 moves the mass by shift_update
    re_setup: bool = True          # a new setup at every scan point
    track_error: bool = False
    track_cgn_error: bool = False
    average_over: int = 1

    @classmethod
    def from_params(cls, p: SolverParams) -> "ScanConfig":
        """The scan an ini file's keys ask for."""
        return cls(scan_variable=p.scan_variable, start_val=p.start_val,
                   end_val=p.end_val, step_size=p.step_size,
                   multiplicative=p.multiplicative, shift_update=p.scan_shift_update,
                   re_setup=p.scan_re_setup, track_error=p.track_error,
                   track_cgn_error=p.track_cgn_error, average_over=p.average_over)


@dataclasses.dataclass
class ScanRow:
    value: float
    setup_time: float
    solve_iters: float
    solve_time: float
    coarse_avg: float
    relres: float
    error: float = float("nan")


def _set_scan_value(params: SolverParams, name: str, value: float):
    m = re.match(r"^d(\d+)\s+(.*)$", name)
    if m:
        depth, sub = int(m.group(1)), m.group(2).strip()
        attr, kind = _DEPTH_KEYS[sub]
        setattr(params.depth[depth], attr,
                int(round(value)) if kind == "int" else value)
        return
    if name in _INT_KEYS:
        setattr(params, _INT_KEYS[name], int(round(value)))
    elif name in _FLOAT_KEYS:
        setattr(params, _FLOAT_KEYS[name], float(value))
    elif name in _BOOL_KEYS:
        setattr(params, _BOOL_KEYS[name], bool(int(round(value))))
    else:
        raise KeyError(f"unknown scan variable {name!r}")


def scan_values(sc: ScanConfig):
    ascending = (sc.step_size > 1) if sc.multiplicative else (sc.step_size > 0)
    vals = []
    v = sc.start_val
    for _ in range(10000):
        if ascending and v > sc.end_val + 1e-12:
            break
        if not ascending and v < sc.end_val - 1e-12:
            break
        vals.append(v)
        v = v * sc.step_size if sc.multiplicative else v + sc.step_size
    else:
        raise ValueError("scan does not terminate")
    if not vals:
        raise ValueError("empty scan range")
    return vals


def _reference_solution(solver, rhs) -> np.ndarray:
    """The error reference of a scan point: CGN on K1 and gamma5 K1 gamma5 in
    complex128 to 1e-12 (reference track_cgn_error, src/init.c:934-937), on
    slabs with global inner products under a mesh."""
    from .solvers.krylov import cgn

    res = cgn(solver.outer.full_op, solver.outer.dagger_op, solver._scatter(rhs),
              tol=1e-12, max_iter=100000, mesh=solver.mesh)
    return solver._gather(res.x)


def run_scan(params: SolverParams, sc: ScanConfig, printer=print, device="cuda",
             mesh=None):
    """Run the sweep on `device` (this rank's of `mesh`); returns the list
    of ScanRow (reference scan_var, src/var_table.c:68) after printing the
    table.  Error tracking's CGN takes global inner products on a mesh."""
    from . import api

    rows = []
    x_ref = None
    ref_outer = None        # the operator x_ref was computed against
    solver = None
    for v in scan_values(sc):
        p = dataclasses.replace(params, depth=[dataclasses.replace(d) for d in params.depth])
        _set_scan_value(p, sc.scan_variable, v)
        scans_m0 = sc.scan_variable == "m0"
        if solver is None or (sc.re_setup and not (scans_m0 and sc.shift_update)):
            solver = api.Solver(p, device=device, mesh=mesh)
            solver.read_conf()
            t0 = time.time()
            solver.setup()
            setup_t = time.time() - t0
        elif scans_m0 and sc.shift_update:
            # the mass moved without a setup (reference shift_update,
            # src/var_table.c:82-90 / src/dirac.c:670)
            t0 = time.time()
            solver.shift_update(v)
            setup_t = time.time() - t0
        else:
            # the setup stays; the solver reads the other parameters anew
            solver.p = p
            setup_t = 0.0

        iters = tsolve = cavg = rres = 0.0
        err = float("nan")
        rhs = make_rhs(p.right_hand_side, solver.lattice, seed=p.seed)
        for _ in range(max(1, sc.average_over)):
            x, info = solver.solve(rhs)
            iters += info.iterations
            tsolve += info.solve_time
            cavg += info.coarse_average
            rres = info.relres
            if sc.track_error or sc.track_cgn_error:
                if x_ref is None or ref_outer is not solver.outer:
                    x_ref = _reference_solution(solver, rhs)
                    ref_outer = solver.outer
                err = float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))
        n = max(1, sc.average_over)
        rows.append(ScanRow(v, setup_t, iters / n, tsolve / n, cavg / n, rres, err))
    printer(format_table(sc, rows))
    return rows


def format_table(sc: ScanConfig, rows) -> str:
    """plot_table analog (src/var_table.c:110-128)."""
    show_err = sc.track_error or sc.track_cgn_error
    hdr = (f"| {sc.scan_variable:>24s} | setup(s) | iters | solve(s) "
           f"| coarse avg |   relres |")
    if show_err:
        hdr += "    error |"
    sep = "+" + "-" * (len(hdr) - 2) + "+"
    lines = [sep, hdr, sep]
    for r in rows:
        row = (f"| {r.value:24.6g} | {r.setup_time:8.2f} | {r.solve_iters:5.1f} "
               f"| {r.solve_time:8.3f} | {r.coarse_avg:10.2f} | {r.relres:.2e} |")
        if show_err:
            row += f" {r.error:.2e} |"
        lines.append(row)
    lines.append(sep)
    return "\n".join(lines)
