"""The control of a cell's check: the reference put in the solver's place
one precision below the configuration's (plain CG on the normal equations
of the reference operator in complex64, where the configuration states complex128
solutions), run on the cell's first request of each seed and judged by the
same check as a run (harness.check_solutions).  It has to come out not
correct.

    python3 gpubench/control.py --workload <cell> --seeds 1 2 3

Prints one line a seed (the control's worst true relative residual, its
iterations, the limit) and a last JSON line with them.  Runs on the card
when there is one, else on the CPU (the tests' tiny cells).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def control_readings(cell, seeds, device, max_iter: int = 4000, dtype=torch.complex64):
    """[(seed, worst relres, iterations, seconds)] of the control (the
    solver in `dtype`) on request 0 of each seed, and the limit."""
    from gpubench import field, harness, reference
    from gpubench.traffic import Traffic

    params = harness.solver_params(cell.config)
    lattice = tuple(params.depth[0].global_lattice)
    fld = cell.config["field"]
    U = field.rough_su3(lattice, int(fld["seed"]), float(fld["target_plaquette"]),
                        float(fld["tolerance"]), device)
    links = U.cpu().numpy()
    op = reference.WilsonClover(U, params.m0, params.csw, antiperiodic=bool(params.anti_pbc),
                                dtype=dtype)
    del U
    traffic = Traffic(cell.traffic, lattice)
    out = []
    for seed in seeds:
        t = time.perf_counter()
        b = torch.as_tensor(traffic.request(seed, 0), device=device)
        x, its = reference.cgnr(op, b, params.tol, max_iter)
        kept = {0: x.to(torch.complex128).cpu().numpy()}
        rel, _ = harness.check_solutions(links, params, traffic, seed, kept, device)
        out.append((seed, max(rel.values()), its, time.perf_counter() - t))
    return out, params.tol


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)         # this folder's modules only as gpubench.*
    from gpubench import harness

    cell = harness.load_cell(args.workload, ROOT)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    rows, limit = control_readings(cell, args.seeds, device)
    for seed, worst, its, s in rows:
        print(f"control {cell.name} seed {seed}: worst relres {worst!r} (limit {limit!r}, "
              f"{'not correct' if not worst < limit else 'CORRECT'}), {its} iterations, "
              f"{s:.1f} s", flush=True)
    print(json.dumps({"workload": cell.name, "device": device, "limit": limit,
                      "readings": [[s, w, i] for s, w, i, _ in rows]}))
    return 0 if all(not w < limit for _, w, _, _ in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
