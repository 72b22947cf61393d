"""Command-line entry point (reference main.c / top_level.c analog):

    python -m ddalphaamg_tpu_torch.cli <input.ini> [--device cuda|cpu] [--tol T]

Reads a reference-format input file, builds the solver on the device, runs
the setup and the solve, and prints a reference-shaped summary.  A
configuration path in the ini that does not exist is looked up beside the
ini file.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="DD-alphaAMG solver (PyTorch + CUDA)")
    ap.add_argument("ini", help="input parameter file (reference format)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--tol", type=float, default=None)
    args = ap.parse_args(argv)

    from . import api, config

    params = config.resolve_configuration(config.parse_ini(args.ini), args.ini)
    solver = api.Solver(params, device=args.device)
    print(f"configuration: {params.configuration}")
    plaq, header = solver.read_conf()
    print(f"Desired average plaquette: {header:.13f} in [0,3]")
    print(f"Computed average plaquette: {plaq:.13f} in [0,3]")

    t0 = time.perf_counter()
    solver.setup()
    print(f"setup time: {time.perf_counter() - t0:.3f} seconds")

    rhs = config.make_rhs(params.right_hand_side, solver.lattice, seed=params.seed)
    x, info = solver.solve(rhs, tol=args.tol)
    exact = solver.true_residual(x, rhs)
    print("+----------------------------------------------------------+")
    print(f"|       FGMRES iterations: {info.iterations:<6d} coarse average: {info.coarse_average:<6.2f}   |")
    print(f"| exact relative residual: ||r||/||b|| = {exact:e}      |")
    print(f"| elapsed wall clock time: {info.solve_time:<8.4f} seconds                |")
    print("+----------------------------------------------------------+")
    return 0 if info.converged else 1


if __name__ == "__main__":
    sys.exit(main())
