"""Command-line entry point (reference main.c / top_level.c analog):

    python -m ddalphaamg_tpu_torch.cli <input.ini> [--device cuda|cpu] [--tol T]
        [--benchmark N] [--profile] [--rhs-batch B]

Reads a reference-format input file, builds the solver on the device, runs
the setup and the solve, and prints a reference-shaped summary (the JAX
package's cli.py, with --device in place of its --platform): --benchmark N
repeats the solve N times and prints the mean and least solve time
(reference WILSON_BENCHMARK, src/top_level.c:71), --rhs-batch B solves B
random right-hand sides together with Solver.solve_multi, --profile prints
the profiler's table of the solves and a per-level table of the hierarchy
(profiling.py).  An ini with `evaluation: 1` runs its parameter scan
instead (evaluation.py) and prints the scan's table.  Every
`method` (-1 to 5) and `interpolation` (0, 1, 2, 4; 4 reads the test
vectors from `test vector io file name`) of the ini runs.  A configuration
path in the ini that does not exist is looked up beside the ini file.

An ini whose `d0 local lattice` is smaller than its `d0 global lattice`
requests the process grid global / local (the reference's run script
derives np the same way), along any of t, z, y and x (`16 16 8 8` on a 16^4
lattice: a (1, 1, 2, 2) grid).  Start one process per rank with torchrun:

    torchrun --nproc-per-node=N -m ddalphaamg_tpu_torch.cli <input.ini> \\
        [--transport nccl|gloo]

"nccl" (the default) pins rank r to cuda:LOCAL_RANK and needs a card per
rank; "gloo" lets ranks share cards (its faces and sums cross the host).
Only rank 0 prints.
"""

from __future__ import annotations

import argparse
import math
import sys
import time


def _process_grid(params):
    d0 = params.depth[0]
    if not d0.local_lattice:
        return None
    dims = tuple(g // l for g, l in zip(d0.global_lattice, d0.local_lattice))
    return dims if math.prod(dims) > 1 else None


def main(argv=None):
    ap = argparse.ArgumentParser(description="DD-alphaAMG solver (PyTorch + CUDA)")
    ap.add_argument("ini", help="input parameter file (reference format)")
    ap.add_argument("--device", default="cuda", help="torch device type (default cuda)")
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--transport", choices=("nccl", "gloo"), default="nccl",
                    help="rank transport of a process grid (default nccl)")
    ap.add_argument("--benchmark", type=int, default=0, metavar="N",
                    help="repeat the solve N times, report avg/min "
                         "(reference WILSON_BENCHMARK, src/top_level.c:71)")
    ap.add_argument("--profile", action="store_true",
                    help="print the per-kernel profiling table")
    ap.add_argument("--rhs-batch", type=int, default=0, metavar="B",
                    help="after the main solve, solve B random right-hand "
                         "sides together (Solver.solve_multi) and report the "
                         "time a right-hand side")
    args = ap.parse_args(argv)
    if args.profile:
        from .profiling import PROF
        PROF.enabled = True

    from . import config

    params = config.resolve_configuration(config.parse_ini(args.ini), args.ini)
    mesh, device = None, args.device
    dims = _process_grid(params)
    if dims is not None:
        import torch.distributed as dist

        from . import kernels
        from .parallel import launch

        mesh, device = launch.from_environment(dims, args.transport, args.device)
    try:
        if mesh is not None and device.type == "cuda":
            if mesh.rank == 0:        # one nvcc run: rank 0 builds, the rest load
                kernels.lib()
            dist.barrier()
        return _run(params, args, mesh, device)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _run(params, args, mesh, device) -> int:
    import numpy as np

    from . import api, config

    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    if mesh is not None:
        say(f"process grid {mesh.dims} over {mesh.size} ranks "
            f"({mesh.comm.transport})")
    if params.evaluation:
        # parameter-scan mode (reference "evaluation: 1", src/var_table.c)
        from .evaluation import ScanConfig, run_scan
        run_scan(params, ScanConfig.from_params(params), printer=say, device=device,
                 mesh=mesh)
        return 0

    solver = api.Solver(params, device=device, mesh=mesh)
    say(f"configuration: {params.configuration}")
    plaq, header = solver.read_conf()
    say(f"Desired average plaquette: {header:.13f} in [0,3]")
    say(f"Computed average plaquette: {plaq:.13f} in [0,3]")

    t0 = time.perf_counter()
    solver.setup()
    say(f"setup time: {time.perf_counter() - t0:.3f} seconds")
    if solver.options:       # the hierarchy's accelerator options, as chosen
        say("options: " + "; ".join(f"{k.replace('_', ' ')} {'on' if on else 'off'} ({why})"
                                     for k, (on, why) in solver.options.items()))

    rhs = config.make_rhs(params.right_hand_side, solver.lattice, seed=params.seed)
    x, info = solver.solve(rhs, tol=args.tol)
    if solver.mg is not None:
        for name, sec in solver.mg.build_times.items():   # built lazily in the solve
            say(f"{name}: built in {sec:.3f} seconds (inside the solve time)")
    if args.rhs_batch > 1:
        rng = np.random.default_rng(params.seed + 1)
        shape = (*solver.lattice, 4, 3)
        bs = np.stack([rng.normal(size=shape) + 1j * rng.normal(size=shape)
                       for _ in range(args.rhs_batch)])
        t0 = time.perf_counter()
        _, minfos = solver.solve_multi(bs, tol=args.tol)
        mt = time.perf_counter() - t0
        conv = sum(1 for i in minfos if i.converged)
        say(f"+- multi-RHS: {args.rhs_batch} solves (batched) "
            f"--------------------------+")
        say(f"|      per-RHS time: {mt / args.rhs_batch:9.4f} seconds "
            f"({conv}/{args.rhs_batch} converged) |")
    if args.benchmark > 0:
        # WILSON_BENCHMARK: repeat the solve, report avg/min
        times = [info.solve_time]
        for _ in range(args.benchmark - 1):
            times.append(solver.solve(rhs, tol=args.tol)[1].solve_time)
        say(f"+- benchmarking: {len(times)} solves "
            f"-------------------------------------+")
        say(f"|      avg solve time: {np.mean(times):9.4f} seconds        |")
        say(f"|      min solve time: {np.min(times):9.4f} seconds        |")
    exact = solver.true_residual(x, rhs)
    say("+----------------------------------------------------------+")
    say(f"|       FGMRES iterations: {info.iterations:<6d} coarse average: {info.coarse_average:<6.2f}   |")
    say(f"| exact relative residual: ||r||/||b|| = {exact:e}      |")
    say(f"| elapsed wall clock time: {info.solve_time:<8.4f} seconds                |")
    if info.memory_mb:
        say(f"| maximal device memory/MPI process: {info.memory_mb:<8.1f} MB        |")
    say("+----------------------------------------------------------+")
    if info.inner_restart_cap:      # the multigrid outer loop's (outside the reference's box)
        say(f"inner restart cap: {info.inner_restart_cap}, last inner tol clip: "
            f"{info.inner_tol_clip:.3e}")
    if args.profile:
        from .profiling import PROF, profile_hierarchy
        say(PROF.table())
        if solver.mg is not None:
            # per-level kernel-class table (reference prof_print analog);
            # every rank runs it, its calls hold collectives
            say(profile_hierarchy(solver.mg).table())
    return 0 if info.converged else 1


if __name__ == "__main__":
    sys.exit(main())
