#!/usr/bin/env python
"""Wall times of the port's rough16 path on one CUDA card, for comparing two
checkouts in turns within one call:

    python3 scripts/time_torch_solve.py [--root DIR] [--repeats N] [--options | --defaults]
                                        [--out FILE]
    python3 scripts/time_torch_solve.py --setup [--rough32] [--root DIR] [--repeats N]
                                        [--out FILE]

With the accelerator options off: two setups (hierarchy and bootstrap; the
second is the one reported as warm), N warm solves of the right-hand side
of ones and, where the checkout has Solver.solve_multi, N batches of the 12
spin-colour point sources at the origin.  Every time is the host clock
around work that ends in torch.cuda.synchronize (SetupStatus.setup_time,
SolveInfo.solve_time; a batch's time is solve_time times its size).
--options turns the three accelerator options on (bf16 coarse blocks, the
coarsest Schur inverse, direct block solves) and adds K6's device time
(chip_smoke.k6_device_ms: torch.profiler's kernel events, with every GCR
driven from the host where the checkout has device programs: the profiler
misses kernels inside graph replays) in one more warm solve, in one more
batch, and in a warm solve of method 3 (sixteen-colour SAP) with the
options, after its setup and first solve.  --defaults leaves the options
unset, so that the CUDA defaults decide (chip_smoke.py's phase
"defaults").  --root DIR times
the package of another checkout (e.g. the parent commit unpacked by git
archive under build/) on the same data.  Prints one JSON
line (the card's nvidia-smi line in it) and writes it to FILE (default
build/time_torch_solve.json).

--setup times setups only: N setups of rough16 with the options off (the
first one cold), each with its peak device memory and the graphs it
captured (captures, their seconds, the largest pools held at once), then
one more with the profiler on (profiling.PROF, a synchronization at the
end of every region): the seconds of each setup phase by depth (the JAX
package's region names; a checkout without them gives none) and what is
left of the setup outside them, with the peak device memory inside each
phase and outside them.  --rough32 adds one profiled setup of
chip_smoke.py's configuration "rough32" (32^4, the CUDA defaults).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose package is timed")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--options", action="store_true", help="the accelerator options on")
    ap.add_argument("--defaults", action="store_true", help="the options left to the defaults")
    ap.add_argument("--setup", action="store_true", help="time setups only")
    ap.add_argument("--rough32", action="store_true", help="with --setup: rough32's setup too")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "time_torch_solve.json"))
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.root), HERE]
    import chip_smoke  # rough16's parameters and the point sources
    from ddalphaamg_tpu_torch import api, config, kernels

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the times are taken on a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels.lib()
    if args.setup:
        write(setup_times(args, smi, chip_smoke), args.out)
        return
    solver = api.Solver(chip_smoke.rough16_params(None if args.defaults else args.options),
                        device="cuda")
    solver.read_conf()
    setups = [solver.setup().setup_time for _ in range(2)]
    rhs = config.make_rhs("ones", solver.lattice)
    solver.solve(rhs)
    solves, iterations = [], set()
    for _ in range(args.repeats):
        _, info = solver.solve(rhs)
        solves.append(info.solve_time)
        iterations.add(info.iterations)
    result = dict(device=smi, root=os.path.abspath(args.root), setup_s=setups,
                  warm_solve_s=solves, warm_solve_median_s=statistics.median(solves),
                  iterations=sorted(iterations))
    if hasattr(solver, "solve_multi"):
        point = chip_smoke.point_sources(solver.lattice)
        batches = []
        for _ in range(args.repeats):
            _, infos = solver.solve_multi(point)
            batches.append(infos[0].solve_time * len(infos))
        result.update(multi_batch_s=batches, multi_batch_median_s=statistics.median(batches),
                      multi_iterations=[i.iterations for i in infos])
    result.update(defaults=args.defaults)
    if args.options:
        with chip_smoke.host_loops():
            k6 = {"warm solve": chip_smoke.k6_device_ms(lambda: solver.solve(rhs)),
                  "solve_multi": chip_smoke.k6_device_ms(lambda: solver.solve_multi(point))}
        del solver
        m3 = api.Solver(chip_smoke.method_params(3, **{k: True for k in chip_smoke.OPTIONS}),
                        device="cuda")
        m3.read_conf()
        m3.setup()
        m3.solve(rhs)
        _, info = m3.solve(rhs)
        with chip_smoke.host_loops():
            k6["method 3, warm solve"] = chip_smoke.k6_device_ms(lambda: m3.solve(rhs))
        result.update(options=True, k6_device_ms={p: ms for p, (ms, _) in k6.items()},
                      k6_launches={p: n for p, (_, n) in k6.items()},
                      method3_warm_solve_s=info.solve_time, method3_iterations=info.iterations)
    write(result, args.out)


def write(result, out):
    """Print the result as one JSON line and write it to out."""
    line = json.dumps(result)
    print(line)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(line + "\n")


def one_setup(solver, profile=False):
    """solver.setup() timed, with its peak device memory (GiB), the graphs
    its hierarchy captured and, with profile, the profiler's setup phases
    {"depth d: name": [seconds, count]} beside the setup's seconds outside
    them, and the peak device memory inside each phase and outside them."""
    from ddalphaamg_tpu_torch.mg import hierarchy
    from ddalphaamg_tpu_torch.profiling import PROF

    GiB = 2**30
    peaks = {"outside the phases": 0.0}
    real = getattr(hierarchy, "_prof", None)

    def peaked(name, depth, fn, device):
        """The phase's peak apart from the peak before it (outside)."""
        key = f"depth {depth}: {name}"
        peaks["outside the phases"] = max(peaks["outside the phases"],
                                          torch.cuda.max_memory_allocated() / GiB)
        torch.cuda.reset_peak_memory_stats()
        out = real(name, depth, fn, device)
        peaks[key] = max(peaks.get(key, 0.0), torch.cuda.max_memory_allocated() / GiB)
        torch.cuda.reset_peak_memory_stats()
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PROF.reset()
    PROF.enabled, PROF.sync = profile, True
    if profile and real is not None:
        hierarchy._prof = peaked
    try:
        seconds = solver.setup().setup_time
    finally:
        PROF.enabled = False
        if real is not None:
            hierarchy._prof = real
    peaks["outside the phases"] = max(peaks["outside the phases"],
                                      torch.cuda.max_memory_allocated() / GiB)
    out = dict(setup_s=seconds, peak_gib=max(peaks.values()), graphs=dict(solver.mg.graph_stats))
    if profile:
        phases = {f"depth {d}: {name}": [e.time, e.count]
                  for (d, name), e in sorted(PROF.entries.items())}
        out.update(phases=phases, outside_phases_s=seconds - sum(t for t, _ in phases.values()),
                   peak_gib_by_phase=peaks)
    PROF.reset()
    return out


def setup_times(args, smi, chip_smoke):
    """--setup: rough16's setups (and rough32's with --rough32), see the
    module note."""
    from ddalphaamg_tpu_torch import api

    solver = api.Solver(chip_smoke.rough16_params(False), device="cuda")
    solver.read_conf()
    runs = [one_setup(solver) for _ in range(args.repeats)]
    result = dict(device=smi, root=os.path.abspath(args.root), setup_s=[r["setup_s"] for r in runs],
                  warm_setup_median_s=statistics.median(r["setup_s"] for r in runs[1:] or runs),
                  setups=runs, profiled=one_setup(solver, profile=True))
    del solver
    if args.rough32:
        torch.cuda.empty_cache()
        U, _ = chip_smoke.rough32_field()
        solver = api.Solver(chip_smoke.rough32_params(), device="cuda")
        solver.set_conf(U, links_have_bc=True)
        del U
        torch.cuda.empty_cache()
        result["rough32"] = one_setup(solver, profile=True)
        del solver
        torch.cuda.empty_cache()
    return result


if __name__ == "__main__":
    main()
