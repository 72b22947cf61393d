#!/usr/bin/env python
"""Wall times of the port's rough16 path on one CUDA card, for comparing two
checkouts in turns within one call:

    python3 scripts/time_torch_solve.py [--root DIR] [--repeats N] [--options | --defaults]
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
    line = json.dumps(result)
    print(line)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
