#!/usr/bin/env python
"""Wall times of the port's rough16 solve on a process grid (gloo ranks
that share one CUDA card, or nccl ranks on a card each), for comparing two
checkouts in turns within one call, and the split of a warm solve by the
grid's parts:

    python3 scripts/time_torch_grid.py [--root DIR] [--dims 1,2,1,1] [--repeats N]
                                       [--transport gloo | nccl] [--parts] [--out FILE]

Ranks are spawned (parallel/launch.run_ranks of the checkout at DIR, this
one by default; e.g. the parent unpacked by git archive under build/) on
cuda:0 with the "gloo" transport, or with --transport nccl on a card each
(cuda:0, cuda:1, ...).  Each rank: the rough16 solver of
chip_smoke.rough16_params() (the options off), one setup, a cold solve and
N warm solves (SolveInfo.solve_time: the slowest rank's wall time).

--parts (this checkout's package) adds one more warm solve with each part
of the grid timed on the host clock between two synchronizations of the
card: the face exchanges (comm.Exchange, posting to finish), the
all-reduces (comm.all_reduce_sum), the gathers to the replicated level
(comm.all_gather_lattice), K5 (cuda_coarse.coarse_apply_halo),
the fine face corrections (soa_halo.Faces.finish without its exchange),
the local fine kernels (cuda_dslash.d_plus_clover / hopping), the coarsest
GCR (mg/coarsest.CoarsestGraph calls: replays), the inner restarts' and
cycles' replays (mg/programs.py: on nccl, whose parts the split then sees
whole) and what is left of the
solve (the host's gaps, torch ops, K3, K4, K7).  A part's time excludes
the parts nested in it; the synchronizations serialize what the solve
overlaps, so the profiled solve is slower than the unprofiled one, and
both are printed.  Prints one JSON line (the card's nvidia-smi line in
it) and writes it to FILE (default build/time_torch_grid.json).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Parts:
    """Inclusive and self seconds of nested, synchronized regions."""

    def __init__(self):
        self.self_s, self.calls, self.stack = {}, {}, []

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.stack.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
                nested = self.stack.pop()
                self.self_s[name] = self.self_s.get(name, 0.0) + total - nested
                self.calls[name] = self.calls.get(name, 0) + 1
                if self.stack:
                    self.stack[-1] += total
        return timed


def instrument(parts):
    """Wrap the grid's parts of this checkout's package (module note)."""
    from ddalphaamg_tpu_torch.mg import coarsest, programs
    from ddalphaamg_tpu_torch.operators import cuda_coarse, cuda_dslash
    from ddalphaamg_tpu_torch.parallel import comm, soa_halo
    from ddalphaamg_tpu_torch.solvers import cuda_graph

    comm.Exchange.__init__ = parts.wrap("exchange (post)", comm.Exchange.__init__)
    comm.Exchange.finish = parts.wrap("exchange (finish)", comm.Exchange.finish)
    comm.all_reduce_sum = parts.wrap("all-reduce", comm.all_reduce_sum)
    comm.all_gather_lattice = parts.wrap("gather to the replicated level",
                                         comm.all_gather_lattice)
    cuda_coarse.coarse_apply_halo = parts.wrap("K5", cuda_coarse.coarse_apply_halo)
    soa_halo.Faces.finish = parts.wrap("face corrections", soa_halo.Faces.finish)
    cuda_dslash.d_plus_clover = parts.wrap("K1 (local)", cuda_dslash.d_plus_clover)
    cuda_dslash.hopping = parts.wrap("K2 (local)", cuda_dslash.hopping)
    coarsest.CoarsestGraph.__call__ = parts.wrap("coarsest GCR replays",
                                                 coarsest.CoarsestGraph.__call__)
    for cls in (programs.InnerRestartGraph, programs.CycleGraph):
        cls.__call__ = parts.wrap("inner restart / cycle replays", cuda_graph.GraphProgram.__call__)


def rank_run(mesh, device, repeats, with_parts):
    import chip_smoke
    from ddalphaamg_tpu_torch import api, config

    solver = api.Solver(chip_smoke.rough16_params(False), device=device, mesh=mesh)
    solver.read_conf()
    setup_s = solver.setup().setup_time
    rhs = config.make_rhs("ones", solver.lattice)
    _, cold = solver.solve(rhs)
    warm = [solver.solve(rhs)[1] for _ in range(repeats)]
    out = dict(rank=mesh.rank, setup_s=setup_s, cold_s=cold.solve_time,
               warm_s=[w.solve_time for w in warm], iterations=[w.iterations for w in warm],
               relres=[w.relres for w in warm])
    if with_parts:
        parts = Parts()
        instrument(parts)
        _, prof = solver.solve(rhs)
        out["parts"] = dict(wall_s=prof.solve_time, self_s=parts.self_s, calls=parts.calls,
                            rest_s=prof.solve_time - sum(parts.self_s.values()),
                            unprofiled_s=statistics.median(out["warm_s"]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose package is timed")
    ap.add_argument("--dims", default="1,2,1,1", help="the process grid (t, z, y, x)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--parts", action="store_true", help="split one more warm solve by part")
    ap.add_argument("--transport", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--out", default=os.path.join(HERE, "build", "time_torch_grid.json"))
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.root), HERE]
    from ddalphaamg_tpu_torch import kernels
    from ddalphaamg_tpu_torch.parallel import launch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the times are taken on a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels.lib()       # built once, before the ranks load it
    dims = tuple(int(x) for x in args.dims.split(","))
    t0 = time.perf_counter()
    n = math.prod(dims)
    devices = ["cuda:0"] * n if args.transport == "gloo" else [f"cuda:{i}" for i in range(n)]
    res = launch.run_ranks(rank_run, dims, args.transport, devices, args.repeats, args.parts)
    r0 = res[0]
    result = dict(device=smi, root=os.path.abspath(args.root), dims=dims,
                  transport=args.transport,
                  setup_s=r0["setup_s"], cold_s=r0["cold_s"], warm_s=r0["warm_s"],
                  warm_median_s=statistics.median(r0["warm_s"]), iterations=r0["iterations"],
                  relres=r0["relres"], seconds=time.perf_counter() - t0,
                  parts=[r.get("parts") for r in res])
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
