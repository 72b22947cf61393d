#!/usr/bin/env python
"""Probe the device programs' CUDA graphs on one CUDA card:

    python3 scripts/probe_torch_graph.py [--root DIR]

1. torch's version, and whether torch.cuda.CUDAGraph offers conditional
   nodes (begin_capture_to_if_node).
2. (This checkout's one-body loops only.)  WHILE nodes nested 5 deep,
   as the inner restart nests them (fine iterations -> K-cycle restarts ->
   K-cycle iterations -> coarsest restarts -> coarsest iterations): loops
   of 2, 3, 2, 3 and 2 passes, the innermost body adding one to a counter,
   and the loops' trip counters; the cost of a pass of an empty one-body
   loop (a replay of 1,000 passes against 1); the pool a capture of the
   coarsest GCR reserves at m = 4 and m = 100 (one body either way).
3. The coarsest GCR (mg.coarsest.CoarsestGraph) of the checkout at DIR (this
   one by default; an older checkout runs its own graph design, e.g. PR
   13's nested IF chain) at phase "graph"'s cases of chip_smoke.py: random
   coarse stencils at 4^4 (batch 1 and 28) and 8^4 with bf16 blocks
   (batch 1), rough16's coarse-solve parameters; ms a call (CUDA events
   over 20 replays), iterations, the capture's seconds; and a call on a zero
   right-hand side (every first loop test false) at m = 100 and m = 1.
Prints one line per item and the card's name and power limit.  To compare
two checkouts, run them in turns in one call (parent, this, this, parent).
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (((4, 4, 4, 4), 1, False), ((4, 4, 4, 4), 28, False), ((8, 8, 8, 8), 1, True))


def random_coarsest(lat, d, gen, bf16):
    """chip_smoke.random_coarsest: self blocks I plus 0.05 noise, hops of
    0.023 (~10 GCR iterations to 5e-2 at 4^4, d = 56)."""
    from ddalphaamg_tpu_torch.geometry import Geometry
    from ddalphaamg_tpu_torch.operators.stencil import CoarseStencilSoA

    V = math.prod(lat)
    Pk = torch.randn((9, d, d, V), generator=gen, dtype=torch.complex64, device="cuda")
    Pk[0] *= 0.05 * math.sqrt(2)
    Pk[0] += torch.eye(d, dtype=Pk.dtype, device="cuda")[:, :, None]
    Pk[1:] *= 0.023 * math.sqrt(2)
    s = CoarseStencilSoA.from_blocks(Pk, Geometry(lat, (2, 2, 2, 2)))
    return s.compress() if bf16 else s


def replay_ms(launch, reps=20):
    launch()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nesting():
    """Item 2 (the one-body loops of solvers/cuda_graph.py)."""
    from ddalphaamg_tpu_torch.mg.coarsest import CoarsestGraph
    from ddalphaamg_tpu_torch.solvers.cuda_graph import GraphProgram

    passes = (2, 3, 2, 3, 2)
    count = torch.zeros((), dtype=torch.long, device="cuda")

    def program(ctl, x):
        def level(k):
            if k == len(passes):
                x.add_(1)
                return
            ctl.loop(passes[k], None, lambda j: level(k + 1))

        level(0)
        return {"x": x}

    g = GraphProgram(program, {"x": count}, "cuda")
    got = int(g(x=torch.zeros_like(count))["x"])
    trips = g.graph.trips[:len(passes)].tolist()
    want = math.prod(passes)
    print(f"WHILE nodes nested {len(passes)} deep, passes {passes}: innermost body ran "
          f"{got} times ({want} expected), trips {trips}, parents {g.graph.parents}: "
          f"{'ok' if got == want else 'WRONG'}", flush=True)
    if got != want:
        sys.exit(1)
    for n in (1, 1000):
        e = GraphProgram(lambda ctl, x: ctl.loop(n, None, lambda j: None) or {"x": x},
                         {"x": torch.zeros(1, device="cuda")}, "cuda")
        print(f"an empty one-body loop of {n} passes: {replay_ms(e.graph.launch):.4f} ms a "
              f"replay", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    s = random_coarsest((4, 4, 4, 4), 56, gen, False)
    for m in (4, 100):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        c = CoarsestGraph(s, 28, m, 5e-2, 5, True)
        torch.cuda.synchronize()
        print(f"coarsest graph 4^4 d=56 batch 28, m = {m}: capture {c.graph.capture_seconds:.3f} "
              f"s, pool {c.graph.pool_bytes} bytes ({torch.cuda.memory_reserved() - r0} reserved), "
              f"{len(c.graph.loops)} loop bodies", flush=True)
        c.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose ddalphaamg_tpu_torch to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from ddalphaamg_tpu_torch import kernels
    from ddalphaamg_tpu_torch.mg.coarsest import CoarsestGraph, coarsest_gcr
    from ddalphaamg_tpu_torch.solvers.cuda_graph import CudaGraph

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    api = hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")
    print(f"checkout {os.path.abspath(args.root)}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; torch.cuda.CUDAGraph.begin_capture_to_if_node: "
          f"{'present' if api else 'absent'}", flush=True)
    kernels.lib()
    if hasattr(CudaGraph, "loop"):
        nesting()
    gen = torch.Generator(device="cuda").manual_seed(99)
    args_gcr = (100, 5e-2, 5, True)
    for lat, B, bf16 in CASES:
        s = random_coarsest(lat, 56, gen, bf16)
        b = torch.randn((B, *s.field_shape), generator=gen, dtype=torch.complex64, device="cuda")
        if B > 1:
            b[1] = 0
        t0 = time.perf_counter()
        g = CoarsestGraph(s, B, *args_gcr)
        torch.cuda.synchronize()
        capture = time.perf_counter() - t0
        x0, c0 = coarsest_gcr(s, b, *args_gcr)
        x1, c1 = g(b)
        same = torch.equal(x0, x1) and torch.equal(c0, c1)
        print(f"coarsest graph {lat[0]}^4 d=56 batch {B}{', bf16 blocks' if bf16 else ''}: "
              f"{int(c0[:, 0].max())} iterations, {replay_ms(lambda: g(b)):.4f} ms a call, "
              f"capture {capture:.3f} s, {'bit-equal to' if same else 'DIFFERS from'} the host "
              f"loop", flush=True)
        g.close()
    s = random_coarsest((4, 4, 4, 4), 56, gen, False)
    zero = torch.zeros((1, *s.field_shape), dtype=torch.complex64, device="cuda")
    for m in (1, 100):
        g = CoarsestGraph(s, 1, m, 5e-2, 5, True)
        print(f"coarsest graph 4^4, m = {m}, zero right-hand side (every first loop test false):"
              f" {replay_ms(lambda: g(zero), reps=200):.4f} ms a call", flush=True)
        g.close()
    print(smi)


if __name__ == "__main__":
    main()
