#!/usr/bin/env python
"""Probe the design of the coarsest GCR's CUDA graph on one CUDA card:

    python3 scripts/probe_torch_graph.py

1. torch's version, and whether torch.cuda.CUDAGraph offers conditional
   nodes (begin_capture_to_if_node).
2. The device memory a capture reserves for k GCR iterations (k nested IF
   bodies of solvers.device_gmres.gcr_program, one restart) on a random
   4^4 coarse stencil with d = 56 at batch 28, every body captured on the
   capture stream (csrc/graph.cu), for k = 4 and 16: the difference over
   12 is the bytes a body.
3. What an IF node whose predicate is false costs: the replay time of the
   coarsest GCR (mg.coarsest.CoarsestGraph, m = 100) on a zero right-hand
   side, where the first predicate is false, beside m = 1; and of 100 IF
   nodes in sequence, each false, beside 1.
Prints one line per item and the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ddalphaamg_tpu_torch import kernels  # noqa: E402
from ddalphaamg_tpu_torch.geometry import Geometry  # noqa: E402
from ddalphaamg_tpu_torch.mg.coarsest import CoarsestGraph  # noqa: E402
from ddalphaamg_tpu_torch.operators.stencil import CoarseStencilSoA, schur  # noqa: E402
from ddalphaamg_tpu_torch.solvers.cuda_graph import CudaGraph  # noqa: E402
from ddalphaamg_tpu_torch.solvers.device_gmres import gcr_program  # noqa: E402

LAT, D, BATCH = (4, 4, 4, 4), 56, 28


def stencil(gen):
    V = 256
    Pk = torch.randn((9, D, D, V), generator=gen, dtype=torch.complex64, device="cuda")
    Pk[0] *= 0.05
    Pk[0] += torch.eye(D, dtype=Pk.dtype, device="cuda")[:, :, None]
    Pk[1:] *= 0.027
    return CoarseStencilSoA.from_blocks(Pk, Geometry(LAT, (2, 2, 2, 2)))


def reserved_by(capture):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    keep = capture()
    torch.cuda.synchronize()
    return torch.cuda.memory_reserved() - r0, keep


def ours(s, b, k):
    g = CudaGraph("cuda")
    g.capture(lambda ctl: gcr_program(ctl, lambda v: schur(s, v), b, k, 5e-2))
    return g


def replay_ms(launch, reps=200):
    launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        launch()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


class Sequential(CudaGraph):
    """IF nodes in sequence, each closed before the next opens."""

    def chain(self, m, pred, body):
        for j in range(m):
            self._node(pred())
            body(j)
            self._close()


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    api = hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; torch.cuda.CUDAGraph."
          f"begin_capture_to_if_node: {'present' if api else 'absent'}", flush=True)
    kernels.lib()
    gen = torch.Generator(device="cuda").manual_seed(1)
    s = stencil(gen)
    b = torch.randn((BATCH, D, 256), generator=gen, dtype=torch.complex64, device="cuda")
    r4, g4 = reserved_by(lambda: ours(s, b, 4))
    r16, g16 = reserved_by(lambda: ours(s, b, 16))
    print(f"csrc/graph.cu, nested: capture of 4 / 16 iterations reserved {r4} / {r16} bytes: "
          f"{(r16 - r4) / 12:.0f} bytes an iteration", flush=True)
    del g4, g16
    torch.cuda.empty_cache()
    zero = torch.zeros_like(b[:1])
    for m in (1, 100):
        g = CoarsestGraph(s, 1, m, 5e-2, 5, True)
        ms = replay_ms(lambda: g(zero))
        print(f"coarsest graph, m = {m}, zero right-hand side (every first IF false): "
              f"{ms:.4f} ms a call", flush=True)
    for m in (1, 100):
        g = Sequential("cuda")
        g.capture(lambda ctl: gcr_program(ctl, lambda v: schur(s, v), zero, m, 5e-2))
        ms = replay_ms(g.launch)
        print(f"{m} IF nodes in sequence, all false: {ms:.4f} ms a replay", flush=True)
    print(smi)


if __name__ == "__main__":
    main()
