"""A cell on a process grid (harness.Cell.grid): one rank a card, each a
process spawned by the port's parallel/launch.run_ranks over nccl (gloo on
the CPU, in the tests), each running harness.run_cell with its mesh.  The
process that spawns them builds the port's kernels first, so the ranks
only load them, and prints the result: rank 0's.  Ranks print nothing on
standard output.
"""

from __future__ import annotations

import math
import os

import torch

from . import harness


def _rank(mesh, device, name: str, root: str, seed: int, seconds: float, traced: bool,
          started: float, threads: int) -> dict:
    """One rank's run (parallel/launch.run_ranks calls it): its
    run_cell's return, with the banned modules it loaded."""
    torch.set_num_threads(threads)
    cell = harness.load_cell(name, root)
    res = harness.run_cell(cell, seed, seconds, traced, device, started, mesh)
    res["banned"] = harness.banned_modules()
    return res


def run(cell: harness.Cell, root, seed: int, seconds: float, traced: bool, started: float,
        device_type: str = "cuda", rank=_rank) -> list:
    """Every rank's return of `rank` (rank 0's first, with the result),
    rank r on cuda:r over nccl (device_type "cpu": gloo ranks on the CPU),
    each with PyTorch's CPU threads shared out; `rank` takes _rank's
    arguments (the tests plant faults through it)."""
    from ddalphaamg_tpu_torch import kernels
    from ddalphaamg_tpu_torch.parallel import launch

    world = math.prod(cell.grid)
    if device_type == "cuda":
        kernels.build()             # once, before the ranks load it
        transport, devices = "nccl", [f"cuda:{r}" for r in range(world)]
    else:
        transport, devices = "gloo", [device_type] * world
    threads = max(1, (os.cpu_count() or 1) // world)
    return launch.run_ranks(rank, cell.grid, transport, devices, cell.name, str(root), seed,
                            seconds, traced, started, threads)
