"""Starting the ranks of a domain-decomposed run.

  * from_environment: inside torchrun (RANK, WORLD_SIZE, LOCAL_RANK and the
    rendezvous address in the environment), as the command line does;
  * run_ranks: spawn the ranks of a mesh from one Python process with the
    "spawn" start method (the smoke run and the tests), each with its own
    process group over a file store in a private temporary directory.

The transport is the caller's choice (parallel/comm.py): "nccl" needs one
card per rank; "gloo" lets ranks share a card or run on the CPU.  On nccl
the ranks open each other's K8 arenas here (warm_up, parallel/peer.py),
before any CUDA graph is captured.
"""

from __future__ import annotations

import datetime
import math
import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .comm import Comm
from .mesh import make_solver_mesh

TIMEOUT = datetime.timedelta(minutes=15)


def _init(transport, device, init_method, rank, world) -> Comm:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif transport == "nccl":
        raise ValueError("the nccl transport needs a CUDA device per rank")
    # nccl: bind the rank's card now, on which the K8 arenas' IPC handles
    # are shared (parallel/peer.Peers)
    dist.init_process_group(transport, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT,
                            device_id=device if transport == "nccl" else None)
    return Comm(transport, device)


def warm_up(mesh):
    """On nccl: give the Comm its peers (parallel/peer.Peers: K8, which
    carries every collective of the grid and which the captured loop
    bodies hold), before any CUDA graph is captured.  Nothing on gloo."""
    from .peer import Peers

    c = mesh.comm
    if c is None or c.transport != "nccl":
        return
    c.peers = Peers(mesh, c.device)


def from_environment(dims, transport: str, device_type: str = "cuda"):
    """(mesh, device) of this torchrun rank: cuda:LOCAL_RANK with "nccl";
    with "gloo", ranks beyond the card count share cards round-robin."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(f"the process grid {tuple(dims)} needs one process per "
                           "rank: start them with torchrun --nproc-per-node=N")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != math.prod(dims):
        raise ValueError(f"the ini's process grid {tuple(dims)} needs "
                         f"{math.prod(dims)} ranks, torchrun started {world}")
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device_type == "cuda":
        n = torch.cuda.device_count()
        if transport == "nccl" and local >= n:
            raise ValueError(f"nccl needs a card per rank: local rank {local}, "
                             f"{n} cards (use --transport gloo to share cards)")
        device = torch.device("cuda", local % max(n, 1))
    else:
        device = torch.device(device_type)
    comm = _init(transport, device, "env://", rank, world)
    mesh = make_solver_mesh(dims=dims, rank=rank, comm=comm)
    warm_up(mesh)
    return mesh, device


def _rank_main(rank, fn, dims, transport, devices, tmp, args):
    comm = _init(transport, devices[rank], f"file://{tmp}/store", rank,
                 math.prod(dims))
    try:
        mesh = make_solver_mesh(dims=dims, rank=rank, comm=comm)
        warm_up(mesh)
        result = fn(mesh, torch.device(devices[rank]), *args)
        if comm.peers is not None:      # every rank done with the arenas, then freed
            torch.cuda.synchronize(comm.device)
            dist.barrier()
            comm.peers.close()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, dims, transport: str, devices, *args) -> list:
    """Run fn(mesh, device, *args) on every rank of a mesh with extents dims,
    rank r on devices[r], in spawned processes; returns the ranks' results.
    fn must be importable by the children (a module-level function); a
    failure on any rank stops the others and raises here."""
    world = math.prod(dims)
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got {devices}")
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(fn, tuple(dims), transport,
                                             [str(d) for d in devices], tmp, args),
                           nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
