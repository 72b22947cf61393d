"""Communication of the domain-decomposed solve: the stand-in for the JAX
package's lax.ppermute (face exchange), psum (reductions) and replicated
sharding (gathers, broadcasts), with one process per rank (the reference's
MPI shape).

The transport is an explicit choice of the caller, never a recovery from
a failure:

  "nccl"  one card per rank: every collective is kernel K8 over peer
          pointers (parallel/peer.Peers, opened by the grid's setup,
          parallel/launch.warm_up), in the host loops and in the device
          programs alike; the all-reduce sums in rank order, the same bits
          on every rank.  NCCL's process group only shares K8's IPC
          handles and meets the ranks at barriers.
  "gloo"  ranks that share a card (NCCL refuses two ranks on one device)
          and CPU runs: every tensor that crosses ranks is staged through
          host memory explicitly and copied back to its device.

Every function takes a mesh (parallel/mesh.SolverMesh) and is collective:
all ranks of the mesh call it in the same order with tensors of the same
shape.  Complex tensors travel as their real views.

A face exchange comes in two halves, so that the interior arithmetic runs
while the faces travel (the JAX package issues each direction's ppermute
apart from the interior work, its parallel/halo.py:1-19; the reference's
ghost_sendrecv then ghost_wait, src/dirac_generic.c:159-278):
exchange_start posts the sends and receives of every direction given and
returns an Exchange, whose finish() waits and returns the faces.  On nccl
K8's post kernel writes the faces into the receivers' memory and its
finish kernel, queued after the caller's kernels, waits for the
neighbors'; on gloo with faces on a card the faces are copied to pinned
host memory on a side stream, so that the copy, and the gloo transfer
posted at finish(), overlap the kernels the caller queued in between.
exchange is start and finish at once.

Captures: the device programs' loops are WHILE nodes, whose bodies can hold
K8 but not gloo's host transfers.  So a gloo collective called while the
current stream is captured raises; CAPTURED_TRANSPORTS names the
transports whose collectives a capture holds.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

TRANSPORTS = ("nccl", "gloo")
CAPTURED_TRANSPORTS = ("nccl",)     # whose collectives a graph's loop body holds (as K8)


class Comm:
    """A rank's communicator: the transport and the device its tensors
    live on (for NCCL, this rank's card)."""

    def __init__(self, transport: str, device):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
        self.transport = transport
        self.device = torch.device(device)
        self.peers = None       # parallel/peer.Peers on nccl, from the grid's setup

    def k8(self):
        """This rank's K8 peers (nccl)."""
        if self.peers is None:
            raise RuntimeError("an nccl grid's collectives run as K8, whose peers the "
                               "grid's setup opens (parallel/launch.warm_up)")
        return self.peers

    def stage(self, t: torch.Tensor) -> torch.Tensor:
        """A private contiguous copy of t in host memory (gloo)."""
        return t.detach().to("cpu", copy=True).contiguous()


def _real(t):
    return torch.view_as_real(t) if t.is_complex() else t


def _refuse_capture(c):
    """Raise where a gloo collective would be called under a CUDA capture
    (module note)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"a {c.transport} collective cannot be captured into a CUDA graph")


class Exchange:
    """The face exchanges of exchange_start under way: finish() waits for
    them and returns [(from_plus, from_minus)] in the order of the sends
    (module note)."""

    def __init__(self, mesh, sends):
        c = self.comm = mesh.comm
        self.sends = sends
        if c.transport == "nccl":
            self.posted = c.k8().post(sends)
            return
        _refuse_capture(c)
        # (slot, tag, send buffer, send peer, receive buffer, receive peer, device)
        self.plan = []
        self.slots = len(sends)
        self.event = None
        stage_async = False
        for i, (mu, to_minus, to_plus) in enumerate(sends):
            minus, plus = mesh.neighbor(mu, -1), mesh.neighbor(mu, +1)
            for k, t, dst, src in ((0, to_minus, minus, plus), (1, to_plus, plus, minus)):
                if t is not None:
                    stage_async |= t.device.type == "cuda"
                    self.plan.append([2 * i + k, 2 * mu + k, t, dst, None, src, t.device])
        if stage_async:
            self._stage_on_side_stream()
        else:
            for e in self.plan:
                e[2] = c.stage(e[2])
                e[4] = torch.empty_like(e[2])
        self.reqs = None
        if not stage_async:
            self._post()

    def _stage_on_side_stream(self):
        """gloo, faces on a card: copy them to pinned host buffers on a side
        stream that waits only for what the current stream queued so far."""
        dev = self.plan[0][6]
        side = _side_streams.get(dev)
        if side is None:
            side = _side_streams[dev] = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for e in self.plan:
                src = e[2].detach().contiguous()
                buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                buf.copy_(src, non_blocking=True)
                e[2], e[4] = (src, buf), torch.empty_like(buf, pin_memory=True)
            self.event = torch.cuda.Event()
            self.event.record(side)

    def _post(self):
        if self.event is not None:          # the side stream's copies have landed
            self.event.synchronize()
            for e in self.plan:
                e[2] = e[2][1]
        self.reqs = []
        for _, tag, send, dst, recv, src, _ in self.plan:
            self.reqs.append(dist.isend(_real(send), dst, tag=tag))
            self.reqs.append(dist.irecv(_real(recv), src, tag=tag))

    def finish(self) -> list:
        if self.comm.transport == "nccl":
            got = iter(self.comm.peers.finish(self.posted))
            return [(None if a is None else next(got), None if b is None else next(got))
                    for _, a, b in self.sends]
        if self.reqs is None:
            self._post()
        for r in self.reqs:
            r.wait()
        got = [None] * (2 * self.slots)
        for slot, _, _, _, recv, _, device in self.plan:
            got[slot] = recv.to(device, non_blocking=recv.is_pinned())
        self.plan = self.reqs = None
        return [(got[2 * i], got[2 * i + 1]) for i in range(self.slots)]


_side_streams: dict = {}        # gloo's staging stream of each card


def exchange_start(mesh, sends) -> Exchange:
    """Post the face exchanges sends = [(mu, to_minus, to_plus)]: to_minus
    goes to the -mu neighbor rank, to_plus to the +mu one (None: nothing).
    The returned Exchange's finish() gives [(from_plus, from_minus)]: what
    the +mu and -mu neighbors sent toward this rank, in the order of sends.
    A ring of two ranks, whose +mu and -mu neighbors coincide, keeps the two
    ways apart by K8's mailbox (nccl) or by tag (gloo)."""
    return Exchange(mesh, sends)


def exchange(mesh, mu: int, to_minus=None, to_plus=None):
    """exchange_start and finish of one direction: (from_plus, from_minus)."""
    return exchange_start(mesh, [(mu, to_minus, to_plus)]).finish()[0]


def face(v: torch.Tensor, lattice, mu: int, index: int) -> torch.Tensor:
    """The sites with coordinate `index` along mu of a field [*, V]:
    [*, V / lattice[mu]], lexicographic in the remaining coordinates."""
    w = v.reshape(*v.shape[:-1], *lattice)
    return w.select(w.dim() - 4 + mu, index).reshape(*v.shape[:-1], -1)


def exchange_faces(mesh, field: torch.Tensor, lattice, mu: int):
    """(fwd, bwd) faces of a slab field [*, V_l] along the sharded axis mu:
    fwd = the +mu neighbor's first mu slice (field(x + mu) for the last
    local slice), bwd = the -mu neighbor's last slice (field(x - mu) for the
    first local slice)."""
    n = lattice[mu]
    return exchange(mesh, mu, face(field, lattice, mu, 0),
                    face(field, lattice, mu, n - 1))


def all_reduce_sum(mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of t over all ranks (a new tensor on t's device).  Every rank
    receives the same bits, so branches on the result agree across ranks."""
    c = mesh.comm
    if c.transport == "nccl":
        return c.k8().allreduce(t)
    _refuse_capture(c)
    buf = c.stage(t)
    dist.all_reduce(_real(buf), op=dist.ReduceOp.SUM)
    return buf.to(t.device)


def all_reduce_max(mesh, value: float) -> float:
    """The largest of a host number over all ranks."""
    c = mesh.comm
    if c.transport == "nccl":
        t = torch.tensor([float(value)], dtype=torch.float64, device=c.device)
        return float(c.k8().allgather(t).max())
    buf = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    return float(buf[0])


def all_gather_lattice(mesh, x: torch.Tensor, lattice_local) -> torch.Tensor:
    """Slabs [*, V_l] of all ranks -> the global field [*, V] in lattice
    order (the inverse of mesh.shard_field)."""
    out = _gather(mesh, x)
    lead = tuple(x.shape[:-1])
    nl = len(lead)
    dt, dz, dy, dx = mesh.dims
    w = out.reshape(dt, dz, dy, dx, *lead, *lattice_local)
    # [Dt, Dz, Dy, Dx, *lead, Tl, Zl, Yl, Xl] -> [*lead, Dt, Tl, Dz, Zl, ...]
    perm = [*range(4, 4 + nl)]
    for mu in range(4):
        perm += [mu, 4 + nl + mu]
    return w.permute(perm).reshape(*lead, -1).contiguous()


def _gather(mesh, x):
    """[ranks, *x.shape]: every rank's x, on x's device."""
    c = mesh.comm
    if c.transport == "nccl":
        return c.k8().allgather(x.to(c.device)).to(x.device)
    _refuse_capture(c)
    buf = c.stage(x)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather([_real(p) for p in parts], _real(buf))
    return torch.stack(parts).to(x.device)


def broadcast(mesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's t on every rank."""
    c = mesh.comm
    if c.transport == "nccl":
        return _gather(mesh, t)[0]
    buf = c.stage(t)
    dist.broadcast(_real(buf), 0)
    return buf.to(t.device)
