"""Communication of the domain-decomposed solve: the stand-in for the JAX
package's lax.ppermute (face exchange), psum (reductions) and replicated
sharding (gathers, broadcasts), on torch.distributed with one process per
rank (the reference's MPI shape).

The transport is an explicit choice of the caller, never a recovery from
a failure:

  "nccl"  one card per rank: tensors move card to card (batch_isend_irecv,
          all_reduce, all_gather_into_tensor, broadcast).
  "gloo"  ranks that share a card (NCCL refuses two ranks on one device)
          and CPU runs: every tensor that crosses ranks is staged through
          host memory explicitly and copied back to its device.

Every function takes a mesh (parallel/mesh.SolverMesh) and is collective:
all ranks of the mesh call it in the same order with tensors of the same
shape.  Complex tensors travel as their real views.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

TRANSPORTS = ("nccl", "gloo")


class Comm:
    """A rank's communicator: the transport and the device its tensors
    live on (for NCCL, this rank's card)."""

    def __init__(self, transport: str, device):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
        self.transport = transport
        self.device = torch.device(device)

    def stage(self, t: torch.Tensor) -> torch.Tensor:
        """A private contiguous copy of t where the transport reads it."""
        where = "cpu" if self.transport == "gloo" else t.device
        return t.detach().to(where, copy=True).contiguous()


def _real(t):
    return torch.view_as_real(t) if t.is_complex() else t


def exchange(mesh, mu: int, to_minus=None, to_plus=None):
    """Send to_minus to the -mu neighbor rank and to_plus to the +mu one.
    Returns (from_plus, from_minus): what the +mu and -mu neighbors sent
    toward this rank (None where nothing was sent).  All sends and receives
    form one batch issued in the same order on every rank, so a ring of two
    ranks, whose +mu and -mu neighbors coincide, matches them by order
    (NCCL) or by tag (gloo)."""
    c = mesh.comm
    minus, plus = mesh.neighbor(mu, -1), mesh.neighbor(mu, +1)
    plan = []    # (tag, send buffer, send peer, receive buffer, receive peer)
    for tag, t, dst, src in ((0, to_minus, minus, plus), (1, to_plus, plus, minus)):
        if t is not None:
            buf = c.stage(t)
            plan.append((tag, buf, dst, torch.empty_like(buf), src))
    if c.transport == "nccl":
        ops = []
        for _, send, dst, recv, src in plan:
            ops.append(dist.P2POp(dist.isend, _real(send), dst))
            ops.append(dist.P2POp(dist.irecv, _real(recv), src))
        reqs = dist.batch_isend_irecv(ops) if ops else []
    else:
        reqs = []
        for tag, send, dst, recv, src in plan:
            reqs.append(dist.isend(_real(send), dst, tag=tag))
            reqs.append(dist.irecv(_real(recv), src, tag=tag))
    for r in reqs:
        r.wait()
    got = {tag: recv for tag, _, _, recv, _ in plan}
    device = (to_minus if to_minus is not None else to_plus).device
    return tuple(got[tag].to(device) if tag in got else None for tag in (0, 1))


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
    buf = c.stage(t)
    dist.all_reduce(_real(buf), op=dist.ReduceOp.SUM)
    return buf.to(t.device)


def all_reduce_max(mesh, value: float) -> float:
    """The largest of a host number over all ranks."""
    c = mesh.comm
    where = "cpu" if c.transport == "gloo" else c.device
    buf = torch.tensor([float(value)], dtype=torch.float64, device=where)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    return float(buf[0])


def all_gather_lattice(mesh, x: torch.Tensor, lattice_local) -> torch.Tensor:
    """Slabs [*, V_l] of all ranks -> the global field [*, V] in lattice
    order (the inverse of mesh.shard_field)."""
    c = mesh.comm
    buf = c.stage(x)
    if c.transport == "nccl":
        out = torch.empty((mesh.size, *buf.shape), dtype=buf.dtype, device=buf.device)
        dist.all_gather_into_tensor(_real(out), _real(buf))
    else:
        parts = [torch.empty_like(buf) for _ in range(mesh.size)]
        dist.all_gather([_real(p) for p in parts], _real(buf))
        out = torch.stack(parts)
    out = out.to(x.device)
    lead = tuple(x.shape[:-1])
    nl = len(lead)
    dt, dz, dy, dx = mesh.dims
    w = out.reshape(dt, dz, dy, dx, *lead, *lattice_local)
    # [Dt, Dz, Dy, Dx, *lead, Tl, Zl, Yl, Xl] -> [*lead, Dt, Tl, Dz, Zl, ...]
    perm = [*range(4, 4 + nl)]
    for mu in range(4):
        perm += [mu, 4 + nl + mu]
    return w.permute(perm).reshape(*lead, -1).contiguous()


def broadcast(mesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's t on every rank."""
    buf = mesh.comm.stage(t)
    dist.broadcast(_real(buf), 0)
    return buf.to(t.device)
