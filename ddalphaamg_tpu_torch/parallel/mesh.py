"""The process grid of the domain-decomposed solve and the slab helpers.

Reference analog: cart_define / neighbor_define (src/ghost.c:24-72) build
the 4D MPI process grid from global/local lattice ratios; the JAX package
(ddalphaamg_tpu/parallel/mesh.py) builds a jax Mesh with axes
("t", "z", "y", "x").  Here a SolverMesh is one rank's view of that grid:
its extents, its rank (row-major over (t, z, y, x), x fastest, as the JAX
package lays out its devices), its coordinates and neighbors, and the
communicator of parallel/comm.py.

A sharded level holds on each rank a slab: its [T_l, Z_l, Y_l, X_l] block
of the global lattice, in the dof-major layout [*, dof, V_l] of every level
(sites lexicographic, x fastest), so any of the four axes may be split: a
y or x slab is cut like a t or z slab.  An axis is split where the mesh
extent is above 1 and divides the lattice (the JAX package's per-axis
rule, its parallel/mesh.py:108-113, which shards every axis of its logical
layout); a level is sharded only when every split axis divides its
lattice, other levels are replicated (every rank holds the whole level).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import comm

AXES = ("t", "z", "y", "x")


def factor_devices(n: int, lattice=None) -> tuple:
    """Split n ranks into 4 mesh extents (t, z, y, x), preferring extents
    that divide the lattice (the JAX package's factor_devices)."""
    dims = [1, 1, 1, 1]
    i = 0
    while n > 1:
        for p in (2, 3, 5, 7):
            if n % p == 0:
                for k in range(4):
                    ax = (i + k) % 4
                    if lattice is None or lattice[ax] % (dims[ax] * p) == 0:
                        dims[ax] *= p
                        i = ax + 1
                        break
                else:
                    dims[i % 4] *= p
                    i += 1
                n //= p
                break
        else:
            dims[i % 4] *= n
            n = 1
    return tuple(dims)


@dataclasses.dataclass(eq=False)
class SolverMesh:
    """One rank's view of the process grid.  comm (parallel/comm.Comm) is
    None for a mesh that only slices (tests, conversions)."""

    dims: tuple
    rank: int = 0
    comm: object = None

    def __post_init__(self):
        self.dims = tuple(int(d) for d in self.dims)
        if len(self.dims) != 4 or min(self.dims) < 1:
            raise ValueError(f"mesh extents must be 4 positive ints, got {self.dims}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of {self.size}")

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def coords(self) -> tuple:
        return tuple(int(c) for c in np.unravel_index(self.rank, self.dims))

    def neighbor(self, mu: int, step: int) -> int:
        """Rank of the neighbor step (+1 / -1) along axis mu (periodic)."""
        c = list(self.coords)
        c[mu] = (c[mu] + step) % self.dims[mu]
        return int(np.ravel_multi_index(c, self.dims))

    def divides(self, lattice) -> bool:
        """True when every split axis divides the lattice (it can shard)."""
        return all(lattice[mu] % self.dims[mu] == 0 for mu in range(4))

    def global_lattice(self, local) -> tuple:
        return tuple(local[mu] * self.dims[mu] for mu in range(4))

    def offsets(self, local) -> tuple:
        """Global coordinates of the slab's site 0."""
        return tuple(self.coords[mu] * local[mu] for mu in range(4))

    @property
    def splits_yx(self) -> bool:
        """True where the grid splits y or x (the JAX package runs its
        logical layouts there, with no bf16 coarse blocks)."""
        return self.dims[2] > 1 or self.dims[3] > 1

    def parity(self, local) -> int:
        """Parity of the slab's global offset: (t0 + z0 + y0 + x0) & 1."""
        return sum(self.offsets(local)) & 1


def make_solver_mesh(n_devices: int | None = None, dims=None, lattice=None,
                     rank: int = 0, comm=None) -> SolverMesh:
    """The process grid from explicit extents (an ini's global / local
    lattice) or from a rank count."""
    if dims is None:
        dims = factor_devices(n_devices, lattice)
    return SolverMesh(tuple(dims), rank, comm)


def active_axes(mesh, lattice) -> tuple:
    """The axes along which a level of this lattice is split."""
    return tuple(mu for mu in range(4)
                 if mesh.dims[mu] > 1 and lattice[mu] % mesh.dims[mu] == 0)


def local_lattice(mesh, lattice) -> tuple:
    return tuple(lattice[mu] // mesh.dims[mu] if mu in active_axes(mesh, lattice)
                 else lattice[mu] for mu in range(4))


def check_blocks(mesh, lattice, block, what: str = "Schwarz block"):
    """Blocks (Schwarz blocks, aggregates) must divide the slab, so that
    every block-restricted operator and every aggregate stays on one rank
    (the JAX package's assertion, parallel/mesh.py:146-160)."""
    loc = local_lattice(mesh, lattice)
    if any(block[mu] > 1 and loc[mu] % block[mu] for mu in range(4)):
        raise ValueError(f"{what} {tuple(block)} does not divide the local "
                         f"lattice {loc} (mesh {mesh.dims}): block ops would "
                         "cross ranks")


def shard_field(mesh, v: torch.Tensor, lattice) -> torch.Tensor:
    """This rank's slab of a global field [*, V] (sites last; any leading
    axes, e.g. a stack of test vectors): [*, V_l]."""
    lattice = tuple(lattice)
    if not mesh.divides(lattice):
        raise ValueError(f"mesh {mesh.dims} does not divide lattice {lattice}")
    loc = local_lattice(mesh, lattice)
    off = mesh.offsets(loc)
    w = v.reshape(*v.shape[:-1], *lattice)
    for mu in active_axes(mesh, lattice):
        w = w.narrow(w.dim() - 4 + mu, off[mu], loc[mu])
    return w.reshape(*v.shape[:-1], -1).contiguous()


def shard_interpolation(mesh, P: torch.Tensor, coarse_lattice) -> torch.Tensor:
    """This rank's rows of an interpolation [Vc, 2, N, m] (sites first)."""
    return shard_field(mesh, P.movedim(0, -1), coarse_lattice).movedim(-1, 0).contiguous()


def shard_operator(mesh, op):
    """This rank's slab of a logical Wilson operator (links [4, T, Z, Y, X,
    3, 3], clover [T, Z, Y, X, 2, 6, 6]), same type."""
    lattice = tuple(op.links.shape[1:5])
    if not mesh.divides(lattice):
        raise ValueError(f"mesh {mesh.dims} does not divide lattice {lattice}")
    loc = local_lattice(mesh, lattice)
    off = mesh.offsets(loc)
    links, clover = op.links, op.clover
    for mu in active_axes(mesh, lattice):
        links = links.narrow(1 + mu, off[mu], loc[mu])
        clover = clover.narrow(mu, off[mu], loc[mu])
    return type(op)(links.contiguous(), clover.contiguous())


def gather_field(mesh, v: torch.Tensor, lattice_local) -> torch.Tensor:
    """The global field [*, V] from every rank's slab [*, V_l] (the inverse
    of shard_field), on every rank."""
    return comm.all_gather_lattice(mesh, v, tuple(lattice_local))


def replicate(mesh, v: torch.Tensor) -> torch.Tensor:
    """Rank 0's copy of a replicated tensor on every rank (the JAX
    package's replicated sharding)."""
    return comm.broadcast(mesh, v)
