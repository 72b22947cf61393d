"""Lattice geometry of one multigrid level (numpy only).

Sites live in dense arrays indexed [T, Z, Y, X, ...] (X fastest).  Block
(Schwarz) and aggregate views are pure reshapes/transposes; parities are
masks.  Anti-periodic time signs are baked into the links at load time, so
neighbor access is periodic.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

T, Z, Y, X = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Geometry of one multigrid level.

    lattice:  global lattice extents (T, Z, Y, X)
    block:    Schwarz block extents per dimension (reference `block_lattice`)
    dof:      degrees of freedom per site (12 = 4 spin x 3 color on the fine
              grid; 2 * num_test_vectors on coarse grids)
    """

    lattice: tuple[int, int, int, int]
    block: tuple[int, int, int, int] = (2, 2, 2, 2)
    dof: int = 12

    def __post_init__(self):
        for mu in range(4):
            if self.block[mu] > 0 and self.lattice[mu] % self.block[mu] != 0:
                raise ValueError(
                    f"lattice {self.lattice} not divisible by block {self.block} in dim {mu}"
                )

    @cached_property
    def num_sites(self) -> int:
        return int(np.prod(self.lattice))

    @cached_property
    def vector_size(self) -> int:
        return self.num_sites * self.dof

    @cached_property
    def block_grid(self) -> tuple[int, int, int, int]:
        """Number of Schwarz blocks per dimension."""
        return tuple(self.lattice[mu] // self.block[mu] for mu in range(4))

    @cached_property
    def num_blocks(self) -> int:
        return int(np.prod(self.block_grid))

    @cached_property
    def block_volume(self) -> int:
        return int(np.prod(self.block))

    # ----- parity masks -----

    @cached_property
    def site_parity(self) -> np.ndarray:
        """int8 [T,Z,Y,X]; 0 = even, 1 = odd ((t+z+y+x) % 2, cf. src/dirac.c:625-643)."""
        t, z, y, x = np.ix_(*[np.arange(n) for n in self.lattice])
        return ((t + z + y + x) % 2).astype(np.int8)

    @cached_property
    def block_parity(self) -> np.ndarray:
        """int8 [Tb,Zb,Yb,Xb]; red/black coloring of the Schwarz block grid."""
        t, z, y, x = np.ix_(*[np.arange(n) for n in self.block_grid])
        return ((t + z + y + x) % 2).astype(np.int8)

    # ----- block <-> lattice reshapes -----
    # A field [T,Z,Y,X, d] reshapes to [Tb,bt, Zb,bz, Yb,by, Xb,bx, d] and then
    # transposes to [Tb,Zb,Yb,Xb, bt,bz,by,bx, d]: the leading 4 axes are a
    # batch of blocks -- all same-color blocks become one batched kernel call.

    def to_blocks(self, field: np.ndarray) -> np.ndarray:
        """[T,Z,Y,X, *rest] -> [Nblocks, block_volume, *rest] (block batch view)."""
        gt, gz, gy, gx = self.block_grid
        bt, bz, by, bx = self.block
        rest = field.shape[4:]
        out = field.reshape(gt, bt, gz, bz, gy, by, gx, bx, *rest)
        out = out.transpose(0, 2, 4, 6, 1, 3, 5, 7, *range(8, 8 + len(rest)))
        return out.reshape(self.num_blocks, self.block_volume, *rest)

    def from_blocks(self, blocks: np.ndarray) -> np.ndarray:
        """Inverse of to_blocks."""
        gt, gz, gy, gx = self.block_grid
        bt, bz, by, bx = self.block
        rest = blocks.shape[2:]
        out = blocks.reshape(gt, gz, gy, gx, bt, bz, by, bx, *rest)
        out = out.transpose(0, 4, 1, 5, 2, 6, 3, 7, *range(8, 8 + len(rest)))
        return out.reshape(*self.lattice, *rest)

    def coarse_geometry(
        self,
        coarsening: tuple[int, int, int, int],
        num_test_vectors: int,
        block: tuple[int, int, int, int] | None = None,
    ) -> "Geometry":
        """Geometry of the next-coarser level given aggregate extents."""
        cl = tuple(self.lattice[mu] // coarsening[mu] for mu in range(4))
        for mu in range(4):
            if self.lattice[mu] % coarsening[mu] != 0:
                raise ValueError(f"coarsening {coarsening} does not divide {self.lattice}")
        if block is None:
            block = tuple(2 if cl[mu] % 2 == 0 and cl[mu] > 1 else 1 for mu in range(4))
        return Geometry(lattice=cl, block=block, dof=2 * num_test_vectors)
