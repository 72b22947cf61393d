"""The communicating operators of a sharded level (the JAX package's
wilson_sharded / coarse_sharded, ddalphaamg_tpu/parallel/shard_ops.py:
150-227):

  * fine full_op (and the Galerkin build's face hops, and method 4's
    parity hops): the local K1 / K2, which wraps every axis inside the
    slab, plus the half-spinor face corrections of parallel/soa_halo.py;
  * coarse full_op / hop: K5 on the slab with the faces of every split
    axis, t, z, y or x, received from the neighbor ranks (the coarse
    hopping exchange, src/coarse_oddeven_generic.c:447-583).

The fine operator posts its face exchanges first and runs K1 / K2 while
they travel (parallel/comm.exchange_start); K5 waits for its faces and
runs once: split into the tiles that read no face and the rest, it took
longer than one launch (PERF.md §6), and on nccl K8's transfers run
on the same stream as K5, so nothing would overlap them.

Every other stencil operator (block_op, self_op, self_inv, hop_intra) is
the local kernel with zero communication: Schwarz blocks divide the slab
(mesh.check_blocks), so each block-crossing coupling at a slab face is
already masked to zero and the local wrap reads data that is multiplied by
zero.  This mirrors the reference, whose Schwarz block solves are
process-local (src/schwarz_generic.c:312-645).
"""

from __future__ import annotations

from ..operators import cuda_coarse, cuda_dslash
from .comm import exchange_start, face
from .mesh import active_axes
from .soa_halo import faces_start


def wilson_full(mesh, links, cdiag, coff, v, lattice):
    """D v on one slab: the faces posted, K1 while they travel, then the
    face corrections."""
    faces = faces_start(mesh, links, v, lattice)
    return faces.finish(cuda_dslash.d_plus_clover(links, cdiag, coff, v, lattice))


def wilson_hopping(mesh, links, v, lattice, parity=None):
    """The hopping term on one slab: the faces posted, K2 while they
    travel, then the face corrections; with a parity, on the sites of that
    parity only (global parity)."""
    faces = faces_start(mesh, links, v, lattice)
    out = cuda_dslash.hopping(links, v, lattice, parity, mesh.parity(lattice))
    return faces.finish(out, parity)


def coarse_hops(mesh, Pk, v, lattice, terms):
    """Terms [k0, k1) of the coarse stencil on one slab through K5, with
    the faces of every split axis received from the neighbor ranks."""
    axes = active_axes(mesh, mesh.global_lattice(lattice))
    got = exchange_start(mesh, [(mu, face(v, lattice, mu, 0),
                                 face(v, lattice, mu, lattice[mu] - 1)) for mu in axes]).finish()
    return cuda_coarse.coarse_apply_halo(Pk, v, lattice, dict(zip(axes, got)), terms)
