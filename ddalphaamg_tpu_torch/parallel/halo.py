"""Periodic neighbor shift of slab fields across ranks (the JAX package's
halo_exchange_shift, ddalphaamg_tpu/parallel/halo.py:60-80; reference
ghost_sendrecv, src/ghost_generic.c:171-345).  Only the one-site face
crosses ranks; unsplit axes roll inside the slab.  The Galerkin build of a
sharded coarse level reads its neighbor basis fields through it; each
shift is comm.exchange, the post and the finish at once (nothing to
overlap: the shifted field is all the build reads next): K8 on nccl
(parallel/peer.py, one way only, as a ring's shift is), gloo else."""

from __future__ import annotations

import torch

from ..operators.coarse import neighbor
from .comm import exchange, face
from .mesh import active_axes


def halo_exchange_shift(mesh, x: torch.Tensor, shift: int, mu: int, lattice):
    """x(site - shift * mu) for a slab field [*, V_l]: shift = -1 fetches
    the +mu neighbor x(site + mu) (a local roll(x, -1, mu)), shift = +1 the
    -mu neighbor.  Collective over the mesh when mu is split."""
    if shift not in (-1, 1):
        raise ValueError(shift)
    lattice = tuple(lattice)
    k = 1 + mu if shift == -1 else 5 + mu
    if mu not in active_axes(mesh, lattice):
        return neighbor(x, k, lattice)
    n = lattice[mu]
    if shift == -1:      # my first slice -> the -mu neighbor
        fwd, _ = exchange(mesh, mu, to_minus=face(x, lattice, mu, 0))
        return neighbor(x, k, lattice, {mu: (fwd, None)})
    _, bwd = exchange(mesh, mu, to_plus=face(x, lattice, mu, n - 1))
    return neighbor(x, k, lattice, {mu: (None, bwd)})
