"""Galerkin coarse-grid operator D_c = P^H D P.

Reference: coarse_operator_PRECISION_setup + set_coarse_self/neighbor_coupling
(src/coarse_operator_generic.c:53-205).  The level operator is split by
aggregate locality,

    D = D_intra + sum_mu (D_cross_fwd,mu + D_cross_bwd,mu),

each piece is applied to all 2N assembled basis vectors B_j = P e_j at once
(one batched stencil apply), and the result is restricted:

    A(x)      column j = P_x^H (D_intra B_j)|_x
    Df_mu(x)  column j = P_x^H (D_cross_fwd,mu B_j)|_x    (x <- x + mu)
    Db_mu(x)  column j = P_x^H (D_cross_bwd,mu B_j)|_x    (x <- x - mu)

B_j lives on single aggregates and each piece maps between fixed aggregate
pairs, so every restriction isolates exactly one coupling block.

On the fine level the pieces run through the batched kernels: D_intra is K1
with the links masked to aggregate-internal hops, and for each direction K2
with only the face-crossing links of that direction gives both crossings at
once -- the forward one lands on upper-face sites, the backward one on
lower-face sites, and the two are separated by masking the output (which
needs aggregates at least 2 sites wide).  On coarse levels D_intra is K4
with the aggregate as its mask block, and the single-direction crossings are
plain rolls and batched contractions.

On a sharded level (a stencil with a mesh) aggregates divide the slab, so
A is local; a face crossing can leave the slab, so the fine crossings add
the half-spinor face corrections to K2 (parallel/shard_ops.wilson_hopping)
and the coarse ones shift the 2N basis fields across ranks
(parallel/halo.halo_exchange_shift).  The result is this rank's slab of
the coarse operator; gather_blocks() assembles the whole of it on every
rank for a replicated next level.

The restriction of basis field j is column j of every block, i.e. row j of
the packed layout [9, d (j), d (i), Vc] that K4 reads, so the blocks are
written there directly, and the basis fields can run in chunks of columns
(`chunk`): at 32^4 with 2N = 56 one piece's images are 5.6 GB, and the
packed result alone 14.8 GB.
"""

from __future__ import annotations

import numpy as np
import torch

from ..operators import cuda_coarse, cuda_dslash
from ..operators.coarse import CoarseOperator, neighbor
from ..operators.stencil import CoarseStencilSoA, WilsonStencilSoA
from ..parallel.halo import halo_exchange_shift
from ..parallel.mesh import gather_field
from ..parallel.shard_ops import wilson_hopping
from .interpolation import Aggregation, assemble_basis, restrict


def _face_masks(lattice, coarsening, offsets=(0, 0, 0, 0)) -> tuple[np.ndarray, np.ndarray]:
    """(upper, lower) aggregate-face masks [4, V] of a lattice (or slab)
    whose site 0 sits at the global coordinates `offsets`."""
    up, lo = [], []
    for mu in range(4):
        coord = np.arange(lattice[mu]) + offsets[mu]
        shape = [1, 1, 1, 1]
        shape[mu] = lattice[mu]
        u = ((coord % coarsening[mu]) == (coarsening[mu] - 1)).reshape(shape)
        l = ((coord % coarsening[mu]) == 0).reshape(shape)
        up.append(np.broadcast_to(u, lattice))
        lo.append(np.broadcast_to(l, lattice))
    return (np.stack(up).reshape(4, -1).astype(np.float64),
            np.stack(lo).reshape(4, -1).astype(np.float64))


def build_coarse_blocks(stencil, agg: Aggregation, P: torch.Tensor,
                        chunk=None, out=None) -> torch.Tensor:
    """D_c = P^H D P for the operator of a fine or coarse stencil (in the
    stencil's precision), packed [9, d (j), d (i), Vc] as K4 reads it, into
    out if given (a tensor of that shape and dtype); the 2N basis fields
    run `chunk` at a time (None: all at once)."""
    if min(agg.coarsening) < 2:
        raise ValueError("the Galerkin build separates forward and backward "
                         "face couplings by site; aggregates must be at least "
                         f"2 wide, got {agg.coarsening}")
    n = 2 * agg.num_vectors
    chunk = chunk or n
    lat = tuple(agg.fine_lattice)
    mesh = stencil.mesh
    up, lo = _face_masks(lat, agg.coarsening, stencil.offsets)
    rdtype = stencil.even.dtype
    up = torch.as_tensor(up, dtype=rdtype, device=P.device)
    lo = torch.as_tensor(lo, dtype=rdtype, device=P.device)
    shape = (9, n, n, P.shape[0])
    if out is not None and (out.shape != shape or out.dtype != stencil.dtype):
        raise ValueError(f"out is {tuple(out.shape)} {out.dtype}, the blocks {shape} "
                         f"{stencil.dtype}")
    Pk = torch.empty(shape, dtype=stencil.dtype, device=P.device) if out is None else out
    fine = isinstance(stencil, WilsonStencilSoA)
    if not fine and not isinstance(stencil, CoarseStencilSoA):
        raise TypeError(type(stencil))
    if fine:
        links = stencil.links
        intra = (links * (1.0 - up)[:, None, None]).contiguous()
        faces = []
        for mu in range(4):
            face = torch.zeros_like(links)
            face[mu] = links[mu] * up[mu]
            faces.append(face)
    for j0 in range(0, n, chunk):
        cols = slice(j0, min(n, j0 + chunk))
        B = assemble_basis(agg, P, range(n)[cols]).to(stencil.dtype)
        if fine:
            Pk[0, cols] = restrict(agg, P, cuda_dslash.d_plus_clover(
                intra, stencil.cdiag, stencil.coff, B, lat))
            for mu in range(4):
                if mesh is None:
                    hop = cuda_dslash.hopping(faces[mu], B, lat)
                else:
                    hop = wilson_hopping(mesh, faces[mu], B, lat)
                Pk[1 + mu, cols] = restrict(agg, P, hop * up[mu])
                Pk[5 + mu, cols] = restrict(agg, P, hop * lo[mu])
                del hop
        else:
            Pk[0, cols] = restrict(agg, P, cuda_coarse.coarse_apply(
                stencil.Pk, B, lat, (0, 9), mask_block=tuple(agg.coarsening)))
            for mu in range(4):
                for k, mask in ((1 + mu, up[mu]), (5 + mu, lo[mu])):
                    if mesh is None:
                        w = neighbor(B, k, lat) * mask
                    else:
                        w = halo_exchange_shift(mesh, B, -1 if k < 5 else 1, mu, lat) * mask
                    Pk[k, cols] = restrict(agg, P, torch.einsum("jix,bjx->bix",
                                                                stencil.Pk[k], w))
        del B
    return Pk


def build_coarse_operator(stencil, agg: Aggregation, P: torch.Tensor) -> CoarseOperator:
    """build_coarse_blocks as site-major blocks (the JAX package's form)."""
    Pk = build_coarse_blocks(stencil, agg, P)
    return CoarseOperator(A=Pk[0].permute(2, 1, 0).contiguous(),
                          Df=Pk[1:5].permute(0, 3, 2, 1).contiguous(),
                          Db=Pk[5:9].permute(0, 3, 2, 1).contiguous())


def gather_blocks(mesh, Pk: torch.Tensor, lattice_local) -> torch.Tensor:
    """The whole packed coarse operator [9, d, d, V] on every rank from each
    rank's slab of it [9, d, d, V_l] (the replicated coarsest level's
    assembly)."""
    return gather_field(mesh, Pk, lattice_local).contiguous()
