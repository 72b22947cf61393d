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
the coarse operator; gather() assembles the whole of it on every rank for
a replicated next level.
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


def _columns(agg, P, fields) -> torch.Tensor:
    """Restricted basis images [2N, dof, V] -> blocks [Vc, 2N (row), 2N (col)]."""
    return restrict(agg, P, fields).permute(2, 1, 0)


def build_coarse_operator(stencil, agg: Aggregation, P: torch.Tensor) -> CoarseOperator:
    """D_c = P^H D P for the operator of a fine or coarse stencil (in the
    stencil's precision)."""
    if min(agg.coarsening) < 2:
        raise ValueError("the Galerkin build separates forward and backward "
                         "face couplings by site; aggregates must be at least "
                         f"2 wide, got {agg.coarsening}")
    B = assemble_basis(agg, P).to(stencil.dtype)
    lat = tuple(agg.fine_lattice)
    mesh = stencil.mesh
    up, lo = _face_masks(lat, agg.coarsening, stencil.offsets)
    rdtype = stencil.even.dtype
    up = torch.as_tensor(up, dtype=rdtype, device=B.device)
    lo = torch.as_tensor(lo, dtype=rdtype, device=B.device)
    if isinstance(stencil, WilsonStencilSoA):
        links = stencil.links
        intra = (links * (1.0 - up)[:, None, None]).contiguous()
        A = _columns(agg, P, cuda_dslash.d_plus_clover(
            intra, stencil.cdiag, stencil.coff, B, lat))
        Df, Db = [], []
        for mu in range(4):
            face = torch.zeros_like(links)
            face[mu] = links[mu] * up[mu]
            if mesh is None:
                hop = cuda_dslash.hopping(face, B, lat)
            else:
                hop = wilson_hopping(mesh, face, B, lat)
            Df.append(_columns(agg, P, hop * up[mu]))
            Db.append(_columns(agg, P, hop * lo[mu]))
    elif isinstance(stencil, CoarseStencilSoA):
        Pk = stencil.Pk
        A = _columns(agg, P, cuda_coarse.coarse_apply(
            Pk, B, lat, (0, 9), mask_block=tuple(agg.coarsening)))
        Df, Db = [], []
        for mu in range(4):
            for k, mask, out in ((1 + mu, up[mu], Df), (5 + mu, lo[mu], Db)):
                if mesh is None:
                    w = neighbor(B, k, lat) * mask
                else:
                    w = halo_exchange_shift(mesh, B, -1 if k < 5 else 1, mu, lat) * mask
                out.append(_columns(agg, P, torch.einsum(
                    "jix,bjx->bix", Pk[k], w)))
    else:
        raise TypeError(type(stencil))
    return CoarseOperator(A=A.contiguous(), Df=torch.stack(Df),
                          Db=torch.stack(Db))


def gather(mesh, cop: CoarseOperator, lattice_local) -> CoarseOperator:
    """The whole coarse operator on every rank from each rank's slab of it
    (the replicated coarsest level's assembly)."""
    def g(a):     # sites on axis -3: [*, V_l, d, d]
        return gather_field(mesh, a.movedim(-3, -1), lattice_local).movedim(-1, -3).contiguous()

    return CoarseOperator(A=g(cop.A), Df=g(cop.Df), Db=g(cop.Db))
