"""Aggregation-based interpolation, generic over levels.

The interpolation P is built from N test vectors, orthonormalized per
(aggregate, chirality), so gamma5-compatibility holds: each coarse site
carries 2N dof ordered (chirality, k).  Reference:
interpolation_PRECISION_define (src/setup_generic.c:191-275),
gram_schmidt_on_aggregates_PRECISION (src/linalg_generic.c:400-455),
restrict/interpolate (src/interpolation_generic.c:93-207).

The chirality of a dof is "first half / second half of the site dof" on
every level (fine: spins {0,1} / {2,3}; coarse: k < N / k >= N), so one
implementation serves all levels.  Fields are [*b, dof, V]; P is
[Vc, 2, N, m] with m = aggregate volume * dof per chirality, rows
orthonormal per (coarse site, chirality).  restrict/interpolate are batched
contractions over all (coarse site, chirality) pairs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Aggregation(NamedTuple):
    """Geometry of one coarsening step: fine lattice, aggregate extents,
    number of test vectors N (coarse dof 2N), fine dof per chirality."""

    fine_lattice: tuple
    coarsening: tuple
    num_vectors: int
    fine_dpc: int = 6

    @property
    def coarse_lattice(self):
        return tuple(self.fine_lattice[mu] // self.coarsening[mu] for mu in range(4))

    @property
    def agg_volume(self):
        return int(np.prod(self.coarsening))

    @property
    def m(self):
        """Rows per (aggregate, chirality) block."""
        return self.agg_volume * self.fine_dpc


def to_aggregates(agg: Aggregation, v: torch.Tensor) -> torch.Tensor:
    """[*b, dof, V] -> [*b, Vc, 2, m]  (m ordered (at, az, ay, ax, dpc))."""
    ct, cz, cy, cx = agg.coarse_lattice
    at, az, ay, ax = agg.coarsening
    nb = v.dim() - 2
    x = v.reshape(*v.shape[:nb], 2, agg.fine_dpc, ct, at, cz, az, cy, ay, cx, ax)
    b = tuple(range(nb))
    x = x.permute(*b, *(nb + i for i in (2, 4, 6, 8, 0, 3, 5, 7, 9, 1)))
    return x.reshape(*v.shape[:nb], ct * cz * cy * cx, 2, agg.m)


def from_aggregates(agg: Aggregation, x: torch.Tensor) -> torch.Tensor:
    """Inverse of to_aggregates: [*b, Vc, 2, m] -> [*b, dof, V]."""
    ct, cz, cy, cx = agg.coarse_lattice
    at, az, ay, ax = agg.coarsening
    nb = x.dim() - 3
    y = x.reshape(*x.shape[:nb], ct, cz, cy, cx, 2, at, az, ay, ax, agg.fine_dpc)
    b = tuple(range(nb))
    y = y.permute(*b, *(nb + i for i in (4, 9, 0, 5, 1, 6, 2, 7, 3, 8)))
    return y.reshape(*x.shape[:nb], 2 * agg.fine_dpc, -1).contiguous()


def block_qr(a: torch.Tensor, allsum=None) -> torch.Tensor:
    """Orthonormal columns of batched [..., m, n] blocks by classical
    Gram-Schmidt with double projection (CGS-2; the JAX package's
    cplx.block_qr, at least the orthogonality of the reference's
    reorthogonalized MGS, src/setup_generic.c:291-296).  With allsum the
    m rows are this rank's share of rows spread over the ranks, and every
    inner product is summed over them."""
    q = torch.zeros_like(a)
    for k in range(a.shape[-1]):
        v = a[..., k:k + 1]
        if k:
            for _ in range(2):
                h = q[..., :k].transpose(-1, -2).conj() @ v
                if allsum is not None:
                    h = allsum(h)
                v = v - q[..., :k] @ h
        if allsum is None:
            nrm = torch.linalg.vector_norm(v, dim=-2, keepdim=True)
        else:
            nrm = torch.sqrt(allsum((v.conj() * v).real.sum(dim=-2, keepdim=True)))
        q[..., k:k + 1] = v / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    return q


def build_interpolation(agg: Aggregation, test_vectors: torch.Tensor,
                        out=None) -> torch.Tensor:
    """test_vectors [N, dof, V] -> P [Vc, 2, N, m], written into out if
    given."""
    cols = to_aggregates(agg, test_vectors).permute(1, 2, 3, 0)  # [Vc,2,m,N]
    q = block_qr(cols).transpose(-1, -2)
    return q.contiguous() if out is None else out.copy_(q)


def restrict(agg: Aggregation, P: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v_c = P^H v: [*b, dof, V] -> [*b, 2N, Vc]."""
    out = torch.einsum("xckm,...xcm->...xck", P.conj(), to_aggregates(agg, v))
    return out.reshape(*out.shape[:-3], out.shape[-3], -1).movedim(-1, -2).contiguous()


def interpolate(agg: Aggregation, P: torch.Tensor, v_c: torch.Tensor) -> torch.Tensor:
    """v = P v_c: [*b, 2N, Vc] -> [*b, dof, V]."""
    vc = v_c.movedim(-1, -2).reshape(*v_c.shape[:-2], v_c.shape[-1], 2,
                                     agg.num_vectors)
    return from_aggregates(agg, torch.einsum("xckm,...xck->...xcm", P, vc))


def assemble_basis(agg: Aggregation, P: torch.Tensor, cols=None) -> torch.Tensor:
    """The coarse basis vectors j in cols (default: all 2N) as fine fields,
    B[j] = P e_{c,k} (j = c*N + k) on every aggregate at once: [len(cols),
    dof, V].  Input of the Galerkin product."""
    N = agg.num_vectors
    cols = range(2 * N) if cols is None else cols
    bagg = torch.zeros(len(cols), P.shape[0], 2, agg.m, dtype=P.dtype, device=P.device)
    for i, j in enumerate(cols):
        c, k = divmod(j, N)
        bagg[i, :, c] = P[:, c, k]
    return from_aggregates(agg, bagg)
