"""Stencils: one operator interface for the SAP smoother and the multigrid
cycles on every level.

A stencil exposes (whole-lattice, mask-based; blocks never materialize):

    full_op(v)          the full operator D v
    dagger_op(v)        D^dagger v = gamma5 D gamma5 v (the fine stencil only:
                        K1 between two gamma5 multiplications)
    block_op(v)         D restricted to intra-Schwarz-block couplings
    self_op(v)          the per-site self-coupling (clover / A)
    self_inv(v, parity) the inverse self-coupling on the sites of one parity
                        (the fine level stores it on the odd sites only)
    hop(v), hop_intra(v, parity=None)  hopping terms, all / intra-block only;
                        hop_intra's result is needed on the sites of a given
                        parity only: the fine stencil computes those and
                        writes zeros elsewhere, the coarse one every site
    even, odd           site-parity masks [V]

Fields of every level share one layout, [*batch, dof, V] (dof-major, sites
fastest: 12 spin-color dof on the fine level, d = 2N on coarse levels), so
block reductions and the layout hooks are common to both stencils.  Every
operator goes through a kernel wrapper (K1-K5), which runs the plain PyTorch
version only for tensors on the CPU.

A stencil with a mesh (parallel/mesh.SolverMesh) is one rank's slab of a
sharded level: geom is the slab's geometry, full_op and hop exchange faces
with the neighbor ranks (parallel/shard_ops.py: the faces posted first,
the kernel's interior work while they travel), allsum is the all-reduce
(K8 on nccl, parallel/peer.py), the other operators stay local, and
parities count global coordinates.

The coarsest level's direct solve (MGConfig.coarsest_direct; the JAX
package's stencil.py:599-727) lives here too: the operator, or its
even-site Schur complement, materialized column by column from one-hot
fields through the stencil's own kernels, inverted with torch.linalg.inv
in the level's complex dtype (or stored in bf16), and applied as one
matvec (operators/cuda_dense.py).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..geometry import Geometry
from ..parallel import comm, shard_ops, soa_halo
from ..parallel.mesh import shard_field
from . import cuda_coarse, cuda_dense, cuda_dslash, fast
from .coarse import CoarseOperator, compress, split_blocks
from .wilson import WilsonOperator

EVEN, ODD = 0, 1
COLUMNS_PER_BATCH = 256   # one-hot columns per batched apply of a dense inverse build
# where schur takes K4-schur on a stencil with split blocks (its kernel has
# no CPU mode; tests add "cpu" to run its plain version there)
SPLIT_SCHUR_DEVICES = ("cuda",)


def _link_intra_mask(geom: Geometry) -> np.ndarray:
    """[4, V]: 0 where U_mu(x) crosses a Schwarz block boundary."""
    masks = []
    for mu in range(4):
        coord = np.arange(geom.lattice[mu])
        keep = (coord % geom.block[mu]) != (geom.block[mu] - 1)
        shape = [1, 1, 1, 1]
        shape[mu] = geom.lattice[mu]
        masks.append(np.broadcast_to(keep.reshape(shape), geom.lattice))
    return np.stack(masks).reshape(4, -1).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _block_index(lattice, block, device: str) -> torch.Tensor:
    """[V] index of the Schwarz block of each site (block grid lexicographic)."""
    c = np.indices(lattice).reshape(4, -1)
    grid = [lattice[mu] // block[mu] for mu in range(4)]
    b = np.zeros(c.shape[1], dtype=np.int64)
    for mu in range(4):
        b = b * grid[mu] + c[mu] // block[mu]
    return torch.as_tensor(b, device=device)


def _slab_parity(mesh, lattice) -> int:
    """Parity of a slab's global offset (0 on one rank)."""
    return 0 if mesh is None else mesh.parity(lattice)


class _SoALayout:
    """Layout hooks and block reductions shared by both stencils."""

    geom: Geometry
    mesh: object

    @property
    def lattice(self):
        return tuple(self.geom.lattice)

    @property
    def global_geom(self) -> Geometry:
        if self.mesh is None:
            return self.geom
        return Geometry(lattice=self.mesh.global_lattice(self.lattice),
                        block=tuple(self.geom.block), dof=self.geom.dof)

    @property
    def offsets(self) -> tuple:
        """Global coordinates of the slab's site 0."""
        return (0, 0, 0, 0) if self.mesh is None else self.mesh.offsets(self.lattice)

    @property
    def parity_offset(self) -> int:
        return _slab_parity(self.mesh, self.lattice)

    @property
    def allsum(self):
        """Sum over the mesh of per-slab partial sums; None on one rank."""
        if self.mesh is None:
            return None
        return functools.partial(comm.all_reduce_sum, self.mesh)

    def slab(self, v):
        """This rank's slab of a global field [*, V_global] (v itself on
        one rank)."""
        if self.mesh is None:
            return v
        return shard_field(self.mesh, v, self.global_geom.lattice)

    def from_logical(self, v):
        """[*b, T, Z, Y, X, dof] -> [*b, dof, V]."""
        nb = v.dim() - 5
        return v.reshape(*v.shape[:nb], -1, v.shape[-1]).movedim(-1, -2).contiguous()

    def dof_sum(self, a):
        return a.sum(dim=-2)

    def block_sum(self, a):
        """[*, V] -> [*, n_blocks] sums over each Schwarz block."""
        gt, gz, gy, gx = self.geom.block_grid
        bt, bz, by, bx = self.geom.block
        a = a.reshape(*a.shape[:-1], gt, bt, gz, bz, gy, by, gx, bx)
        return a.sum(dim=(-7, -5, -3, -1)).reshape(*a.shape[:-8], -1)

    def block_expand(self, a):
        """[*, n_blocks] -> [*, 1, V] (broadcasts over the dof axis)."""
        idx = _block_index(self.lattice, tuple(self.geom.block), str(a.device))
        return a[..., idx].unsqueeze(-2)


@dataclasses.dataclass
class WilsonStencilSoA(_SoALayout):
    """Fine-level Wilson-clover stencil: links, block-masked links and the
    packed clover and clover inverse, all dof-major.  The inverse is only
    ever applied on the odd sites (the block odd-even solves of the SAP), so
    it is stored there only, by checkerboard index (fast.compact_parity)."""

    links: torch.Tensor          # [4, 3, 3, V]
    links_intra: torch.Tensor
    cdiag: torch.Tensor          # [2, 6, V] real
    coff: torch.Tensor           # [2, 15, V]
    cdiag_inv: torch.Tensor      # [2, 6, V/2] real, odd sites
    coff_inv: torch.Tensor       # [2, 15, V/2], odd sites
    even: torch.Tensor           # [V] real
    odd: torch.Tensor
    geom: Geometry
    mesh: object = None

    @classmethod
    def build(cls, op: WilsonOperator, geom: Geometry, dtype=None,
              mesh=None) -> "WilsonStencilSoA":
        """From the logical operator (this rank's slab of it under a mesh,
        with geom the slab's geometry); the clover inverse is formed from the
        operator's own precision before any cast to dtype."""
        dtype = dtype or op.links.dtype
        clov = fast.clover_to_soa(op.clover)
        clov_inv = fast.clover_to_soa(herm_inv(op.clover))
        rdtype = torch.empty((), dtype=dtype).real.dtype
        links = fast.links_to_soa(op.links).to(dtype)
        intra = torch.as_tensor(_link_intra_mask(geom), dtype=rdtype,
                                device=links.device)
        cdiag, coff = cuda_dslash.pack_clover(clov)
        offset = _slab_parity(mesh, geom.lattice)
        cdiag_inv, coff_inv = (fast.compact_parity(t, geom.lattice, ODD, offset)
                               for t in cuda_dslash.pack_clover(clov_inv))
        even = fast.parity_mask(geom.lattice, EVEN, rdtype, links.device, offset)
        if mesh is not None:        # the face corrections' tables, before any capture
            soa_halo.face_tables(links.device, dtype)
        return cls(links=links,
                   links_intra=(links * intra[:, None, None]).contiguous(),
                   cdiag=cdiag.to(rdtype), coff=coff.to(dtype),
                   cdiag_inv=cdiag_inv.to(rdtype), coff_inv=coff_inv.to(dtype),
                   even=even, odd=1.0 - even, geom=geom, mesh=mesh)

    @property
    def dtype(self):
        return self.links.dtype

    @property
    def device(self):
        return self.links.device

    @property
    def field_shape(self):
        return (12, self.geom.num_sites)

    def full_op(self, v):
        if self.mesh is not None:
            return shard_ops.wilson_full(self.mesh, self.links, self.cdiag,
                                         self.coff, v, self.lattice)
        return cuda_dslash.d_plus_clover(self.links, self.cdiag, self.coff, v,
                                         self.lattice)

    def dagger_op(self, v):
        return fast.gamma5_soa(self.full_op(fast.gamma5_soa(v)))

    def block_op(self, v):
        return cuda_dslash.d_plus_clover(self.links_intra, self.cdiag,
                                         self.coff, v, self.lattice)

    def self_op(self, v):
        return cuda_dslash.clover(self.cdiag, self.coff, v, self.lattice)

    def self_inv(self, v, parity):
        if parity != ODD:
            raise ValueError("the fine clover inverse is stored on the odd sites only")
        return cuda_dslash.clover(self.cdiag_inv, self.coff_inv, v, self.lattice,
                                  ODD, self.parity_offset, compact=True)

    def hop_intra(self, v, parity=None):
        return cuda_dslash.hopping(self.links_intra, v, self.lattice, parity,
                                   self.parity_offset)


@dataclasses.dataclass
class CoarseStencilSoA(_SoALayout):
    """Coarse-level stencil: the 9 packed block terms [A, Df_0..3, Db_0..3]
    and the packed self-coupling inverse; the Schwarz restriction masks the
    neighbor fields inside K4, so one block tensor serves every operator.
    A coarsest level solved by the Schur GCR also holds its blocks split by
    parity (E, O: split(), operators/coarse.split_blocks), which schur
    applies with K4-schur."""

    Pk: torch.Tensor             # [9, d, d, V]
    Pk_inv: torch.Tensor         # [1, d, d, V]
    even: torch.Tensor           # [V] real
    odd: torch.Tensor
    geom: Geometry
    mesh: object = None
    E: Optional[torch.Tensor] = None   # [9, d, d, V/2]: even sites' A and hops
    O: Optional[torch.Tensor] = None   # [9, d, d, V/2]: odd sites' A^-1 and hops

    @classmethod
    def build(cls, cop: CoarseOperator, geom: Geometry, dtype=None,
              mesh=None) -> "CoarseStencilSoA":
        """From the site-major blocks (this rank's slab of them under a
        mesh, with geom the slab's geometry)."""
        dtype = dtype or cop.A.dtype
        return cls.from_blocks(cop.pack().to(dtype), geom, mesh)

    @classmethod
    def from_blocks(cls, Pk: torch.Tensor, geom: Geometry, mesh=None) -> "CoarseStencilSoA":
        """From the packed blocks [9, d (j), d (i), V] themselves (kept, not
        copied: at 32^4 they are 14.8 GB) in their dtype."""
        rdtype = torch.empty((), dtype=Pk.dtype).real.dtype
        Ainv = torch.linalg.inv(Pk[0].permute(2, 1, 0))
        even = fast.parity_mask(geom.lattice, EVEN, rdtype, Pk.device,
                               _slab_parity(mesh, geom.lattice))
        return cls(Pk=Pk, Pk_inv=Ainv[None].permute(0, 3, 2, 1).contiguous(),
                   even=even, odd=1.0 - even, geom=geom, mesh=mesh)

    @property
    def dtype(self):
        """The fields' dtype (complex64 for bf16-stored blocks)."""
        return torch.complex64 if self.Pk.dtype == torch.bfloat16 else self.Pk.dtype

    @property
    def device(self):
        return self.Pk.device

    def compress(self) -> "CoarseStencilSoA":
        """The stencil with Pk and Pk_inv stored in bf16 (the JAX package's
        compress, stencil.py:385-403); fields, parity masks and sums stay
        complex64 / f32, and K4-bf16 / K5-bf16 widen each block entry
        before the multiply-add.  Split blocks are rounded too (the split
        of the rounded blocks)."""
        return dataclasses.replace(
            self, Pk=compress(self.Pk), Pk_inv=compress(self.Pk_inv),
            E=None if self.E is None else compress(self.E),
            O=None if self.O is None else compress(self.O))

    def split(self):
        """Make the parity-split blocks (E, O) from Pk and Pk_inv, or
        rewrite them in place where they exist (captured graphs read them)."""
        self.E, self.O = split_blocks(self.Pk, self.Pk_inv, self.lattice,
                                      out=None if self.E is None else (self.E, self.O))

    def refresh(self, view=None):
        """After Pk was rewritten in place: Pk_inv recomputed into its
        storage and, given the bf16 view (compress), both written rounded
        into the view's storage; the split blocks of the view (or of this
        stencil without one) rewritten in place (a setup's device programs
        read these tensors: Multigrid.re_setup)."""
        inv = torch.linalg.inv(self.Pk[0].permute(2, 1, 0))
        self.Pk_inv.copy_(inv[None].permute(0, 3, 2, 1))
        del inv
        if view is not None:
            compress(self.Pk, out=view.Pk)
            compress(self.Pk_inv, out=view.Pk_inv)
        target = self if view is None else view
        if target.E is not None:
            target.split()

    @property
    def dof(self) -> int:
        return self.Pk.shape[1]

    @property
    def field_shape(self):
        return (self.dof, self.geom.num_sites)

    def _apply(self, Pk, v, terms, masked=False, parity=None):
        return cuda_coarse.coarse_apply(
            Pk, v, self.lattice, terms,
            mask_block=tuple(self.geom.block) if masked else None,
            parity=parity, parity_offset=self.parity_offset)

    def _hops(self, v, terms):
        if self.mesh is not None:
            return shard_ops.coarse_hops(self.mesh, self.Pk, v, self.lattice, terms)
        return self._apply(self.Pk, v, terms)

    def full_op(self, v):
        return self._hops(v, (0, 9))

    def hop(self, v):
        return self._hops(v, (1, 9))

    def block_op(self, v):
        return self._apply(self.Pk, v, (0, 9), masked=True)

    def self_op(self, v):
        return self._apply(self.Pk, v, (0, 1))

    def self_inv(self, v, parity):
        return self._apply(self.Pk_inv, v, (0, 1), parity=parity)

    def hop_intra(self, v, parity=None):
        # K4 selects a parity for the self term only: every site is computed
        return self._apply(self.Pk, v, (1, 9), masked=True)


def shift_stencil(s, delta: float, op: WilsonOperator = None):
    """The stencil with its self-coupling shifted by +delta I (the per-level
    body of the mass update, the JAX package's stencil.py:549-598; the
    reference's shift_update, src/dirac_generic.c:504-551).  A fine stencil
    is rebuilt from op, the complex128 operator already shifted to the new
    mass: its clover inverse is then formed in complex128 as in a fresh
    build.  A coarse stencil gets delta on the diagonal of its self blocks
    and their inverses recomputed: since P^H P = I on every aggregate, a
    shift of the fine operator projects to exactly this."""
    if isinstance(s, WilsonStencilSoA):
        if op is None:
            raise ValueError("a fine stencil is shifted by a rebuild from the shifted operator")
        return WilsonStencilSoA.build(op, s.geom, dtype=s.dtype, mesh=s.mesh)
    Pk = s.Pk.clone()
    eye = torch.eye(s.dof, dtype=Pk.dtype, device=Pk.device)
    Pk[0] += delta * eye[:, :, None]
    A = Pk[0].permute(2, 1, 0)                       # [V, i, j]
    Pk_inv = torch.linalg.inv(A)[None].permute(0, 3, 2, 1).contiguous()
    out = dataclasses.replace(s, Pk=Pk, Pk_inv=Pk_inv, E=None, O=None)
    if s.E is not None:
        out.split()
    return out


def schur(s, v):
    """The even-site Schur complement S = A_ee - h_eo A_oo^-1 h_oe applied
    to v (the operator of the coarsest odd-even solve,
    coarse_solve_odd_even_PRECISION, src/coarse_oddeven_generic.c:1139):
    K4-schur's two launches on the split blocks where the stencil holds
    them and K4 would take its batch-1 kernel, else four K4 applies."""
    if (s.E is not None and v.device.type in SPLIT_SCHUR_DEVICES
            and cuda_coarse.batch1_regime(v, s.geom.num_sites)):
        return cuda_coarse.schur_split(s.E, s.O, v, s.lattice)
    ve = s.even * v
    return s.even * (s.self_op(ve) - s.hop(s.self_inv(s.hop(ve), ODD)))


def _invert_columns(op, s, cols, rows, bf16: bool):
    """Inverse of the matrix M[i, k] = op(e_cols[k])[rows[i]] (rows and
    cols index the flattened [d, V] field; None = all), as [1, n, n]:
    complex in the stencil's dtype or, with bf16, rounded to bf16 pairs
    [1, n, n, 2].  The one-hot columns run through the kernels' batch axis,
    COLUMNS_PER_BATCH at a time."""
    if s.mesh is not None:
        raise ValueError("a dense inverse needs the whole (replicated) level")
    shape = s.field_shape
    n = math.prod(shape)
    cols = torch.arange(n, device=s.device) if cols is None else cols
    Mt = torch.empty((len(cols), n if rows is None else len(rows)),
                     dtype=s.dtype, device=s.device)            # Mt[k, i]
    for c0 in range(0, len(cols), COLUMNS_PER_BATCH):
        c = cols[c0:c0 + COLUMNS_PER_BATCH]
        e = torch.zeros((len(c), n), dtype=s.dtype, device=s.device)
        e[torch.arange(len(c), device=s.device), c] = 1
        y = op(e.reshape(len(c), *shape)).reshape(len(c), n)
        Mt[c0:c0 + len(c)] = y if rows is None else y[:, rows]
    inv = torch.linalg.inv(Mt.transpose(0, 1))[None]
    return compress(inv) if bf16 else inv


def dense_inverse(s, bf16: bool = False):
    """Dense inverse of the stencil's full operator (MGConfig.coarsest_direct
    where odd-even does not apply), [1, n, n] with n = d V."""
    return _invert_columns(s.full_op, s, None, None, bf16)


def schur_even_indices(s) -> torch.Tensor:
    """Flat indices of the even-site entries of the [d, V] field layout (the
    compaction map of the Schur-complement direct solve)."""
    mask = s.even.expand(s.field_shape).reshape(-1) > 0.5
    return torch.nonzero(mask).reshape(-1)


def dense_schur_inverse(s, idx, bf16: bool = False):
    """Dense inverse of the even-site Schur complement (schur) compacted to
    the entries idx = schur_even_indices(s), [1, n/2, n/2]: a quarter of the
    full inverse's bytes for two more stencil applies per solve."""
    return _invert_columns(lambda v: schur(s, v), s, idx, idx, bf16)


def dense_schur_solve(s, inv, idx, b):
    """Coarsest direct solve of D x = b (b [*B, d, V], every leading index a
    right-hand side) with the Schur inverse: odd elimination, one
    [n/2, n/2] product for all right-hand sides, odd reconstruction."""
    b_e = s.even * (b - s.hop(s.self_inv(b, ODD)))
    flat = b_e.reshape(-1, 1, math.prod(s.field_shape))
    xc = cuda_dense.matvec(inv, flat[..., idx])
    x_e = torch.zeros_like(flat)
    x_e[..., idx] = xc
    x_e = x_e.reshape(b.shape)
    return x_e + s.self_inv(b - s.hop(x_e), ODD)


def dense_solve(inv, b):
    """x = inv b for b [*B, d, V] in the stencil's field layout (one product
    for all right-hand sides)."""
    n = inv.shape[-2]
    return cuda_dense.matvec(inv, b.reshape(-1, 1, n)).reshape(b.shape)


def herm_inv(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse of Hermitian positive-definite [..., d, d] blocks by
    Cholesky (reference selfcoupling_cholesky_decomposition_PRECISION,
    src/oddeven_generic.c:24-117), re-Hermitized first."""
    ah = 0.5 * (a + a.transpose(-1, -2).conj())
    L = torch.linalg.cholesky(ah)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand_as(a)
    l_inv = torch.linalg.solve_triangular(L, eye, upper=False)
    return l_inv.transpose(-1, -2).conj() @ l_inv
