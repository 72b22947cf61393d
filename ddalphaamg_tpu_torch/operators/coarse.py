"""Coarse-grid operator: a 4D nearest-neighbor stencil of dense d x d blocks
(d = 2 * num_test_vectors), and the plain PyTorch version of kernel K4.

Reference: src/coarse_operator_generic.c (apply_coarse_operator_PRECISION,
:383-415).  Both hop directions are stored dense.  Dof ordering is
(chirality, k), so gamma5_c = diag(-1_N, +1_N), consistent with the fine
convention gamma5 = diag(-1, -1, +1, +1) over spins.

Packed layout read by K4 and K5: blocks [K, d (j), d (i), V] with sites
fastest; term k = 0 is the self-coupling A, k = 1 + mu the forward coupling
Df_mu to phi(x + mu), k = 5 + mu the backward coupling Db_mu to phi(x - mu).

On one slab of a lattice sharded along any of t, z, y and x, the hops that
leave the slab read faces received from the neighbor ranks: halos = {mu:
(fwd, bwd)} with fwd = v(x + mu) on the slab's last mu slice and bwd =
v(x - mu) on its first, each [*batch, d, V / n_mu] in lexicographic order
of the remaining coordinates (parallel/comm.face).

Parity-split blocks (split_blocks; the coarsest level's Schur complement,
K4-schur): E [9, d, d, V/2] holds the even sites' self block and hops, O
[9, d, d, V/2] the odd sites' self-block inverse in slot 0 and their hops,
each half by checkerboard index site >> 1 (every extent even), exact
copies of the packed blocks' entries in their dtype.

Compressed blocks (the JAX package's CoarseStencilSoA.compress, stencil.py:
385-403) are the same tensor rounded to bfloat16 and stored as a real
tensor [K, d, d, V, 2] with (re, im) interleaved, so one block entry is one
32-bit pair; they apply to complex64 fields only, widened to float32 before
the multiply-add (pallas_coarse.py:114-116).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .fast import parity_sites, compact_parity, expand_parity, parity_mask


class CoarseOperator(NamedTuple):
    """Site-major blocks: A [V, d, d] (row i, column j); Df, Db [4, V, d, d]
    couplings to phi(x + mu) / phi(x - mu), hopping signs folded in."""

    A: torch.Tensor
    Df: torch.Tensor
    Db: torch.Tensor

    @property
    def dof(self):
        return self.A.shape[-1]

    def pack(self) -> torch.Tensor:
        """-> [9, d (j), d (i), V]."""
        Bs = torch.cat([self.A[None], self.Df, self.Db], dim=0)
        return Bs.permute(0, 3, 2, 1).contiguous()


def intra_block_masks(lattice, block) -> tuple[np.ndarray, np.ndarray]:
    """(fwd, bwd) masks [4, T,Z,Y,X]: fwd = 0 where x is on the block's upper
    mu face (the x -> x+mu coupling crosses), bwd = 0 on the lower face."""
    fwd, bwd = [], []
    for mu in range(4):
        coord = np.arange(lattice[mu])
        shape = [1, 1, 1, 1]
        shape[mu] = lattice[mu]
        up = ((coord % block[mu]) != (block[mu] - 1)).reshape(shape)
        lo = ((coord % block[mu]) != 0).reshape(shape)
        fwd.append(np.broadcast_to(up, lattice).astype(np.float64))
        bwd.append(np.broadcast_to(lo, lattice).astype(np.float64))
    return np.stack(fwd), np.stack(bwd)


def neighbor(v: torch.Tensor, k: int, lattice, halos=None) -> torch.Tensor:
    """The field that term k reads: v(x), v(x + mu) or v(x - mu), wrapped
    inside the lattice or, on an axis in halos, filled from the faces."""
    if k == 0:
        return v
    mu = (k - 1) % 4
    shape = v.shape
    w = v.reshape(*shape[:-1], *lattice)
    ax = w.dim() - 4 + mu
    if halos is not None and mu in halos:
        n = lattice[mu]
        face_shape = list(w.shape)
        face_shape[ax] = 1
        if k < 5:
            w = torch.cat([w.narrow(ax, 1, n - 1),
                           halos[mu][0].reshape(face_shape)], ax)
        else:
            w = torch.cat([halos[mu][1].reshape(face_shape),
                           w.narrow(ax, 0, n - 1)], ax)
    else:
        w = torch.roll(w, -1 if k < 5 else 1, ax)
    return w.reshape(shape)


def compress(blocks: torch.Tensor, out=None) -> torch.Tensor:
    """complex64 blocks [..., V] -> contiguous bfloat16 pairs [..., V, 2]
    (round to nearest even, as the JAX package's astype), written into out
    if given."""
    if blocks.dtype != torch.complex64:
        raise TypeError(f"bf16 block storage rounds complex64 blocks, got {blocks.dtype}")
    pairs = torch.view_as_real(blocks.contiguous())
    return pairs.to(torch.bfloat16) if out is None else out.copy_(pairs)


def widen(blocks: torch.Tensor) -> torch.Tensor:
    """Blocks as complex numbers: bfloat16 pairs widened to complex64,
    complex blocks as they are."""
    if blocks.dtype == torch.bfloat16:
        return torch.view_as_complex(blocks.float())
    return blocks


def _check_block_dtype(blocks, v):
    if blocks.dtype == torch.bfloat16 and v.dtype != torch.complex64:
        raise TypeError(f"bf16 blocks apply to complex64 fields, got {v.dtype}")


def coarse_apply_plain(blocks, v, lattice, terms=(0, 9), mask_block=None,
                       parity=None, parity_offset: int = 0):
    """Plain K4: out[i, x] = sum_{k in terms} sum_j B_k[j, i, x] v(n_k(x))[j]
    with the same mask and (global) parity semantics as the kernel; bf16
    blocks are widened term by term."""
    lattice = tuple(lattice)
    _check_block_dtype(blocks, v)
    masks = None
    if mask_block is not None:
        fwd, bwd = intra_block_masks(lattice, mask_block)
        masks = torch.as_tensor(np.concatenate([fwd, bwd]).reshape(8, -1),
                                dtype=v.real.dtype, device=v.device)
    out = torch.zeros_like(v)
    for k in range(*terms):
        w = neighbor(v, k, lattice)
        if masks is not None and k > 0:
            w = w * masks[k - 1]
        out = out + torch.einsum("jix,...jx->...ix", widen(blocks[k]), w)
    if parity is not None:
        out = out * parity_mask(lattice, parity, v.real.dtype, v.device,
                                parity_offset)
    return out


def coarse_apply_halo_plain(blocks, v, lattice, halos, terms=(0, 9)):
    """Plain K5: coarse_apply_plain on one slab whose hops across the
    sharded axes read the received faces (halos, see the module note)."""
    _check_block_dtype(blocks, v)
    out = torch.zeros_like(v)
    for k in range(*terms):
        out = out + torch.einsum("jix,...jx->...ix", widen(blocks[k]),
                                 neighbor(v, k, tuple(lattice), halos))
    return out


def split_blocks(Pk: torch.Tensor, Pk_inv: torch.Tensor, lattice, out=None):
    """The parity-split blocks (E, O) of the packed blocks Pk [9, d, d, V]
    and the self-block inverse Pk_inv [1, d, d, V] (complex, or bf16 pairs
    [..., V, 2]): an exact gather of their entries (module note), written
    into out = (E, O) if given."""
    lattice = tuple(lattice)
    if any(n % 2 for n in lattice):
        raise ValueError(f"parity-split blocks need even extents, got {lattice}")
    even, odd = (parity_sites(lattice, p, 0, Pk.device) for p in (0, 1))
    if out is None:
        shape = (*Pk.shape[:3], even.numel(), *Pk.shape[4:])
        out = tuple(torch.empty(shape, dtype=Pk.dtype, device=Pk.device) for _ in range(2))
    E, O = out
    torch.index_select(Pk, 3, even, out=E)
    torch.index_select(Pk_inv, 3, odd, out=O[:1])
    torch.index_select(Pk[1:], 3, odd, out=O[1:])
    return E, O


def _split_term(blocks, v):
    return torch.einsum("jih,...jh->...ih", widen(blocks), v)


def schur_split_plain(E, O, v, lattice):
    """Plain K4-schur: the even-site Schur complement A_ee v_e - sum_k hop_k
    A_oo^-1 sum_k hop_k v_e of v [*B, d, V] from the split blocks (E, O),
    zero on the odd sites; bf16 blocks are widened term by term."""
    lattice = tuple(lattice)
    _check_block_dtype(E, v)
    h = sum(_split_term(O[k], compact_parity(neighbor(v, k, lattice), lattice, 1))
            for k in range(1, 9))
    t = expand_parity(_split_term(O[0], h), lattice, 1)
    hops = sum(_split_term(E[k], compact_parity(neighbor(t, k, lattice), lattice, 0))
               for k in range(1, 9))
    return expand_parity(_split_term(E[0], compact_parity(v, lattice, 0)) - hops, lattice, 0)
