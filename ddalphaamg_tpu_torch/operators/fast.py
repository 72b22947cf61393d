"""Dof-major (SoA) layout of the fine level and the plain PyTorch versions of
kernels K1-K3.

Layout (the one the CUDA kernels read; identical in memory to the JAX
package's SoA [4, 3, T, Z, Y*X] arrays):

    spinor   [*batch, 12, V]    dof = 3 * spin + color, V = T*Z*Y*X, X fastest
    links    [4, 3, 3, V]       U_mu / 2 with the anti-periodic sign folded in
    clover   packed Hermitian, cdiag [2, 6, V] real + coff [2, 15, V]
             (operators/cuda_dslash.pack_clover)

The plain versions below are written with torch.roll on a [.., T, Z, Y, X]
view.  They are the reference the kernels are held to on the card and the
path a CPU tensor takes.
"""

from __future__ import annotations

import functools
import math

import torch

from ..gamma import get_basis

PAIRS = tuple((i, j) for i in range(6) for j in range(i + 1, 6))


# ---------------------------------------------------------------------------
# layout conversion
# ---------------------------------------------------------------------------

def spinor_to_soa(phi: torch.Tensor) -> torch.Tensor:
    """[*b, T,Z,Y,X, 4,3] -> [*b, 12, V]."""
    nb = phi.dim() - 6
    lat = phi.shape[nb:nb + 4]
    v = phi.reshape(*phi.shape[:nb], *lat, 12)
    return v.movedim(-1, nb).reshape(*phi.shape[:nb], 12, -1).contiguous()


def spinor_from_soa(v: torch.Tensor, lattice) -> torch.Tensor:
    """[*b, 12, V] -> [*b, T,Z,Y,X, 4,3]."""
    nb = v.dim() - 2
    a = v.reshape(*v.shape[:nb], 4, 3, *lattice)
    return a.movedim(nb, -1).movedim(nb, -1).contiguous()


def gamma5_soa(v: torch.Tensor) -> torch.Tensor:
    """gamma5 v = diag(-1, -1, +1, +1)_spin v for dof-major fields [*, 12, V]
    (dofs 0-5 hold spins 0 and 1)."""
    return torch.cat([-v[..., :6, :], v[..., 6:, :]], dim=-2)


def links_to_soa(links: torch.Tensor) -> torch.Tensor:
    """[4, T,Z,Y,X, 3,3] -> [4, 3, 3, V]."""
    return links.permute(0, 5, 6, 1, 2, 3, 4).reshape(4, 3, 3, -1).contiguous()


def clover_to_soa(clov: torch.Tensor) -> torch.Tensor:
    """[T,Z,Y,X, 2,6,6] -> [2, 6, 6, V]."""
    return clov.permute(4, 5, 6, 0, 1, 2, 3).reshape(2, 6, 6, -1).contiguous()


def parity_mask(lattice, parity: int, dtype=torch.float64, device=None,
                offset: int = 0):
    """[V] mask of the sites with (t+z+y+x) % 2 == parity; offset is the
    coordinate sum of site 0 on the global lattice (a slab's offset)."""
    idx = [torch.arange(n, device=device) for n in lattice]
    t, z, y, x = torch.meshgrid(*idx, indexing="ij")
    return (((t + z + y + x + offset) % 2) == parity).to(dtype).reshape(-1)


@functools.lru_cache(maxsize=None)
def parity_sites(lattice, parity, offset, device):
    """Site indices of one parity in site order.  With an even x extent
    each x-pair (2h, 2h + 1) holds one site of either parity, so the k-th
    of them is site 2k or 2k + 1: the checkerboard index is site // 2."""
    if lattice[3] % 2:
        raise ValueError(f"parity-compact storage needs an even x extent, got {lattice}")
    mask = parity_mask(lattice, parity, torch.float32, device, offset)
    return torch.nonzero(mask).reshape(-1)


@functools.lru_cache(maxsize=None)
def _cached_mask(lattice, parity, offset, dtype, device):
    return parity_mask(lattice, parity, dtype, device, offset)


def _restrict(out, lattice, parity, offset):
    """out with the sites of the other parity zeroed (parity None: out)."""
    if parity is None:
        return out
    return out * _cached_mask(tuple(lattice), int(parity), int(offset) & 1,
                              out.real.dtype, out.device)


def compact_parity(a, lattice, parity: int, offset: int = 0):
    """[..., V] -> [..., V/2]: the entries at the sites of one parity, by
    checkerboard index (the compact odd-site storage of the fine clover
    inverse; offset as in parity_mask)."""
    idx = parity_sites(tuple(lattice), int(parity), int(offset) & 1, a.device)
    return a.index_select(-1, idx).contiguous()


def expand_parity(a, lattice, parity: int, offset: int = 0):
    """Inverse of compact_parity: [..., V/2] -> [..., V], zeros at the
    sites of the other parity."""
    full = a.new_zeros((*a.shape[:-1], math.prod(lattice)))
    full[..., parity_sites(tuple(lattice), int(parity), int(offset) & 1, a.device)] = a
    return full


# ---------------------------------------------------------------------------
# plain versions of K1-K3
# ---------------------------------------------------------------------------

def _gamma_tables(device, dtype):
    basis = get_basis()
    co = [[int(c) for c in row] for row in basis.co]
    val = torch.as_tensor(basis.val, dtype=dtype, device=device)
    return co, val


def _dense_index():
    """Position of each dense (i, j) entry in cat([diag, off, conj(off)])."""
    idx = [[0] * 6 for _ in range(6)]
    for i in range(6):
        idx[i][i] = i
    for k, (i, j) in enumerate(PAIRS):
        idx[i][j] = 6 + k
        idx[j][i] = 21 + k
    return [e for row in idx for e in row]


_DENSE_INDEX = _dense_index()


def unpack_clover(cdiag: torch.Tensor, coff: torch.Tensor) -> torch.Tensor:
    """Packed Hermitian clover -> dense [2, 6, 6, V]."""
    entries = torch.cat([cdiag.to(coff.dtype), coff, coff.conj()], dim=1)
    idx = torch.as_tensor(_DENSE_INDEX, device=coff.device)
    return entries.index_select(1, idx).reshape(2, 6, 6, -1)


def clover_apply_soa(cdiag, coff, phi, lattice=None, parity=None,
                     parity_offset: int = 0, compact: bool = False):
    """Plain K3: eta = C phi per site with C packed; parity (with lattice)
    keeps only the sites of that parity (global parity: see parity_mask).
    compact: C is stored at the sites of that parity only (compact_parity)."""
    if compact:
        cdiag = expand_parity(cdiag, lattice, parity, parity_offset)
        coff = expand_parity(coff, lattice, parity, parity_offset)
    dense = unpack_clover(cdiag, coff)
    ph = phi.reshape(*phi.shape[:-2], 2, 6, phi.shape[-1])
    out = torch.einsum("cijx,...cjx->...cix", dense, ph).reshape(phi.shape)
    return _restrict(out, lattice, parity, parity_offset)


def _color_mul(u, h):
    """out[s, a] = sum_b u[a, b] h[s, b] for h [*, 2, 3, *lat], u [3, 3, *lat]."""
    return sum(u[:, b] * h.narrow(-5, b, 1) for b in range(3))


def dslash_hopping_soa(links, phi, lattice, parity=None, parity_offset: int = 0):
    """Plain K2: - sum_mu [U(x)(1-g_mu) phi(x+mu) + U^H(x-mu)(1+g_mu) phi(x-mu)];
    parity keeps only the sites of that parity (as clover_apply_soa)."""
    lattice = tuple(lattice)
    p = phi.reshape(*phi.shape[:-2], 4, 3, *lattice)
    u = links.reshape(4, 3, 3, *lattice)
    co, val = _gamma_tables(phi.device, phi.dtype)
    out = torch.zeros_like(p)
    up, lo = out.narrow(-6, 0, 2), out.narrow(-6, 2, 2)
    for mu in range(4):
        ax = p.dim() - 4 + mu    # lattice axis of direction mu
        v2 = val[mu].reshape(4, 1, 1, 1, 1, 1)
        hi = torch.as_tensor(co[mu][:2], device=p.device)
        lft = torch.as_tensor(co[mu][2:], device=p.device)
        # forward: U(x) (1 - gamma_mu) phi(x+mu), spins 0, 1
        pf = torch.roll(p, -1, ax)
        hf = _color_mul(u[mu], pf.narrow(-6, 0, 2) - v2[:2] * pf.index_select(-6, hi))
        up.sub_(hf)
        lo.add_(v2[2:] * hf.index_select(-6, lft))
        # backward: U^H(x-mu) (1 + gamma_mu) phi(x-mu), formed at x-mu
        h = p.narrow(-6, 0, 2) + v2[:2] * p.index_select(-6, hi)
        hb = torch.roll(_color_mul(u[mu].conj().transpose(0, 1), h), 1, ax)
        up.sub_(hb)
        lo.sub_(v2[2:] * hb.index_select(-6, lft))
    return _restrict(out.reshape(phi.shape), lattice, parity, parity_offset)


def d_plus_clover_soa(links, cdiag, coff, phi, lattice):
    """Plain K1: the full Wilson-clover operator."""
    return clover_apply_soa(cdiag, coff, phi) + dslash_hopping_soa(
        links, phi, lattice)
