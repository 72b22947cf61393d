"""Wrappers of the Wilson-clover kernels K1-K3 (csrc/dslash.cu) and the
clover packing they read.

Each wrapper takes the plain version (operators/fast.py) for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  Inputs may carry a
leading batch axis: phi [B, 12, V] or [12, V].  A parity (0 even, 1 odd,
counted on the global lattice whose coordinate sum at local site 0 has the
parity of parity_offset) restricts K2 and K3 to the sites of that parity,
with zeros elsewhere; it needs an even x extent.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from . import fast
from .fast import PAIRS


def pack_clover(clov_soa: torch.Tensor):
    """Hermitian [2, 6, 6, V] blocks -> (cdiag [2, 6, V] real,
    coff [2, 15, V] complex): 42 real entries per site and chirality."""
    diag = torch.stack([clov_soa[:, i, i].real for i in range(6)], dim=1)
    off = torch.stack([clov_soa[:, i, j] for (i, j) in PAIRS], dim=1)
    return diag.contiguous(), off.contiguous()


_SUFFIX = {torch.complex64: "f32", torch.complex128: "f64"}


def _check(phi, *others):
    if phi.dtype not in _SUFFIX:
        raise TypeError(f"dslash kernels take complex64/complex128, got {phi.dtype}")
    for t in others:
        if t.device != phi.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if not phi.is_contiguous():
        raise ValueError("operands must be contiguous")


def _batched(phi, lattice):
    V = math.prod(lattice)
    if phi.shape[-2:] != (12, V):
        raise ValueError(f"spinor shape {tuple(phi.shape)} does not match "
                         f"[*, 12, {V}]")
    return int(phi.numel() // (12 * V))


def _parity_args(lattice, parity, parity_offset):
    if parity is None:
        return -1, 0
    if lattice[3] % 2:
        raise ValueError(f"a parity apply needs an even x extent, got {tuple(lattice)}")
    return int(parity), int(parity_offset) & 1


def _launch_dslash(links, cdiag, coff, phi, lattice, with_clover: bool,
                   parity=None, parity_offset: int = 0):
    _check(phi, links, *((cdiag, coff) if with_clover else ()))
    if links.dtype != phi.dtype or (with_clover and coff.dtype != phi.dtype):
        raise TypeError("links/clover and spinor dtypes differ")
    batch = _batched(phi, lattice)
    par = _parity_args(lattice, parity, parity_offset)
    out = torch.empty_like(phi)
    fn = getattr(kernels.lib(), f"ddaamg_dslash_{_SUFFIX[phi.dtype]}")
    kernels.launched("K1" if with_clover else "K2")
    rc = fn(out.data_ptr(), phi.data_ptr(), links.data_ptr(),
            cdiag.data_ptr() if with_clover else None,
            coff.data_ptr() if with_clover else None,
            *lattice, batch, int(with_clover), *par, kernels.stream_ptr(phi.device))
    kernels.check(rc, "dslash")
    return out


def d_plus_clover(links, cdiag, coff, phi, lattice):
    """K1: the Wilson-clover operator D phi."""
    if phi.device.type == "cpu":
        return fast.d_plus_clover_soa(links, cdiag, coff, phi, lattice)
    return _launch_dslash(links, cdiag, coff, phi, tuple(lattice), True)


def hopping(links, phi, lattice, parity=None, parity_offset: int = 0):
    """K2: the hopping term only; with a parity, on the sites of that
    parity only (zeros elsewhere)."""
    if phi.device.type == "cpu":
        return fast.dslash_hopping_soa(links, phi, lattice, parity, parity_offset)
    return _launch_dslash(links, None, None, phi, tuple(lattice), False, parity,
                          parity_offset)


def clover(cdiag, coff, phi, lattice, parity=None, parity_offset: int = 0,
           compact: bool = False):
    """K3: the packed clover (or clover inverse) per site; parity 0/1
    restricts the result to even/odd sites.  compact: cdiag / coff hold the
    sites of that parity only ([2, 6, V/2], [2, 15, V/2];
    fast.compact_parity)."""
    if compact and parity is None:
        raise ValueError("compact clover storage needs a parity")
    if phi.device.type == "cpu":
        return fast.clover_apply_soa(cdiag, coff, phi, lattice, parity,
                                     parity_offset, compact)
    _check(phi, cdiag, coff)
    if coff.dtype != phi.dtype or cdiag.dtype != phi.real.dtype:
        raise TypeError("clover and spinor dtypes differ")
    lattice = tuple(lattice)
    batch = _batched(phi, lattice)
    par = _parity_args(lattice, parity, parity_offset)
    columns = math.prod(lattice) // (2 if compact else 1)
    if cdiag.shape != (2, 6, columns) or coff.shape != (2, 15, columns):
        raise ValueError(f"clover shapes {tuple(cdiag.shape)}, {tuple(coff.shape)} do not "
                         f"hold {columns} sites")
    out = torch.empty_like(phi)
    fn = getattr(kernels.lib(), f"ddaamg_clover_{_SUFFIX[phi.dtype]}")
    kernels.launched("K3")
    rc = fn(out.data_ptr(), phi.data_ptr(), cdiag.data_ptr(), coff.data_ptr(),
            *lattice, batch, *par, int(compact), kernels.stream_ptr(phi.device))
    kernels.check(rc, "clover")
    return out
