"""Wrappers of the Wilson-clover kernels K1-K3 (csrc/dslash.cu) and the
clover packing they read.

Each wrapper takes the plain version (operators/fast.py) for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  Inputs may carry a
leading batch axis: phi [B, 12, V] or [12, V].
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


def _launch_dslash(links, cdiag, coff, phi, lattice, with_clover: bool):
    _check(phi, links, *((cdiag, coff) if with_clover else ()))
    if links.dtype != phi.dtype or (with_clover and coff.dtype != phi.dtype):
        raise TypeError("links/clover and spinor dtypes differ")
    batch = _batched(phi, lattice)
    out = torch.empty_like(phi)
    fn = getattr(kernels.lib(), f"ddaamg_dslash_{_SUFFIX[phi.dtype]}")
    kernels.KERNELS["K1" if with_clover else "K2"].launches += 1
    rc = fn(out.data_ptr(), phi.data_ptr(), links.data_ptr(),
            cdiag.data_ptr() if with_clover else None,
            coff.data_ptr() if with_clover else None,
            *lattice, batch, int(with_clover), kernels.stream_ptr(phi.device))
    kernels.check(rc, "dslash")
    return out


def d_plus_clover(links, cdiag, coff, phi, lattice):
    """K1: the Wilson-clover operator D phi."""
    if phi.device.type == "cpu":
        return fast.d_plus_clover_soa(links, cdiag, coff, phi, lattice)
    return _launch_dslash(links, cdiag, coff, phi, tuple(lattice), True)


def hopping(links, phi, lattice):
    """K2: the hopping term only."""
    if phi.device.type == "cpu":
        return fast.dslash_hopping_soa(links, phi, lattice)
    return _launch_dslash(links, None, None, phi, tuple(lattice), False)


def clover(cdiag, coff, phi, lattice, parity=None, parity_offset: int = 0):
    """K3: the packed clover (or clover inverse) per site; parity 0/1
    restricts the result to even/odd sites, counted on the global lattice
    whose coordinate sum at local site 0 has the parity of parity_offset."""
    if phi.device.type == "cpu":
        return fast.clover_apply_soa(cdiag, coff, phi, lattice, parity,
                                     parity_offset)
    _check(phi, cdiag, coff)
    if coff.dtype != phi.dtype or cdiag.dtype != phi.real.dtype:
        raise TypeError("clover and spinor dtypes differ")
    lattice = tuple(lattice)
    batch = _batched(phi, lattice)
    out = torch.empty_like(phi)
    fn = getattr(kernels.lib(), f"ddaamg_clover_{_SUFFIX[phi.dtype]}")
    kernels.KERNELS["K3"].launches += 1
    rc = fn(out.data_ptr(), phi.data_ptr(), cdiag.data_ptr(), coff.data_ptr(),
            *lattice, batch, -1 if parity is None else int(parity),
            int(parity_offset) & 1, kernels.stream_ptr(phi.device))
    kernels.check(rc, "clover")
    return out

