"""Wrapper of the coarse-operator kernel K4 (csrc/coarse.cu).

For tensors on the CPU it takes the plain version
(operators/coarse.coarse_apply_plain); for CUDA tensors it launches the
kernel or raises.  Fields may carry a leading batch axis: v [B, d, V].
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from .coarse import coarse_apply_plain

_SUFFIX = {torch.complex64: "f32", torch.complex128: "f64"}


def coarse_apply(blocks, v, lattice, terms=(0, 9), mask_block=None,
                 parity=None):
    """K4: sum over the block terms [k0, k1) of blocks [K, d, d, V] applied
    to the neighbor fields of v; mask_block (bt, bz, by, bx) drops hops that
    cross a block face; parity 0/1 keeps only the sites of that parity
    (meaningful for the self term)."""
    lattice = tuple(lattice)
    k0, k1 = terms
    if parity is not None and (k0, k1) != (0, 1):
        raise ValueError("parity selection applies to the self term only")
    if v.device.type == "cpu":
        return coarse_apply_plain(blocks, v, lattice, terms, mask_block,
                                  parity)
    if v.dtype not in _SUFFIX or blocks.dtype != v.dtype:
        raise TypeError(f"coarse kernel takes matching complex64/complex128 "
                        f"operands, got {blocks.dtype} and {v.dtype}")
    if blocks.device != v.device:
        raise ValueError("blocks and field must be on one device")
    if not (blocks.is_contiguous() and v.is_contiguous()):
        raise ValueError("operands must be contiguous")
    K, d, d2, V = blocks.shape
    if d != d2 or V != math.prod(lattice) or v.shape[-2:] != (d, V):
        raise ValueError(f"shapes {tuple(blocks.shape)} / {tuple(v.shape)} "
                         f"do not match lattice {lattice}")
    if not 0 <= k0 < k1 <= K:
        raise ValueError(f"terms {terms} outside [0, {K})")
    batch = int(v.numel() // (d * V))
    out = torch.empty_like(v)
    mb = tuple(mask_block) if mask_block is not None else (0, 0, 0, 0)
    fn = getattr(kernels.lib(), f"ddaamg_coarse_{_SUFFIX[v.dtype]}")
    kernels.KERNELS["K4"].launches += 1
    rc = fn(out.data_ptr(), v.data_ptr(), blocks.data_ptr(), d, k0, k1,
            *lattice, *mb, -1 if parity is None else int(parity), batch,
            kernels.stream_ptr(v.device))
    kernels.check(rc, "coarse")
    return out
