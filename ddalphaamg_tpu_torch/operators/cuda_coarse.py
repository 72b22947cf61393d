"""Wrappers of the coarse-operator kernels K4 and K5, of their bf16-block
instances K4-bf16 and K5-bf16, and of K4-schur, the coarsest level's Schur
complement on parity-split blocks (csrc/coarse.cu).

For tensors on the CPU they take the plain versions
(operators/coarse.coarse_apply_plain / coarse_apply_halo_plain); for CUDA
tensors they launch the kernel or raise.  Fields may carry a leading batch
axis: v [B, d, V].  The block dtype picks the instance: complex blocks of
the field's dtype (complex64 or complex128), or bf16 pairs [K, d, d, V, 2]
(operators/coarse.compress) with complex64 fields.  Every other
combination raises, complex128 fields with bf16 blocks included (the JAX
package compresses only its f32 accelerator path).

Each entry point holds two kernels (csrc/coarse.cu): one for a single
right-hand side and one for a batch of them.  The C launcher picks one by
the batch and the lattice size; `kernel="batch1"` or `kernel="multi"` names
one instead (the kernel tests and the probe script run both on every
shape; the port never does).  A call while a CUDA graph is captured
(the coarsest GCR, mg/coarsest.py) records its launch into the graph
instead of counting it (kernels.launched).
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from .coarse import coarse_apply_halo_plain, coarse_apply_plain, schur_split_plain

_SUFFIX = {torch.complex64: "f32", torch.complex128: "f64"}
_REGIME = {None: 0, "batch1": 1, "multi": 2}
# the launcher's crossover (csrc/coarse.cu): the multi-right-hand-side
# kernel from this batch on, at B1_WIDE sites or more and below
B1_WIDE, MRHS_MIN_BATCH_WIDE, MRHS_MIN_BATCH = 2048, 6, 12


def batch1_regime(v, V: int) -> bool:
    """Whether K4's launcher would pick its batch-1 kernel for the lanes of
    v [*B, d, V] (regime 0's rule)."""
    batch = v.numel() // (v.shape[-2] * V)
    return batch < (MRHS_MIN_BATCH_WIDE if V >= B1_WIDE else MRHS_MIN_BATCH)


def _instance(blocks, v) -> str:
    """The kernel name suffix of a (blocks, field) dtype pair."""
    if blocks.dtype == torch.bfloat16 and v.dtype == torch.complex64:
        return "bf16"
    if v.dtype in _SUFFIX and blocks.dtype == v.dtype:
        return _SUFFIX[v.dtype]
    raise TypeError(f"coarse kernel takes complex64/complex128 blocks of the field's "
                    f"dtype or bf16 blocks with complex64 fields, got {blocks.dtype} "
                    f"and {v.dtype}")


def _check(blocks, v, lattice, terms, others=()):
    inst = _instance(blocks, v)
    for t in (blocks, *others):
        if t.device != v.device:
            raise ValueError("blocks, field and faces must share a device")
    for f in others:
        if f.dtype != v.dtype:
            raise ValueError("faces must have the field's dtype")
    if not all(t.is_contiguous() for t in (blocks, v, *others)):
        raise ValueError("operands must be contiguous")
    K, d, d2, V = blocks.shape[:4]
    if (d != d2 or V != math.prod(lattice) or v.shape[-2:] != (d, V)
            or blocks.shape[4:] != ((2,) if inst == "bf16" else ())):
        raise ValueError(f"shapes {tuple(blocks.shape)} / {tuple(v.shape)} "
                         f"do not match lattice {lattice}")
    k0, k1 = terms
    if not 0 <= k0 < k1 <= K:
        raise ValueError(f"terms {terms} outside [0, {K})")
    return inst, d, V, int(v.numel() // (d * V))


def coarse_apply(blocks, v, lattice, terms=(0, 9), mask_block=None,
                 parity=None, parity_offset: int = 0, kernel=None):
    """K4: sum over the block terms [k0, k1) of blocks [K, d, d, V] applied
    to the neighbor fields of v; mask_block (bt, bz, by, bx) drops hops that
    cross a block face; parity 0/1 keeps only the sites of that parity
    (meaningful for the self term), counted on the global lattice whose
    coordinate sum at local site 0 has the parity of parity_offset; kernel
    as in the module note."""
    lattice = tuple(lattice)
    k0, k1 = terms
    if parity is not None and (k0, k1) != (0, 1):
        raise ValueError("parity selection applies to the self term only")
    if v.device.type == "cpu":
        return coarse_apply_plain(blocks, v, lattice, terms, mask_block,
                                  parity, parity_offset)
    inst, d, V, batch = _check(blocks, v, lattice, terms)
    out = torch.empty_like(v)
    mb = tuple(mask_block) if mask_block is not None else (0, 0, 0, 0)
    fn = getattr(kernels.lib(), f"ddaamg_coarse_{inst}")
    kernels.launched("K4-bf16" if inst == "bf16" else "K4")
    rc = fn(out.data_ptr(), v.data_ptr(), blocks.data_ptr(), d, k0, k1,
            *lattice, *mb, -1 if parity is None else int(parity),
            int(parity_offset) & 1, batch, _REGIME[kernel], kernels.stream_ptr(v.device))
    kernels.check(rc, "coarse")
    return out


def coarse_apply_halo(blocks, v, lattice, halos, terms=(0, 9), kernel=None):
    """K5: the terms [k0, k1) on one slab of a sharded lattice; halos =
    {mu: (fwd, bwd)} for the sharded axes mu among t, z, y, x (0-3), each
    face [*batch, d, V / lattice[mu]] (operators/coarse.py describes them);
    kernel as in the module note."""
    lattice = tuple(lattice)
    if not halos or any(mu not in range(4) for mu in halos):
        raise ValueError(f"K5 takes faces of the axes 0-3, got {sorted(halos)}")
    if v.device.type == "cpu":
        return coarse_apply_halo_plain(blocks, v, lattice, halos, terms)
    faces = [f for mu in sorted(halos) for f in halos[mu]]
    inst, d, V, batch = _check(blocks, v, lattice, terms, faces)
    for mu, pair in halos.items():
        for f in pair:
            if f.numel() != batch * d * (V // lattice[mu]):
                raise ValueError(f"face {tuple(f.shape)} does not match a "
                                 f"[{batch}, {d}, {V // lattice[mu]}] face of axis {mu}")
    ptr = {mu: tuple(f.data_ptr() for f in pair) for mu, pair in halos.items()}
    none = (None, None)
    out = torch.empty_like(v)
    fn = getattr(kernels.lib(), f"ddaamg_coarse_halo_{inst}")
    kernels.launched("K5-bf16" if inst == "bf16" else "K5")
    rc = fn(out.data_ptr(), v.data_ptr(), blocks.data_ptr(),
            *(p for mu in range(4) for p in ptr.get(mu, none)), d, *terms, *lattice, batch,
            _REGIME[kernel], kernels.stream_ptr(v.device))
    kernels.check(rc, "coarse halo")
    return out


def schur_split(E, O, v, lattice):
    """K4-schur: the even-site Schur complement A_ee v_e - sum_k hop_k
    A_oo^-1 sum_k hop_k v_e of v [*B, d, V], zero on the odd sites, from
    the parity-split blocks E, O [9, d, d, V/2] (operators/coarse.
    split_blocks; every extent even) in two launches, each counted under
    K4-schur: A_oo^-1 of the hops on the odd sites into a compact
    temporary, then the even sites."""
    lattice = tuple(lattice)
    if v.device.type == "cpu":
        return schur_split_plain(E, O, v, lattice)
    inst = _instance(E, v)
    V = math.prod(lattice)
    d = E.shape[1]
    if (O.dtype != E.dtype or O.shape != E.shape or E.shape[:4] != (9, d, d, V // 2)
            or E.shape[4:] != ((2,) if inst == "bf16" else ()) or v.shape[-2:] != (d, V)
            or any(n % 2 for n in lattice)):
        raise ValueError(f"split blocks {tuple(E.shape)} / {tuple(O.shape)} and field "
                         f"{tuple(v.shape)} do not match lattice {lattice}")
    if not all(t.is_contiguous() and t.device == v.device for t in (E, O, v)):
        raise ValueError("split blocks and field must be contiguous on one device")
    batch = v.numel() // (d * V)
    out = torch.empty_like(v)
    t = torch.empty((batch, d, V // 2), dtype=v.dtype, device=v.device)
    fn = getattr(kernels.lib(), f"ddaamg_schur_{inst}")
    for phase in (1, 2):
        kernels.launched("K4-schur")
        rc = fn(out.data_ptr(), t.data_ptr(), v.data_ptr(), E.data_ptr(), O.data_ptr(), d,
                *lattice, batch, phase, kernels.stream_ptr(v.device))
        kernels.check(rc, "schur")
    return out
