"""Operations and bytes that each kernel's launch needs, by launch shape,
and the published peaks of one H100, so that a kernel's roofline share
reads the same work whatever implements it.

Counted from the work the inputs need, never from what a kernel reads:
every input byte once, every output byte once, the operations of the
arithmetic as written.  Complex numbers take 8 bytes in complex64, 16 in
complex128 and 4 as bf16 pairs.  No metric reads these yet; the bound of a
launch is max(bytes / MEM_BYTES_PER_S, operations / its peak).
"""

from __future__ import annotations

import math

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth; dense rates without sparsity
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12, "bf16_tensor": 989e12}
CPLX_BYTES = {"f32": 8, "f64": 16, "bf16": 4}
# flops per site and right-hand side: the Wilson hop 1320, the packed clover
# (two 6 x 6 complex blocks) 576
DSLASH_FLOPS = {"K1": 1320 + 576, "K2": 1320, "K3": 576}
# reals per site of the packed clover: two Hermitian 6 x 6 blocks
CLOVER_REALS = 72


def bound_s(work) -> float:
    """The least time of (bytes, operations, peak FLOP/s)."""
    moved, ops, peak = work
    return max(moved / MEM_BYTES_PER_S, ops / peak)


def dslash(kernel: str, lattice, batch: int, prec: str = "f32", parity: bool = False,
           links: bool = True, compact_clover: bool = False):
    """K1 (hop and clover), K2 (hop) or K3 (clover or its inverse): the
    links once (K1, K2), the packed clover once (K1, K3; half of it for a
    parity apply or for the compact odd-site inverse), the input field
    (half of it for a parity apply) and the output."""
    V = math.prod(lattice)
    c, r = CPLX_BYTES[prec], CPLX_BYTES[prec] // 2
    half = 2 if parity else 1
    field = 12 * V * batch * c
    moved = field + field // half
    if kernel in ("K1", "K2") and links:
        moved += 4 * 9 * V * c
    if kernel in ("K1", "K3"):
        moved += CLOVER_REALS * V * r // (2 if (parity or compact_clover) else 1)
    return moved, DSLASH_FLOPS[kernel] * V * batch // half, PEAK_FLOPS[prec]


def coarse_pairs(lattice, terms=(0, 9), mask=None, parity=None):
    """(term, site) pairs a coarse apply needs and the sites whose field it
    reads: hops that cross a mask block's face, and the other parity's
    sites, are skipped."""
    c = np.indices(lattice).reshape(4, -1)
    live = np.ones(c.shape[1], bool) if parity is None else (c.sum(0) % 2 == parity)
    pairs = 0
    for k in range(*terms):
        keep = live.copy()
        if k > 0 and mask is not None:
            mu = (k - 1) % 4
            rem = c[mu] % mask[mu]
            keep &= (rem != mask[mu] - 1) if k < 5 else (rem != 0)
        pairs += int(keep.sum())
    return pairs, int(live.sum())


def coarse(lattice, d: int, batch: int, blocks: str = "f32", field: str = "f32",
           terms=(0, 9), mask=None, parity=None, face_bytes: int = 0):
    """K4 / K5 (bf16 blocks: blocks="bf16"): the blocks of the needed
    (term, site) pairs, the field at the sites read and the whole output,
    the faces a K5 receives; 8 d^2 real operations a pair and lane."""
    V = math.prod(lattice)
    pairs, live = coarse_pairs(lattice, terms, mask, parity)
    moved = pairs * d * d * CPLX_BYTES[blocks] + batch * d * CPLX_BYTES[field] * (live + V)
    return moved + face_bytes, 8 * d * d * pairs * batch, PEAK_FLOPS[field]


def dense(nb: int, m: int, listed: int, batch: int):
    """K6 on `listed` of nb bf16 blocks of m x m: those blocks of A and of x
    once and the whole of y once; 8 listed m^2 f32 operations at batch 1,
    the three-way bf16 split's 3 x 8 listed m^2 batch on the tensor cores
    from two right-hand sides on."""
    c = CPLX_BYTES["f32"]
    moved = listed * m * m * CPLX_BYTES["bf16"] + (listed + nb) * m * batch * c
    if batch == 1:
        return moved, 8 * listed * m * m, PEAK_FLOPS["f32"]
    return moved, 3 * 8 * listed * m * m * batch, PEAK_FLOPS["bf16_tensor"]


def gcr_step(n: int, j: int, batch: int, prec: str = "f32"):
    """K7, one GCR iteration after the operator apply at row j: (2 j + 8) n
    complex elements a lane (the j basis rows of W and Q for the products
    and the update, w, q, r, x in and out); about 8 (2 j + 6) n real
    operations a lane."""
    moved = (2 * j + 8) * n * batch * CPLX_BYTES[prec]
    return moved, 8 * (2 * j + 6) * n * batch, PEAK_FLOPS[prec]
