"""Red-black multiplicative Schwarz (SAP) smoother, generic over levels.

Reference: src/schwarz_generic.c (red_black_schwarz_PRECISION, :1260-1430)
with block solvers local_minres_PRECISION (src/linsolve_generic.c:985-1029)
and block_solve_oddeven_PRECISION (src/oddeven_generic.c:1332-1362).

A Schwarz block's operator is the level operator with all block-crossing
couplings masked to zero, so solving every block of one color at once is one
whole-lattice masked stencil apply; block inner products are per-block
reductions.  The multiplicative residual update is the global
r <- r - D delta with the full operator after each color.  Fields may carry
a leading batch axis (the initial test-vector smoothing and the batched
cycles run all their right-hand sides at once).

On a sharded level (a stencil with a mesh) the colors come from global block
coordinates, as slabs of the global color masks; block solves and their
reductions stay on the rank, and the residual update goes through the
sharded full operator.

With precomputed block inverses (MGConfig.smoother_direct; the JAX
package's sap.py:110-194) a block solve is exact: one batched matvec
against the [nblocks, m, m] inverses of the block-restricted operator,
m = block volume x dof (operators/cuda_dense.py), instead of block_iter
MinRes sweeps.  Blocks divide a slab, so a sharded level builds the
inverses of its own blocks without communication.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry import Geometry
from ..operators import cuda_dense
from ..operators.coarse import compress
from ..operators.stencil import EVEN, ODD

COLUMNS_PER_BATCH = 128   # one-hot columns per batched block_op of an inverse build


def color_masks(geom: Geometry, scheme: str = "red_black") -> list[np.ndarray]:
    """Site-level color masks [T,Z,Y,X] from the block coloring.

    schemes (reference method 1/2/3, src/schwarz_generic.c:1077/1260/1652):
      additive      -- one color (all blocks solved from the same residual)
      red_black     -- two colors by block parity (red = parity 0)
      sixteen_color -- 2^4 classes by per-dimension block-coordinate parity
    """
    if scheme == "additive":
        return [np.ones(geom.lattice, dtype=np.float64)]
    grids = np.meshgrid(*[np.arange(n) for n in geom.block_grid], indexing="ij")
    if scheme == "red_black":
        site = sum(grids) % 2
        ncolors, color_of = 2, site
    elif scheme == "sixteen_color":
        # visit order of the reference (src/schwarz_generic.c:337-339):
        # step k solves the blocks whose block-coordinate parity pattern
        # p = 8(t%2)+4(z%2)+2(y%2)+(x%2) equals sigma[k]; multiplicative
        # Schwarz results depend on this order, so it is kept verbatim
        sigma = [0, 1, 3, 2, 6, 4, 5, 7, 15, 14, 12, 13, 9, 11, 10, 8]
        pattern = (((grids[0] % 2) << 3) + ((grids[1] % 2) << 2)
                   + ((grids[2] % 2) << 1) + (grids[3] % 2))
        color_of = np.zeros_like(pattern)
        for k, p in enumerate(sigma):
            color_of[pattern == p] = k
        ncolors = 16
    else:
        raise ValueError(scheme)
    masks = []
    for c in range(ncolors):
        m = (color_of == c).astype(np.float64)
        for mu in range(4):
            m = np.repeat(m, geom.block[mu], axis=mu)
        masks.append(m)
    return masks


def _alpha(s, Dr, r):
    """Per-block alpha = <Dr, r> / <Dr, Dr>, broadcast back to sites."""
    num = s.block_sum(s.dof_sum(Dr.conj() * r))
    den = s.block_sum(s.dof_sum((Dr.conj() * Dr).real))
    alpha = num / torch.where(den == 0, torch.ones_like(den), den)
    return s.block_expand(alpha)


def _minres(s, r, block_op, block_iter: int):
    """local_minres on every block at once (zero blocks stay zero)."""
    delta = torch.zeros_like(r)
    for _ in range(block_iter):
        Dr = block_op(r)
        a = _alpha(s, Dr, r)
        delta = delta + a * r
        r = r - a * Dr
    return delta


def _block_schur(s, v):
    """Per-block Schur complement on even sites (block odd-even).  Each hop
    maps one parity to the other and is read on one parity only, so it is
    asked for that parity (the fine stencil computes only those sites)."""
    ve = s.even * v
    out = s.even * s.self_op(ve)
    t = s.self_inv(s.hop_intra(ve, ODD), ODD)
    return out - s.even * s.hop_intra(t, EVEN)


def to_blocks(v, geom: Geometry):
    """[*, d, V] -> [*, nblocks, block_vol * d]: blocks lexicographic on the
    block grid, entries (site in the block, lexicographic; dof) in the JAX
    package's order (sap.to_blocks)."""
    bt, bz, by, bx = geom.block
    gt, gz, gy, gx = geom.block_grid
    n, d = v.dim() - 2, v.shape[-2]
    x = v.reshape(*v.shape[:-2], d, gt, bt, gz, bz, gy, by, gx, bx)
    x = x.permute(*range(n), n + 1, n + 3, n + 5, n + 7, n + 2, n + 4, n + 6, n + 8, n)
    return x.reshape(*v.shape[:-2], gt * gz * gy * gx, -1)


def from_blocks(x, geom: Geometry, d: int):
    """Inverse of to_blocks: [*, nblocks, block_vol * d] -> [*, d, V]."""
    bt, bz, by, bx = geom.block
    gt, gz, gy, gx = geom.block_grid
    n = x.dim() - 2
    v = x.reshape(*x.shape[:-2], gt, gz, gy, gx, bt, bz, by, bx, d)
    v = v.permute(*range(n), n + 8, n, n + 4, n + 1, n + 5, n + 2, n + 6, n + 3, n + 7)
    return v.reshape(*x.shape[:-2], d, -1)


def build_block_inverse(s, bf16: bool = False):
    """Inverses of the Schwarz-block-restricted operator of a coarse
    stencil, [nblocks, m, m] (complex in the stencil's dtype, or rounded to
    bf16 pairs [nblocks, m, m, 2]).  Column k of every block comes from one
    block_op (masked K4) of the field that is 1 at entry k of each block;
    the columns run through the kernels' batch axis, COLUMNS_PER_BATCH at a
    time, and the blocks are inverted by one batched torch.linalg.inv."""
    geom, d = s.geom, s.dof
    nb = math.prod(geom.block_grid)
    m = math.prod(geom.block) * d
    M = torch.empty((nb, m, m), dtype=s.dtype, device=s.device)   # [b, row, col]
    for c0 in range(0, m, COLUMNS_PER_BATCH):
        c = min(COLUMNS_PER_BATCH, m - c0)
        e = torch.zeros((c, nb, m), dtype=s.dtype, device=s.device)
        k = torch.arange(c, device=s.device)
        e[k, :, c0 + k] = 1
        M[:, :, c0:c0 + c] = to_blocks(s.block_op(from_blocks(e, geom, d)), geom).permute(1, 2, 0)
    inv = torch.linalg.inv(M)
    return compress(inv) if bf16 else inv


def color_blocks(mask, geom: Geometry):
    """The blocks of a color, int32 [nc] in to_blocks order, from its
    site-level mask [V] (on a slab: the slab's mask and geometry)."""
    first = to_blocks(mask.reshape(1, -1), geom)[:, 0]     # a site of each block
    return torch.nonzero(first != 0).reshape(-1).to(torch.int32)


def apply_block_inverse(s, binv, r, blocks=None):
    """delta = blockD^-1 r (r [*B, d, V] masked to one color) by one
    product with the block inverses for all right-hand sides, on the
    color's blocks (int32 list, color_blocks; None: all blocks); the other
    blocks stay zero."""
    rb = to_blocks(r, s.geom)
    return from_blocks(cuda_dense.matvec(binv, rb, blocks), s.geom, s.dof)


def _block_solve(s, r, block_iter: int, odd_even: bool, block_inv=None, blocks=None):
    """Block solve of blockD delta = r (r masked to one color, whose blocks
    `blocks` lists): exact with the precomputed block inverses, else the
    reference's approximate local MinRes or block odd-even Schur MinRes."""
    if block_inv is not None:
        return apply_block_inverse(s, block_inv, r, blocks)
    if not odd_even:
        return _minres(s, r, s.block_op, block_iter)
    d_o1 = s.self_inv(r, ODD)
    r_e = s.even * (r - s.hop_intra(d_o1, EVEN))
    d_e = _minres(s, r_e, lambda v: _block_schur(s, v), block_iter)
    d_o = s.self_inv(r - s.hop_intra(s.even * d_e, ODD), ODD)
    return s.even * d_e + d_o


def _sweep(s, x, r, colors, cycles: int, block_iter: int, odd_even: bool,
           block_inv=None, blocks=None):
    """cycles sweeps over the colors (blocks: each color's block list, or
    None); the last step skips the residual update."""
    seq = list(zip(colors, blocks or (None,) * len(colors))) * cycles
    for mask, listed in seq[:-1]:
        delta = _block_solve(s, mask * r, block_iter, odd_even, block_inv, listed)
        x = x + delta
        r = r - s.full_op(delta)
    mask, listed = seq[-1]
    return x + _block_solve(s, mask * r, block_iter, odd_even, block_inv, listed)


def sap_smooth(s, colors, eta, cycles: int, block_iter: int, odd_even: bool,
               block_inv=None, blocks=None):
    """M(eta) from a zero initial guess (preconditioner application)."""
    return _sweep(s, torch.zeros_like(eta), eta, colors, cycles, block_iter,
                  odd_even, block_inv, blocks)


def sap_smooth_from(s, colors, eta, x, cycles: int, block_iter: int,
                    odd_even: bool, block_inv=None, blocks=None):
    """Post-smoothing with initial guess x (reference smoother _RES path)."""
    r = eta - s.full_op(x)
    return _sweep(s, x, r, colors, cycles, block_iter, odd_even, block_inv, blocks)


class SchwarzPreconditioner:
    """SAP smoother of one multigrid level: block_iter MinRes steps per block
    solve, `cycles` sweeps, block odd-even Schur solves when odd_even.
    `colors` holds the site masks of the colors on the level's (slab's)
    sites, `blocks` the int32 block list of each (None with one color: all
    blocks), which the direct block solves read, checked here."""

    def __init__(self, stencil, block_iter: int = 4, cycles: int = 1,
                 odd_even: bool = True, scheme: str = "red_black"):
        self.s = stencil
        self.block_iter = block_iter
        self.cycles = cycles
        self.odd_even = odd_even
        rdtype = stencil.even.dtype
        self.colors = tuple(
            stencil.slab(torch.as_tensor(m.reshape(-1), dtype=rdtype,
                                         device=stencil.device))
            for m in color_masks(stencil.global_geom, scheme))
        self.blocks = (None if len(self.colors) == 1 else
                       tuple(color_blocks(c, stencil.geom) for c in self.colors))
        # K6 reads a list's contents from the device once (check_blocks):
        # here, so that no captured colour step reads it
        for listed in self.blocks or ():
            cuda_dense.check_blocks(listed, math.prod(stencil.geom.block_grid),
                                    stencil.device)

    def __call__(self, eta, cycles: int | None = None):
        return sap_smooth(self.s, self.colors, eta.to(self.s.dtype),
                          cycles or self.cycles, self.block_iter, self.odd_even)

    def replace_stencil(self, stencil):
        self.s = stencil
