"""Odd-even (site-parity) preconditioning of the fine operator: method 4
(the JAX package's operators/oddeven.py; reference src/oddeven_generic.c).

In parity-blocked form

    D = [ A_ee  D_eo ]
        [ D_oe  A_oo ]

with A the clover (per site) and the hopping term coupling opposite
parities only.  The even-site Schur complement S = A_ee - D_eo A_oo^-1 D_oe
is solved with GMRES, then the odd sites are reconstructed
(solve_oddeven_PRECISION, src/oddeven_generic.c:743-866).  Even sites are
those with (t + z + y + x) % 2 == 0, as in the JAX package.

Every piece is one kernel on the fine WilsonStencilSoA, restricted to the
sites of one parity (zeros at the others): D_eo / D_oe is K2 on the full
links with a parity (the result on even / odd sites reads only the other
parity's sites, so no input mask is needed), A_oo^-1 is K3 on the compact
odd-site clover inverse, A_ee is K3 on the clover with the even parity.
Fields stay whole [*, 12, V], with zeros on the sites of the other parity.
The parity kernels need an even x extent, which the stencil's compact
inverse already asks for.

On a slab (a stencil with a mesh) the parities count global coordinates
(the slab's offset parity, mesh.parity), D_eo / D_oe add the face
corrections of the split axes on the sites of their parity
(parallel/shard_ops.wilson_hopping), and the GMRES takes global inner
products.
"""

from __future__ import annotations

import dataclasses

from ..parallel import shard_ops
from ..solvers.fgmres import fgmres
from . import cuda_dslash
from .stencil import EVEN, ODD, WilsonStencilSoA


class OddEvenOperator:
    """The parity pieces of the fine Wilson-clover operator of a stencil (a
    rank's slab of it under a mesh)."""

    def __init__(self, s: WilsonStencilSoA):
        self.s = s

    @property
    def even(self):
        return self.s.even

    def diag_ee(self, v):
        """A_ee v (even sites)."""
        s = self.s
        return cuda_dslash.clover(s.cdiag, s.coff, v, s.lattice, EVEN, s.parity_offset)

    def diag_oo_inv(self, v):
        """A_oo^-1 v (odd sites)."""
        return self.s.self_inv(v, ODD)

    def _hop(self, v, parity):
        s = self.s
        if s.mesh is not None:
            return shard_ops.wilson_hopping(s.mesh, s.links, v, s.lattice, parity)
        return cuda_dslash.hopping(s.links, v, s.lattice, parity, s.parity_offset)

    def hop_from_odd(self, v):
        """D_eo v: the hopping term on the even sites, from v's odd sites."""
        return self._hop(v, EVEN)

    def hop_from_even(self, v):
        """D_oe v: the hopping term on the odd sites, from v's even sites."""
        return self._hop(v, ODD)

    def schur(self, v):
        """S v = A_ee v - D_eo A_oo^-1 D_oe v on the even sites
        (apply_schur_complement_PRECISION, src/oddeven_generic.c:704-741)."""
        return self.diag_ee(v) - self.hop_from_odd(self.diag_oo_inv(self.hop_from_even(v)))

    def full(self, v):
        return self.s.full_op(v)

    def even_rhs(self, b):
        """b_e - D_eo A_oo^-1 b_o on the even sites."""
        return self.even * b - self.hop_from_odd(self.diag_oo_inv(b))

    def reconstruct(self, b, x_e):
        """x = x_e + A_oo^-1 (b_o - D_oe x_e)."""
        x_e = self.even * x_e
        return x_e + self.diag_oo_inv(b - self.hop_from_even(x_e))


def solve_oddeven(oe: OddEvenOperator, b, tol=1e-10, restart_length=50,
                  max_restarts=20):
    """D x = b through the even-site Schur complement: GMRES on S x_e = b_e',
    then the odd reconstruction (solve_oddeven_PRECISION)."""
    res = fgmres(oe.schur, oe.even_rhs(b), tol=tol, restart_length=restart_length,
                 max_restarts=max_restarts, mesh=oe.s.mesh)
    return dataclasses.replace(res, x=oe.reconstruct(b, res.x))


class OddEvenPreconditioner:
    """Method 4's preconditioner: block_iter GMRES iterations (cycles
    restarts) on the even-site Schur complement and the odd reconstruction,
    in the stencil's precision (the reference's preconditioner for method
    >= 4, src/preconditioner.c:38-63; restart length = block iter,
    restarts = preconditioner cycles, src/schwarz_generic.c:78-84)."""

    def __init__(self, s: WilsonStencilSoA, block_iter: int = 4, cycles: int = 1):
        self.oe = OddEvenOperator(s)
        self.block_iter = block_iter
        self.cycles = cycles

    def __call__(self, eta):
        return solve_oddeven(self.oe, eta.to(self.oe.s.dtype), tol=0.0,
                             restart_length=self.block_iter, max_restarts=self.cycles).x
