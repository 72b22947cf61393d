"""Wilson-clover Dirac operator in the logical site-major layout.

Operator convention (the reference's, src/dirac_generic.c:159-278):

    eta(x) = C(x) phi(x)
             - sum_mu [ D_mu(x)   (1 - gamma_mu) phi(x + mu)
                      + D_mu(x-mu)^dagger (1 + gamma_mu) phi(x - mu) ]

with D_mu = U_mu / 2 (links pre-scaled by 1/2, src/dirac.c:80) and C the
clover site matrix including the (4 + m0) diagonal.  The anti-periodic time
sign is folded into U_T on the last time slice, so neighbor access is a
periodic roll.

Layout: phi [T, Z, Y, X, 4, 3]; links [4, T, Z, Y, X, 3, 3];
clover [T, Z, Y, X, 2, 6, 6].  This logical form is the setup-time and test
representation; the solver runs the dof-major layout of operators/fast.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..gamma import get_basis


class WilsonOperator(NamedTuple):
    """links = U / 2, [4, T, Z, Y, X, 3, 3]; clover [T, Z, Y, X, 2, 6, 6]."""

    links: torch.Tensor
    clover: torch.Tensor

    @classmethod
    def from_gauge(cls, U: torch.Tensor, m0: float, csw: float) -> "WilsonOperator":
        from ..gauge import compute_clover
        U = U.to(torch.complex128)
        return cls(links=0.5 * U, clover=compute_clover(U, m0, csw))

    @property
    def lattice(self):
        return tuple(self.links.shape[1:5])


def clover_apply(clover, phi):
    """eta = C phi with C stored as two 6x6 chirality blocks."""
    lat = phi.shape[:4]
    ph = phi.reshape(*lat, 2, 6)
    return torch.einsum("...cij,...cj->...ci", clover, ph).reshape(*lat, 4, 3)


def dslash_hopping(links, phi):
    """The hopping term, directly from the projector definition."""
    gam = torch.as_tensor(get_basis().dense, dtype=phi.dtype, device=phi.device)
    eye = torch.eye(4, dtype=phi.dtype, device=phi.device)
    eta = torch.zeros_like(phi)
    for mu in range(4):
        pf = torch.roll(phi, -1, mu)
        eta -= torch.einsum("...ab,st,...tb->...sa", links[mu], eye - gam[mu], pf)
        hb = torch.einsum("...ba,st,...tb->...sa", links[mu].conj(),
                          eye + gam[mu], phi)
        eta -= torch.roll(hb, 1, mu)
    return eta


def d_plus_clover(op: WilsonOperator, phi):
    """Full Wilson-clover operator D phi (reference d_plus_clover_PRECISION)."""
    return clover_apply(op.clover, phi) + dslash_hopping(op.links, phi)


def gamma5(phi):
    """gamma5 phi = diag(-1, -1, +1, +1)_spin phi (src/dirac_generic.c:288-297)."""
    return torch.cat([-phi[..., 0:2, :], phi[..., 2:4, :]], dim=-2)


def g5_d_plus_clover(op: WilsonOperator, phi):
    """gamma5 D phi, the Hermitian-indefinite form (g5D_plus_clover)."""
    return gamma5(d_plus_clover(op, phi))


def d_dagger(op: WilsonOperator, phi):
    """D^dagger phi = gamma5 D gamma5 phi (src/dirac_generic.c:281-285)."""
    return gamma5(d_plus_clover(op, gamma5(phi)))


def shift_diagonal(op: WilsonOperator, delta: float) -> WilsonOperator:
    """The operator with delta added to its mass diagonal, C + delta I_12
    (the reference's shift_update, src/dirac_generic.c:504-551)."""
    eye = torch.eye(6, dtype=op.clover.dtype, device=op.clover.device)
    return WilsonOperator(op.links, op.clover + delta * eye)
