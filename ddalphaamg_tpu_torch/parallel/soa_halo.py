"""Face corrections of the sharded fine operator (the JAX package's
_face_corrections, ddalphaamg_tpu/parallel/soa_halo.py:131-156).

Each rank runs the unmodified local kernel (K1 or K2), which wraps every
axis periodically inside its slab, and then corrects the slab's faces along
each split axis mu, any of t, z, y and x (the gamma tables are per mu):

  forward  (last local slice): the kernel read its own first slice where it
    needed the +mu neighbor's.  The neighbor sends its first slice projected
    to a half-spinor, (1 - gamma_mu) phi, and the correction is
    -U(x) [h_received - h_own], lifted back to four spins.
  backward (first local slice): the kernel read U^H (1 + gamma_mu) phi of
    its own last slice where it needed the -mu neighbor's.  Each rank forms
    w = U^H(x) (1 + gamma_mu) phi(x) on its last slice and sends it to +mu
    (the reference's pre-multiplied prp buffer, src/ghost_generic.c:99-104),
    a half-spinor per face site as well.

These are plain torch operations on faces, in the field's own precision
(complex64 in the inner solves, complex128 for the outer true residual).
A face keeps the four site axes, one of extent 1: a face cut along y or x
is strided in the field, and comm.exchange sends a contiguous copy of it,
so sender and receiver agree on the lexicographic order of the three other
coordinates.  With a parity (method 4's D_eo / D_oe on a slab) only the
face sites of that parity are corrected.
"""

from __future__ import annotations

import torch

from ..operators.fast import _cached_mask, _gamma_tables
from .comm import exchange
from .mesh import active_axes


def _half(q, mu, sign, co, val):
    """[*, 4, 3, t, z, y, x] -> the half-spinor [*, 2, 3, t, z, y, x] of
    (1 + sign gamma_mu) q: rows q[s] + sign val[mu, s] q[co[mu, s]]."""
    sp = q.dim() - 6
    idx = torch.as_tensor(co[mu][:2], device=q.device)
    return q.narrow(sp, 0, 2) + sign * val[mu, :2].reshape(2, 1, 1, 1, 1, 1) * q.index_select(sp, idx)


def _lift(h, mu, sign, co, val):
    """Half-spinor rows -> the [*, 4, 3, t, z, y, x] contribution of the
    hop: rows 0, 1 = -h, rows 2, 3 = -sign val[mu, s] h[co[mu, s]]."""
    sp = h.dim() - 6
    idx = torch.as_tensor(co[mu][2:], device=h.device)
    low = (-sign) * val[mu, 2:].reshape(2, 1, 1, 1, 1, 1) * h.index_select(sp, idx)
    return torch.cat([-h, low], sp)


def face_corrections(mesh, links, phi, out, lattice, parity=None):
    """Correct out = K(links, phi) of a local kernel on one slab, in place,
    to the hop of the global lattice; returns out.  phi, out [*, 12, V_l];
    links [4, 3, 3, V_l] (the hop's links; masked links stay masked).  With
    a parity (0 even, 1 odd, counted from the slab's global offset) out
    holds the sites of that parity only, and only those are corrected."""
    p = phi.reshape(*phi.shape[:-2], 4, 3, *lattice)
    o = out.view(p.shape)
    u = links.reshape(4, 3, 3, *lattice)
    co, val = _gamma_tables(phi.device, phi.dtype)
    keep = None
    if parity is not None:
        keep = _cached_mask(tuple(lattice), int(parity), mesh.parity(lattice),
                            p.real.dtype, p.device).reshape(lattice)
    for mu in active_axes(mesh, mesh.global_lattice(lattice)):
        n = lattice[mu]
        ax = p.dim() - 4 + mu
        u_last = u[mu].narrow(2 + mu, n - 1, 1)
        h_first = _half(p.narrow(ax, 0, 1), mu, -1, co, val)
        w_last = torch.einsum("BAtzyx,...sBtzyx->...sAtzyx", u_last.conj(),
                              _half(p.narrow(ax, n - 1, 1), mu, +1, co, val))
        recv_h, recv_w = exchange(mesh, mu, to_minus=h_first, to_plus=w_last)
        fwd = _lift(torch.einsum("ABtzyx,...sBtzyx->...sAtzyx", u_last, recv_h - h_first),
                    mu, -1, co, val)
        bwd = _lift(recv_w - w_last, mu, +1, co, val)
        if keep is not None:
            fwd = fwd * keep.narrow(mu, n - 1, 1)
            bwd = bwd * keep.narrow(mu, 0, 1)
        o.narrow(ax, n - 1, 1).add_(fwd)
        o.narrow(ax, 0, 1).add_(bwd)
    return out
