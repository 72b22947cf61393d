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

The exchange overlaps the local kernel (the JAX package's halo structure,
its parallel/halo.py:1-19): faces_start projects and posts the
half-spinor faces of every split axis, which need only phi and the links,
before the kernel is launched; Faces.finish waits for them and applies
the corrections of all axes to the kernel's output, the link products of
every axis as one batched product (sites of all faces side by side), the
additions in the axes' order.
"""

from __future__ import annotations

import functools

import torch

from ..operators.fast import _cached_mask, _gamma_tables
from .comm import exchange_start
from .mesh import active_axes


class FaceTables:
    """The gamma tables of the face projections on one device and dtype:
    per axis mu the partner rows of the half-spinor rows (co[mu][:2]) and
    of the lifted rows (co[mu][2:]) as index tensors, and their phases
    shaped to broadcast.  Made once a (device, dtype), when a slab's
    stencil is built (face_tables), so that no capture copies them from the
    host."""

    def __init__(self, device, dtype):
        co, val = _gamma_tables(device, dtype)
        shape = (2, 1, 1, 1, 1, 1)
        self.half_idx = [torch.as_tensor(co[mu][:2], device=device) for mu in range(4)]
        self.lift_idx = [torch.as_tensor(co[mu][2:], device=device) for mu in range(4)]
        self.half_val = [val[mu, :2].reshape(shape) for mu in range(4)]
        self.lift_val = [val[mu, 2:].reshape(shape) for mu in range(4)]


@functools.lru_cache(maxsize=None)
def face_tables(device, dtype) -> FaceTables:
    return FaceTables(torch.device(device), dtype)


def _half(q, mu, sign, tb: FaceTables):
    """[*, 4, 3, t, z, y, x] -> the half-spinor [*, 2, 3, t, z, y, x] of
    (1 + sign gamma_mu) q: rows q[s] + sign val[mu, s] q[co[mu, s]]."""
    sp = q.dim() - 6
    return q.narrow(sp, 0, 2) + sign * tb.half_val[mu] * q.index_select(sp, tb.half_idx[mu])


def _lift(h, mu, sign, tb: FaceTables):
    """Half-spinor rows -> the [*, 4, 3, t, z, y, x] contribution of the
    hop: rows 0, 1 = -h, rows 2, 3 = -sign val[mu, s] h[co[mu, s]]."""
    sp = h.dim() - 6
    low = (-sign) * tb.lift_val[mu] * h.index_select(sp, tb.lift_idx[mu])
    return torch.cat([-h, low], sp)


def _link_products(mats, vecs, dagger: bool):
    """U [3, 3, face] (U^H with dagger) times the half-spinors [*, 2, 3,
    face] of every face, as one product over the sites of all faces."""
    lead = vecs[0].shape[:-6]
    sizes = [m[0, 0].numel() for m in mats]
    U = torch.cat([m.reshape(3, 3, -1) for m in mats], -1)
    X = torch.cat([v.reshape(*lead, 2, 3, -1) for v in vecs], -1)
    eq = "BAf,...sBf->...sAf" if dagger else "ABf,...sBf->...sAf"
    Y = torch.einsum(eq, U.conj() if dagger else U, X)
    return [y.reshape(v.shape) for y, v in zip(Y.split(sizes, -1), vecs)]


class Faces:
    """The face exchange of one hop under way (faces_start)."""

    def __init__(self, mesh, links, phi, lattice):
        self.mesh, self.lattice = mesh, tuple(lattice)
        p = phi.reshape(*phi.shape[:-2], 4, 3, *lattice)
        self.u = links.reshape(4, 3, 3, *lattice)
        self.tb = face_tables(phi.device, phi.dtype)
        self.axes = active_axes(mesh, mesh.global_lattice(lattice))
        self.shape = p.shape
        ax0 = p.dim() - 4
        self.u_last = [self.u[mu].narrow(2 + mu, lattice[mu] - 1, 1) for mu in self.axes]
        self.h_first = [_half(p.narrow(ax0 + mu, 0, 1), mu, -1, self.tb) for mu in self.axes]
        halves = [_half(p.narrow(ax0 + mu, lattice[mu] - 1, 1), mu, +1, self.tb)
                  for mu in self.axes]
        self.w_last = _link_products(self.u_last, halves, True) if self.axes else []
        self.pending = exchange_start(mesh, list(zip(self.axes, self.h_first, self.w_last)))

    def finish(self, out, parity=None):
        """Wait for the faces and correct out in place; returns out."""
        got = self.pending.finish()
        if not self.axes:
            return out
        lattice, tb = self.lattice, self.tb
        o = out.view(self.shape)
        ax0 = o.dim() - 4
        keep = None
        if parity is not None:
            keep = _cached_mask(lattice, int(parity), self.mesh.parity(lattice),
                                o.real.dtype, o.device).reshape(lattice)
        fwds = _link_products(self.u_last, [recv_h - h for (recv_h, _), h
                                            in zip(got, self.h_first)], False)
        for mu, fwd, (_, recv_w), w_last in zip(self.axes, fwds, got, self.w_last):
            n = lattice[mu]
            fwd = _lift(fwd, mu, -1, tb)
            bwd = _lift(recv_w - w_last, mu, +1, tb)
            if keep is not None:
                fwd = fwd * keep.narrow(mu, n - 1, 1)
                bwd = bwd * keep.narrow(mu, 0, 1)
            o.narrow(ax0 + mu, n - 1, 1).add_(fwd)
            o.narrow(ax0 + mu, 0, 1).add_(bwd)
        return out


def faces_start(mesh, links, phi, lattice) -> Faces:
    """Project the faces of phi [*, 12, V_l] on every split axis and post
    their exchange (module note); links [4, 3, 3, V_l] are the hop's (masked
    links stay masked).  The local kernel runs next, then
    Faces.finish(out, parity) corrects its output in place to the hop of
    the global lattice; with a parity (0 even, 1 odd, counted from the
    slab's global offset) out holds the sites of that parity only, and only
    those are corrected."""
    return Faces(mesh, links, phi, lattice)
