"""The plain reference of the benchmark: the Wilson-clover operator in
complex128 with dense 4 x 4 spin matrices, worked out again from the links
that the benchmark made (never from anything the solver built), the true
relative residual of a solution, and a plain CG on the normal equations
for the control.

Operator (DDalphaAMG's convention, src/dirac_generic.c of the C code):

    D x(n) = C(n) x(n)
             - 1/2 sum_mu [ U_mu(n) (1 - g_mu) x(n + mu)
                          + U_mu(n - mu)^H (1 + g_mu) x(n - mu) ]
    C(n)   = (4 + m0) - csw sum_{mu < nu} (g_mu g_nu) (x) (Q_munu - Q_munu^H)

with Q_munu(n) a sixteenth of the four plaquette leaves at n in the
(mu, nu) plane, the gamma matrices of DDalphaAMG's default basis (OpenQCD /
DD-HMC), directions ordered (T, Z, Y, X), and an anti-periodic time
boundary as a sign on the time links of the last time slice.

Fields are [B, T, Z, Y, X, 4, 3].  Imports torch and numpy only, and TF32
stays off for every product here.
"""

from __future__ import annotations

import torch

# gamma_mu[s, CO[mu][s]] = VAL[mu][s], DDalphaAMG's BASIS0 (src/clifford.h)
_CO = ((2, 3, 0, 1), (3, 2, 1, 0), (3, 2, 1, 0), (2, 3, 0, 1))
_VAL = ((-1, -1, -1, -1), (-1j, -1j, 1j, 1j), (-1, 1, 1, -1), (-1j, 1j, 1j, -1j))


def gammas(device, dtype=torch.complex128) -> torch.Tensor:
    """The four gamma matrices, dense [4, 4, 4]."""
    g = torch.zeros(4, 4, 4, dtype=dtype, device=device)
    for mu in range(4):
        for s in range(4):
            g[mu, s, _CO[mu][s]] = _VAL[mu][s]
    return g


def _dag(a):
    return a.transpose(-1, -2).conj()


def _at(a, d, k):
    """a(n + k e_d) at every site n of a [T, Z, Y, X, ...] field."""
    return torch.roll(a, -k, d)


def clover_q(U, mu, nu):
    """Q_munu(n): the four plaquette leaves at n in the (mu, nu) plane, over 16."""
    Um, Un = U[mu], U[nu]
    Um_m, Un_m = _at(Um, mu, -1), _at(Un, mu, -1)          # at n - mu
    Um_n, Un_n = _at(Um, nu, -1), _at(Un, nu, -1)          # at n - nu
    Um_mn, Un_mn = _at(Um_m, nu, -1), _at(Un_m, nu, -1)    # at n - mu - nu
    l1 = Um @ _at(Un, mu, 1) @ _dag(_at(Um, nu, 1)) @ _dag(Un)
    l2 = Un @ _dag(_at(Um_m, nu, 1)) @ _dag(Un_m) @ Um_m
    l3 = _dag(Um_m) @ _dag(Un_mn) @ Um_mn @ Un_n
    l4 = _dag(Un_n) @ Um_n @ _at(_at(Un, mu, 1), nu, -1) @ _dag(Um)
    return (l1 + l2 + l3 + l4) / 16.0


class WilsonClover:
    """D of raw links U [4, T, Z, Y, X, 3, 3] (no boundary sign in them),
    mass m0 and clover coefficient csw; `antiperiodic` puts the sign on the
    time links of the last time slice.  Held in `dtype` (complex128 for the
    check, complex64 for the control); the clover is built in complex128
    first either way."""

    def __init__(self, U: torch.Tensor, m0: float, csw: float, antiperiodic: bool = True,
                 dtype=torch.complex128):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        U = U.to(torch.complex128)
        dev = U.device
        g = gammas(dev)
        clover = torch.zeros(*U.shape[1:5], 4, 3, 4, 3, dtype=torch.complex128, device=dev)
        for mu in range(4):
            for nu in range(mu + 1, 4):
                q = clover_q(U, mu, nu)
                clover -= csw * torch.einsum("st,...ab->...satb", g[mu] @ g[nu], q - _dag(q))
        clover += (4.0 + m0) * torch.eye(12, dtype=clover.dtype, device=dev).reshape(4, 3, 4, 3)
        self.clover = clover.reshape(*U.shape[1:5], 12, 12).to(dtype)
        del clover
        links = 0.5 * U
        if antiperiodic:
            links[0, -1] *= -1.0
        self.links = links.to(dtype)
        eye = torch.eye(4, dtype=dtype, device=dev)
        self.minus, self.plus = eye - g.to(dtype), eye + g.to(dtype)
        self.dtype = dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """D x for x [B, T, Z, Y, X, 4, 3] in self.dtype."""
        B, lat = x.shape[0], x.shape[1:5]
        out = torch.einsum("...ij,z...j->z...i", self.clover,
                           x.reshape(B, *lat, 12)).reshape(x.shape)
        for mu in range(4):
            fwd = torch.roll(x, -1, 1 + mu)                                  # x(n + mu)
            out -= torch.einsum("...cd,st,z...td->z...sc", self.links[mu], self.minus[mu], fwd)
            bwd = torch.einsum("...dc,st,z...td->z...sc", self.links[mu].conj(),
                               self.plus[mu], x)                             # at n, for n + mu
            out -= torch.roll(bwd, 1, 1 + mu)
        return out


def relres(op: WilsonClover, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||b - D x|| / ||b|| of every lane, in complex128."""
    r = b.to(torch.complex128) - op(x.to(torch.complex128))
    B = b.shape[0]
    return (torch.linalg.vector_norm(r.reshape(B, -1), dim=1)
            / torch.linalg.vector_norm(b.reshape(B, -1).to(torch.complex128), dim=1))


def gamma5(x: torch.Tensor) -> torch.Tensor:
    """gamma_5 x = diag(-1, -1, +1, +1)_spin x (DDalphaAMG's sign)."""
    return torch.cat([-x[..., 0:2, :], x[..., 2:4, :]], dim=-2)


def cgnr(op: WilsonClover, b: torch.Tensor, tol: float, max_iter: int, stall: int = 100):
    """Plain CG on the normal equations D^H D x = D^H b (D^H = g5 D g5) for
    every lane of b [B, T, Z, Y, X, 4, 3] in op's precision, from x = 0,
    until every lane's recursive residual |b - D x| is below tol |b|, or
    no lane's worst residual improved for `stall` iterations, or
    max_iter; returns (x, iterations)."""
    B = b.shape[0]

    def sq(v):                  # |v|^2 per lane, [B, 1, ...]
        return (v.abs() ** 2).reshape(B, -1).sum(1).reshape(B, *([1] * (v.dim() - 1)))

    def dagger(v):
        return gamma5(op(gamma5(v)))

    b = b.to(op.dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    z = dagger(r)
    p = z.clone()
    zz = sq(z)
    nb = sq(b).sqrt()
    best, since, it = float("inf"), 0, 0
    for it in range(1, max_iter + 1):
        w = op(p)
        alpha = zz / sq(w)
        x = x + alpha * p
        r = r - alpha * w
        rel = float((sq(r).sqrt() / nb).max())
        if rel < tol:
            break
        if rel < best:
            best, since = rel, 0
        else:
            since += 1
            if since >= stall:
                break
        z = dagger(r)
        zz_new = sq(z)
        p = z + (zz_new / zz) * p
        zz = zz_new
    return x, it
