"""Gauge-field utilities: average plaquette and the clover term.

Conventions mirror the reference (src/dirac.c:24-58, 304-402, 568-622):

  * Q_{mu nu}(x) = 1/16 * (sum of the four plaquette leaves in the (mu, nu)
    plane attached to x); Qdiff = Q - Q^dagger.
  * C(x) = (4 + m0) I_12 - csw * sum_{mu<nu} (gamma_mu gamma_nu) (x) Qdiff_{mu nu}(x),
    block-diagonal over the two chiralities, stored as [T,Z,Y,X, 2, 6, 6]
    Hermitian blocks (block index = 3 * spin_within_block + color).
  * The average plaquette is normalized to [0, 3].

U layout: [4, T, Z, Y, X, 3, 3], direction order (T, Z, Y, X).  The clover
is built in complex128 whatever the solver's working precision: it enters
the stored operator, and low-precision products here spoil every later
residual (docs/iteration_parity.md, section 2b).
"""

from __future__ import annotations

import numpy as np
import torch

from .gamma import get_basis


def _roll(a, shift: int, mu: int):
    """shift=-1 brings a[x+mu] to site x; shift=+1 brings a[x-mu]."""
    return torch.roll(a, shift, mu)


def _dag(a):
    return a.transpose(-1, -2).conj()


def _mm(*ms):
    out = ms[0]
    for m in ms[1:]:
        out = out @ m
    return out


def _mm_parts(*ms):
    """The product of [..., 3, 3] matrices with each complex product formed
    from real ones, re = ar br - ai bi and im = ar bi + ai br, each summed
    over the inner index in order: the arithmetic of the JAX package's
    complex einsum on the CPU, so that plaquette_field gives its bits."""
    def parts(x, y):
        return sum(x[..., :, k, None] * y[..., None, k, :] for k in range(3))

    out = ms[0]
    for m in ms[1:]:
        ar, ai, br, bi = out.real, out.imag, m.real, m.imag
        out = torch.complex(parts(ar, br) - parts(ai, bi), parts(ar, bi) + parts(ai, br))
    return out


def plaquette_field(U: torch.Tensor, mu: int, nu: int) -> torch.Tensor:
    """P_{mu nu}(x) = U_mu(x) U_nu(x+mu) U_mu(x+nu)^H U_nu(x)^H, [T,Z,Y,X,3,3]
    (the JAX package's gauge.plaquette_field, bit for bit on the CPU)."""
    Umu, Unu = U[mu], U[nu]
    return _mm_parts(Umu, _roll(Unu, -1, mu), _dag(_roll(Umu, -1, nu)), _dag(Unu))


def unit_gauge(lattice, device, dtype=torch.complex128) -> torch.Tensor:
    """The unit (free-field) configuration [4, *lattice, 3, 3] on `device`
    (the JAX package's gauge.unit_gauge; reference conf/random/unit_conf.c)."""
    eye = torch.eye(3, dtype=dtype, device=device)
    return eye.expand(4, *lattice, 3, 3).contiguous()


def random_gauge(lattice, generator: torch.Generator, device,
                 dtype=torch.complex128) -> torch.Tensor:
    """A Haar-random SU(3) configuration [4, *lattice, 3, 3] on `device`
    (the JAX package's gauge.random_gauge; reference
    conf/random/random_conf.c), drawn from `generator` (a generator of that
    device): the unitary factor of the QR of complex Gaussian matrices with
    R's diagonal made real and positive (the Haar phase fix, U(3)), then
    divided by a cube root of its determinant (SU(3)).  The QR is
    tools._qr_q (Gram-Schmidt, each projection twice), which gives that
    factor directly and is far faster on a card than torch.linalg.qr for
    millions of 3 x 3 matrices.  The same distribution as the JAX package,
    not its bits (jax.random is another generator)."""
    from .tools import _qr_q

    shape = (4, *lattice, 3, 3)
    rdtype = torch.empty((), dtype=dtype).real.dtype
    re = torch.randn(shape, generator=generator, dtype=rdtype, device=device)
    im = torch.randn(shape, generator=generator, dtype=rdtype, device=device)
    q = _qr_q(torch.complex(re, im))
    det = torch.linalg.det(q)                                 # |det| = 1
    return q * (det ** (1.0 / 3.0)).conj()[..., None, None]


def average_plaquette(U: torch.Tensor) -> float:
    """Average plaquette normalized to [0, 3] (reference calc_plaq)."""
    U = U.to(torch.complex128)
    total = 0.0
    for mu in range(4):
        for nu in range(mu + 1, 4):
            p = _mm(U[mu], _roll(U[nu], -1, mu), _dag(_roll(U[mu], -1, nu)),
                    _dag(U[nu]))
            total += float(torch.diagonal(p, dim1=-2, dim2=-1).real.sum())
    vol = int(np.prod(U.shape[1:5]))
    return total / (6.0 * vol)


def clover_Q(U: torch.Tensor, mu: int, nu: int) -> torch.Tensor:
    """Q_{mu nu}(x), [T,Z,Y,X,3,3] (reference src/dirac.c:304-355)."""
    Umu, Unu = U[mu], U[nu]
    Umu_m = _roll(Umu, 1, mu)                  # U_mu(x - mu)
    Unu_m = _roll(Unu, 1, mu)                  # U_nu(x - mu)
    Umu_n = _roll(Umu, 1, nu)                  # U_mu(x - nu)
    Unu_n = _roll(Unu, 1, nu)                  # U_nu(x - nu)
    Umu_mn = _roll(Umu_m, 1, nu)               # U_mu(x - mu - nu)
    Unu_mn = _roll(Unu_m, 1, nu)               # U_nu(x - mu - nu)
    p1 = _mm(Umu, _roll(Unu, -1, mu), _dag(_roll(Umu, -1, nu)), _dag(Unu))
    p2 = _mm(Unu, _dag(_roll(Umu_m, -1, nu)), _dag(Unu_m), Umu_m)
    p3 = _mm(_dag(Umu_m), _dag(Unu_mn), Umu_mn, Unu_n)
    p4 = _mm(_dag(Unu_n), Umu_n, _roll(_roll(Unu, -1, mu), 1, nu), _dag(Umu))
    return (p1 + p2 + p3 + p4) / 16.0


def compute_clover(U: torch.Tensor, m0: float, csw: float) -> torch.Tensor:
    """Clover term [T,Z,Y,X, 2, 6, 6] in complex128."""
    U = U.to(torch.complex128)
    lat = U.shape[1:5]
    eye = torch.eye(6, dtype=torch.complex128, device=U.device)
    clover = ((4.0 + m0) * eye).expand(*lat, 2, 6, 6).clone()
    if csw == 0.0:
        return clover
    basis = get_basis()
    for mu in range(4):
        for nu in range(mu + 1, 4):
            sig = basis.sigma_munu(mu, nu)
            blk = torch.as_tensor(np.stack([sig[0:2, 0:2], sig[2:4, 2:4]]),
                                  device=U.device)            # [2, 2, 2]
            q = clover_Q(U, mu, nu)
            qd = q - _dag(q)
            k = torch.einsum("cst,...ij->...csitj", blk, qd)
            clover -= csw * k.reshape(*lat, 2, 6, 6)
    return clover
