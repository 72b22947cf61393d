"""The benchmark's own gauge fields: random SU(3) links mixed towards the
unit field until the average plaquette reaches a target (the rough field of
the port's tools.rough_su3, frozen here), drawn with a torch.Generator on
the device in a few large calls, projected in complex128 there.

The mixing parameter is bisected on an 8^4 proxy field (the plaquette
against the mixing curve does not depend on the lattice size), then refined
on the field itself.  The same (lattice, seed, device type) gives the same
links.  Imports torch only.
"""

from __future__ import annotations

import torch

PROXY = 8            # the proxy field's extent in every direction
PROXY_STEPS = 18     # bisection steps on the proxy
FIELD_STEPS = 12     # refinement steps on the field, within +-0.05 of the proxy's


def det3(a: torch.Tensor) -> torch.Tensor:
    """Determinants of [..., 3, 3] matrices by cofactors."""
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]))


def unitary_factor(a: torch.Tensor) -> torch.Tensor:
    """Q of the QR of [..., 3, 3] matrices with R's diagonal real and
    positive: Gram-Schmidt of the columns, each projection done twice."""
    cols = []
    for k in range(3):
        v = a[..., :, k]
        for _ in range(2 if cols else 0):
            for q in cols:
                v = v - q * (q.conj() * v).sum(-1, keepdim=True)
        cols.append(v / torch.linalg.vector_norm(v, dim=-1, keepdim=True))
    return torch.stack(cols, dim=-1)


def random_su3(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Haar-random SU(3) matrices [*shape, 3, 3] in complex128."""
    re = torch.randn((*shape, 3, 3), generator=gen, dtype=torch.float64, device=device)
    im = torch.randn((*shape, 3, 3), generator=gen, dtype=torch.float64, device=device)
    q = unitary_factor(torch.complex(re, im))
    return q / (det3(q) ** (1.0 / 3))[..., None, None]


def mix_to_unit(U: torch.Tensor, eps: float) -> torch.Tensor:
    """The SU(3) projection of 1 + eps (U - 1): the unit field at eps = 0."""
    eye = torch.eye(3, dtype=U.dtype, device=U.device)
    q = unitary_factor(eye + eps * (U - eye))
    return q * (det3(q) ** (1.0 / 3)).conj()[..., None, None]


def plaquette(U: torch.Tensor) -> float:
    """The average plaquette of U [4, T, Z, Y, X, 3, 3], in [0, 3]."""
    total = 0.0
    for mu in range(4):
        for nu in range(mu + 1, 4):
            p = (U[mu] @ torch.roll(U[nu], -1, mu) @ torch.roll(U[mu], -1, nu).mH
                 @ U[nu].mH)
            total += float(torch.diagonal(p, dim1=-2, dim2=-1).real.sum())
    return total / (6 * U[0, ..., 0, 0].numel())


def _bisect(U, target, lo, hi, steps, tol=0.0):
    eps = 0.5 * (lo + hi)
    for _ in range(steps):
        eps = 0.5 * (lo + hi)
        plaq = plaquette(mix_to_unit(U, eps))
        if abs(plaq - target) < tol:
            break
        if plaq > target:
            lo = eps
        else:
            hi = eps
    return eps


def rough_su3(lattice, seed: int, target_plaquette: float, tolerance: float,
              device) -> torch.Tensor:
    """Links [4, *lattice, 3, 3] in complex128 on `device` whose average
    plaquette lies within `tolerance` of `target_plaquette` (or as near as
    the refinement steps get)."""
    proxy = tuple(min(PROXY, e) for e in lattice)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    eps = _bisect(random_su3(gen, (4, *proxy), device), target_plaquette, 0.0, 1.0,
                  PROXY_STEPS)
    gen.manual_seed(seed)
    U = random_su3(gen, (4, *lattice), device)
    eps = _bisect(U, target_plaquette, max(0.0, eps - 0.05), min(1.0, eps + 0.05),
                  FIELD_STEPS, tolerance)
    return mix_to_unit(U, eps)
