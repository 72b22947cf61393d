"""numpy -> port converters for state laid out the way the JAX package lays
it out (logical, site-major arrays).  Tests use them to hand the JAX
package's operators, test vectors and interpolation to the port.  With a
mesh (parallel/mesh.SolverMesh) each returns this rank's slab of the
global state instead.
"""

from __future__ import annotations

import numpy as np
import torch

from .operators.coarse import CoarseOperator
from .operators.wilson import WilsonOperator
from .parallel.mesh import shard_field, shard_interpolation, shard_operator


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def gauge_field(U, device="cpu", dtype=torch.complex128) -> torch.Tensor:
    """[4, T, Z, Y, X, 3, 3] links (either package's layout)."""
    return _t(U, dtype, device)


def wilson_operator(links, clover, device="cpu", dtype=torch.complex128,
                    mesh=None) -> WilsonOperator:
    """Logical links [4,T,Z,Y,X,3,3] (= U/2) and clover [T,Z,Y,X,2,6,6]."""
    op = WilsonOperator(_t(links, dtype, device), _t(clover, dtype, device))
    return op if mesh is None else shard_operator(mesh, op)


def coarse_operator(A, Df, Db, device="cpu", dtype=torch.complex128) -> CoarseOperator:
    """A [T,Z,Y,X,d,d], Df/Db [4,T,Z,Y,X,d,d] -> site-flattened blocks."""
    d = np.asarray(A).shape[-1]
    return CoarseOperator(_t(A, dtype, device).reshape(-1, d, d),
                          _t(Df, dtype, device).reshape(4, -1, d, d),
                          _t(Db, dtype, device).reshape(4, -1, d, d))


def fields(v, device="cpu", dtype=torch.complex128, mesh=None) -> torch.Tensor:
    """Logical fields [*b, T, Z, Y, X, *dof] (fine dof (4, 3) or coarse (d,))
    -> dof-major [*b, dof, V]; test vectors are [N, T, Z, Y, X, 4, 3]."""
    a = np.asarray(v)
    fine = a.shape[-2:] == (4, 3) and a.ndim >= 6
    nb = a.ndim - (6 if fine else 5)
    lattice = a.shape[nb:nb + 4]
    a = a.reshape(*a.shape[:nb], -1, 12 if fine else a.shape[-1])
    out = _t(np.moveaxis(a, -1, -2), dtype, device).contiguous()
    return out if mesh is None else shard_field(mesh, out, lattice)


def interpolation(P, device="cpu", dtype=torch.complex128, mesh=None) -> torch.Tensor:
    """[Tc, Zc, Yc, Xc, 2, N, m] -> [Vc, 2, N, m]."""
    a = np.asarray(P)
    out = _t(a.reshape(-1, *a.shape[4:]), dtype, device).contiguous()
    return out if mesh is None else shard_interpolation(mesh, out, a.shape[:4])


def packed_blocks(Pk, lattice, device="cpu", dtype=torch.complex64,
                  mesh=None) -> torch.Tensor:
    """The JAX package's packed coarse blocks, layout "t" [K, T, d*d, Z*Y*X]
    or "tz" [K, T, Z, d*d, Y*X] (rows j-major, pallas_coarse.pack_blocks)
    -> the port's [K, d (j), d (i), V], or this rank's slab [K, d, d, V_l]."""
    a = np.asarray(Pk)
    K, t, dd, rest = a.shape[0], a.shape[1], a.shape[-2], a.shape[-1]
    d = int(round(dd ** 0.5))
    a = a.reshape(K, -1, d, d, rest)              # [K, T or T*Z, j, i, M]
    a = a.transpose(0, 2, 3, 1, 4).reshape(K, d, d, -1)
    out = _t(a, dtype, device).contiguous()
    return out if mesh is None else shard_field(mesh, out, lattice)
