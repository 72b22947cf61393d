"""numpy -> port converters for state laid out the way the JAX package lays
it out (logical, site-major arrays).  Tests use them to hand the JAX
package's operators, test vectors and interpolation to the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .operators.coarse import CoarseOperator
from .operators.wilson import WilsonOperator


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def gauge_field(U, device="cpu", dtype=torch.complex128) -> torch.Tensor:
    """[4, T, Z, Y, X, 3, 3] links (either package's layout)."""
    return _t(U, dtype, device)


def wilson_operator(links, clover, device="cpu", dtype=torch.complex128) -> WilsonOperator:
    """Logical links [4,T,Z,Y,X,3,3] (= U/2) and clover [T,Z,Y,X,2,6,6]."""
    return WilsonOperator(_t(links, dtype, device), _t(clover, dtype, device))


def coarse_operator(A, Df, Db, device="cpu", dtype=torch.complex128) -> CoarseOperator:
    """A [T,Z,Y,X,d,d], Df/Db [4,T,Z,Y,X,d,d] -> site-flattened blocks."""
    d = np.asarray(A).shape[-1]
    return CoarseOperator(_t(A, dtype, device).reshape(-1, d, d),
                          _t(Df, dtype, device).reshape(4, -1, d, d),
                          _t(Db, dtype, device).reshape(4, -1, d, d))


def fields(v, device="cpu", dtype=torch.complex128) -> torch.Tensor:
    """Logical fields [*b, T, Z, Y, X, *dof] (fine dof (4, 3) or coarse (d,))
    -> dof-major [*b, dof, V]; test vectors are [N, T, Z, Y, X, 4, 3]."""
    a = np.asarray(v)
    fine = a.shape[-2:] == (4, 3) and a.ndim >= 6
    nb = a.ndim - (6 if fine else 5)
    a = a.reshape(*a.shape[:nb], -1, 12 if fine else a.shape[-1])
    return _t(np.moveaxis(a, -1, -2), dtype, device).contiguous()


def interpolation(P, device="cpu", dtype=torch.complex128) -> torch.Tensor:
    """[Tc, Zc, Yc, Xc, 2, N, m] -> [Vc, 2, N, m]."""
    a = np.asarray(P)
    return _t(a.reshape(-1, *a.shape[4:]), dtype, device).contiguous()
