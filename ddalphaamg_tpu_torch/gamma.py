"""Clifford (gamma-matrix) algebra for the Wilson-Dirac operator.

The four Euclidean gamma matrices are stored in "permutation + phase" form:
each gamma_mu has exactly one nonzero per row, so

    (gamma_mu @ phi)[s] = GAMMA_VAL[mu][s] * phi[GAMMA_CO[mu][s]]

so a projection is a spin-index gather with a phase rather than a dense 4x4
matmul (csrc/dslash.cu bakes the BASIS0 tables in as constants).

Four bases are supported, mirroring the reference solver's compile-time
choices (reference: src/clifford.h:27-33): BASIS0 (OpenQCD/DD-HMC, the
default), BASIS1 (BMW-c), BASIS2 (QCDSF), BASIS3 (QOPQDP).  All bases share
the invariant gamma5 = (+/-) diag(1, 1, -1, -1); the reference applies
gamma5 = diag(-1, -1, +1, +1) (reference: src/dirac_generic.c:288-297) and we
follow that sign convention.

Direction ordering is (T, Z, Y, X) = (0, 1, 2, 3) throughout the framework
(reference: src/clifford.h:33).
"""

from __future__ import annotations

import numpy as np

T, Z, Y, X = 0, 1, 2, 3
DIR_NAMES = ("T", "Z", "Y", "X")

_I = 1j

# { basis_name: (co[4][4], val[4][4]) } with gamma_mu[s, co[mu][s]] = val[mu][s]
_BASES: dict[str, tuple[list[list[int]], list[list[complex]]]] = {
    # OpenQCD / DD-HMC basis (reference default, src/clifford.h:39-100)
    "BASIS0": (
        [
            [2, 3, 0, 1],  # gamma_T
            [3, 2, 1, 0],  # gamma_Z
            [3, 2, 1, 0],  # gamma_Y
            [2, 3, 0, 1],  # gamma_X
        ],
        [
            [-1, -1, -1, -1],
            [-_I, -_I, _I, _I],
            [-1, 1, 1, -1],
            [-_I, _I, _I, -_I],
        ],
    ),
    # BMW-c basis (src/clifford.h:162-225)
    "BASIS1": (
        [
            [2, 3, 0, 1],
            [2, 3, 0, 1],
            [3, 2, 1, 0],
            [3, 2, 1, 0],
        ],
        [
            [-1, -1, -1, -1],
            [-_I, _I, _I, -_I],
            [1, -1, -1, 1],
            [-_I, -_I, _I, _I],
        ],
    ),
    # QCDSF basis (src/clifford.h:286-347)
    "BASIS2": (
        [
            [2, 3, 0, 1],
            [2, 3, 0, 1],
            [3, 2, 1, 0],
            [3, 2, 1, 0],
        ],
        [
            [1, 1, 1, 1],
            [_I, -_I, -_I, _I],
            [-1, 1, 1, -1],
            [_I, _I, -_I, -_I],
        ],
    ),
    # QOPQDP basis (src/clifford.h:407-468)
    "BASIS3": (
        [
            [2, 3, 0, 1],
            [3, 2, 1, 0],
            [3, 2, 1, 0],
            [2, 3, 0, 1],
        ],
        [
            [1, 1, 1, 1],
            [_I, _I, -_I, -_I],
            [-1, 1, 1, -1],
            [_I, -_I, -_I, _I],
        ],
    ),
}

DEFAULT_BASIS = "BASIS0"


class GammaBasis:
    """Dense and permutation-form gamma matrices for one Clifford basis.

    Attributes:
      co:    int array [4, 4]   -- column index of the nonzero per (mu, row)
      val:   complex array [4, 4] -- value of that nonzero
      dense: complex array [4, 4, 4] -- gamma matrices as dense 4x4
      gamma5: complex array [4] -- diag(-1, -1, +1, +1) (reference convention)
    """

    def __init__(self, name: str = DEFAULT_BASIS):
        if name not in _BASES:
            raise ValueError(f"unknown Clifford basis {name!r}; options: {sorted(_BASES)}")
        self.name = name
        co, val = _BASES[name]
        self.co = np.array(co, dtype=np.int32)
        self.val = np.array(val, dtype=np.complex128)
        dense = np.zeros((4, 4, 4), dtype=np.complex128)
        for mu in range(4):
            for s in range(4):
                dense[mu, s, self.co[mu, s]] = self.val[mu, s]
        self.dense = dense
        # gamma5 applied as diag(-1,-1,+1,+1) (src/dirac_generic.c:288-297)
        self.gamma5 = np.array([-1, -1, 1, 1], dtype=np.complex128)

    def sigma_munu(self, mu: int, nu: int) -> np.ndarray:
        """gamma_mu @ gamma_nu as a dense 4x4 (used by the clover term)."""
        return self.dense[mu] @ self.dense[nu]

    # --- Projector application helpers (numpy) ---

    def apply_gamma(self, mu: int, phi: np.ndarray) -> np.ndarray:
        """gamma_mu phi for phi[..., 4, 3]."""
        return self.val[mu].reshape(4, 1) * phi[..., self.co[mu], :]

    def project_minus(self, mu: int, phi: np.ndarray) -> np.ndarray:
        """(1 - gamma_mu) phi for phi[..., 4, 3]."""
        return phi - self.apply_gamma(mu, phi)

    def project_plus(self, mu: int, phi: np.ndarray) -> np.ndarray:
        """(1 + gamma_mu) phi for phi[..., 4, 3]."""
        return phi + self.apply_gamma(mu, phi)


_CACHE: dict[str, GammaBasis] = {}


def get_basis(name: str = DEFAULT_BASIS) -> GammaBasis:
    if name not in _CACHE:
        _CACHE[name] = GammaBasis(name)
    return _CACHE[name]
