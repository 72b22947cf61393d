"""Shared inputs of the port's parity tests against the JAX package
(tests/test_torch_*.py): made with numpy from a seed, handed to both."""

import numpy as np

from ddalphaamg_tpu import tools


def rough_field(lattice, seed=3):
    """Plaquette-targeted rough SU(3) links (numpy, complex128) with the
    anti-periodic sign on the last time slice."""
    U = tools.rough_su3(tuple(lattice), seed=seed)
    U[0, -1] *= -1.0
    return U


def random_spinor(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def to_numpy(a):
    """A JAX array or split CArray as a numpy complex array."""
    if hasattr(a, "re"):
        return np.asarray(a.re) + 1j * np.asarray(a.im)
    return np.asarray(a)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())
