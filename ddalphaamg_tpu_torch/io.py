"""Gauge-configuration IO, binary format 0 (numpy only).

The DDalphaAMG binary gauge format (reference src/io.c:459-560, layout in
doc/user_doc.tex:112-146):

    int32[4]      global lattice extents (T, Z, Y, X)
    float64       average plaquette of the configuration (normalized to [0, 3])
    float64[...]  for each site in lexicographic (T slowest ... X fastest)
                  order: 4 directions (T, Z, Y, X) x 3 x 3 row-major complex
                  SU(3) matrices as interleaved (re, im) doubles

Little-endian; big-endian files are detected by a sanity check on the
extents.  LIME/ILDG, HDF5 and multi-file configurations are not ported yet.

Anti-periodic boundary conditions in time are applied here by negating the
T-direction links on the last global T-slice (reference src/io.c:538-544),
so every downstream stencil is purely periodic.
"""

from __future__ import annotations

import numpy as np

T, Z, Y, X = 0, 1, 2, 3


def read_gauge_field(path: str, anti_periodic: bool = True):
    """Returns (U complex128 [4, T, Z, Y, X, 3, 3], header plaquette)."""
    if str(path).endswith((".h5", ".hdf5", ".lime", ".ildg")):
        raise NotImplementedError(
            f"{path}: only the binary format 0 is ported (ROADMAP A, still to port 5)")
    with open(path, "rb") as f:
        raw = f.read()
    dims = np.frombuffer(raw, dtype="<i4", count=4)
    endian = "<"
    if not all(0 < d <= 4096 for d in dims):
        dims = np.frombuffer(raw, dtype=">i4", count=4)
        if not all(0 < d <= 4096 for d in dims):
            raise ValueError(f"{path}: cannot parse lattice extents")
        endian = ">"
    lt, lz, ly, lx = (int(d) for d in dims)
    plaq = float(np.frombuffer(raw, dtype=f"{endian}f8", count=1, offset=16)[0])
    expected = lt * lz * ly * lx * 4 * 18
    if len(raw) < 24 + 8 * expected:
        raise ValueError(f"{path}: truncated gauge field")
    data = np.frombuffer(raw, dtype=f"{endian}f8", count=expected, offset=24)
    links = data.reshape(lt, lz, ly, lx, 4, 3, 3, 2)
    U = links[..., 0] + 1j * links[..., 1]
    U = np.ascontiguousarray(np.moveaxis(U, 4, 0), dtype=np.complex128)
    if anti_periodic:
        U[T, -1] = -U[T, -1]
    return U, plaq
