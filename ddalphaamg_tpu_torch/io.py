"""Gauge-configuration IO, binary format 0, and vector / test-vector IO
(numpy only).

The DDalphaAMG binary gauge format (reference src/io.c:459-560, layout in
doc/user_doc.tex:112-146):

    int32[4]      global lattice extents (T, Z, Y, X)
    float64       average plaquette of the configuration (normalized to [0, 3])
    float64[...]  for each site in lexicographic (T slowest ... X fastest)
                  order: 4 directions (T, Z, Y, X) x 3 x 3 row-major complex
                  SU(3) matrices as interleaved (re, im) doubles

Little-endian; big-endian files are detected by a sanity check on the
extents.  LIME/ILDG, HDF5 and multi-file configurations are not ported yet
(ROADMAP A.7).

Vector files (the reference's vector_io, src/io.c:704-1124; the JAX
package's io.py:142-187, :231-272): an optional text preamble from a line
"<header>" to a line "</header>", then the sites in lexicographic order, dof
complex numbers a site as little-endian (re, im) doubles.  A test-vector
checkpoint is one file with a header and the vectors back to back, or one
file a vector, `path.00`, `path.01`, ...

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


def _refuse_hdf5(path: str):
    if str(path).endswith((".h5", ".hdf5")):
        raise NotImplementedError(
            f"{path}: HDF5 test vectors are not ported (ROADMAP A.7)")


def _skip_header(f) -> None:
    """Skip an optional '<header>\\n ... </header>\\n' text preamble
    (reference vector_io, src/io.c:733-745)."""
    first = f.readline()
    if first != b"<header>\n":
        f.seek(0)
        return
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated <header> block")
        if line == b"</header>\n":
            return


def _header_text(fields) -> bytes:
    lines = ["<header>"] + [f"\t{k}: {v}" for k, v in (fields or {}).items()]
    return "\n".join(lines + ["</header>\n"]).encode()


def _interleaved(v) -> bytes:
    v = np.asarray(v)
    flat = np.empty(v.size * 2, dtype="<f8")
    flat[0::2] = v.real.ravel()
    flat[1::2] = v.imag.ravel()
    return flat.tobytes()


def read_vector(path: str, lattice, dof: int = 12) -> np.ndarray:
    """One vector [T, Z, Y, X, dof] (complex128) from a vector file."""
    lt, lz, ly, lx = lattice
    n = lt * lz * ly * lx * dof
    with open(path, "rb") as f:
        _skip_header(f)
        data = np.fromfile(f, dtype="<f8", count=2 * n)
    if data.size != 2 * n:
        raise ValueError(f"{path}: truncated vector")
    return (data[0::2] + 1j * data[1::2]).reshape(lt, lz, ly, lx, dof)


def write_vector(path: str, v, header: dict | None = None) -> None:
    """Write one vector (any shape, sites then dof), with a header if given."""
    with open(path, "wb") as f:
        if header is not None:
            f.write(_header_text(header))
        f.write(_interleaved(v))


def read_test_vectors(path: str, lattice, n: int, dof: int = 12,
                      single_file: bool = True) -> np.ndarray:
    """n test vectors [n, T, Z, Y, X, dof] (complex128) from one file or
    from the per-vector files path.00 ... (interpolation 4)."""
    _refuse_hdf5(path)
    if not single_file:
        return np.stack([read_vector(f"{path}.{i:02d}", lattice, dof) for i in range(n)])
    lt, lz, ly, lx = lattice
    per = lt * lz * ly * lx * dof
    with open(path, "rb") as f:
        _skip_header(f)
        data = np.fromfile(f, dtype="<f8", count=2 * per * n)
    if data.size != 2 * per * n:
        raise ValueError(f"{path}: expected {n} vectors")
    return (data[0::2] + 1j * data[1::2]).reshape(n, lt, lz, ly, lx, dof)


def write_test_vectors(path: str, tvs, single_file: bool = True,
                       header: dict | None = None) -> None:
    """Write test vectors [n, T, Z, Y, X, dof] (the inverse of
    read_test_vectors; one file with a header holding the count and
    `header`, or one headerless file a vector)."""
    _refuse_hdf5(path)
    tvs = np.asarray(tvs)
    if not single_file:
        for i in range(tvs.shape[0]):
            write_vector(f"{path}.{i:02d}", tvs[i])
        return
    with open(path, "wb") as f:
        f.write(_header_text({"vectors": tvs.shape[0], **(header or {})}))
        f.write(_interleaved(tvs))
