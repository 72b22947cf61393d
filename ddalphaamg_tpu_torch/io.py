"""Gauge-configuration IO, binary format 0, and vector / test-vector IO.

The DDalphaAMG binary gauge format (reference src/io.c:459-560, layout in
doc/user_doc.tex:112-146):

    int32[4]      global lattice extents (T, Z, Y, X)
    float64       average plaquette of the configuration (normalized to [0, 3])
    float64[...]  for each site in lexicographic (T slowest ... X fastest)
                  order: 4 directions (T, Z, Y, X) x 3 x 3 row-major complex
                  SU(3) matrices as interleaved (re, im) doubles

Little-endian; big-endian files are detected by a sanity check on the
extents.  The other gauge formats (the JAX package's io.py:97-140,
:274-405): HDF5 (`.h5` / `.hdf5` paths, a "configuration" dataset in the
same site-major layout; needs h5py, imported at first use), one file a
rank (`path.pt<t>pz<z>py<y>px<x>`, each holding its block after the global
header) and DDHMC (8 links for every odd site).  LIME/ILDG is lime.py.  Every
writer gives the JAX package's bytes, so each package reads the other's
files.

Vector files (the reference's vector_io, src/io.c:704-1124; the JAX
package's io.py:142-187, :231-272): an optional text preamble from a line
"<header>" to a line "</header>", then the sites in lexicographic order, dof
complex numbers a site as little-endian (re, im) doubles.  A test-vector
checkpoint is one file with a header and the vectors back to back, or one
file a vector, `path.00`, `path.01`, ..., or an HDF5 file (`.h5` /
`.hdf5`: an "eigenmodes" group, one "eigenmode<i>" dataset a vector).

Anti-periodic boundary conditions in time are applied here by negating the
T-direction links on the last global T-slice (reference src/io.c:538-544),
so every downstream stencil is purely periodic.

The binary format is read and written by the native library (native.py,
csrc/ddio.cpp, built with g++ at first use) where it loads, as the JAX
package's io.py:40-46 reads, else by numpy; both give the same bits, and
last_reader names the reader of the last read_gauge_field ("native",
"numpy" or "hdf5").
"""

from __future__ import annotations

import math

import numpy as np

from . import native

T, Z, Y, X = 0, 1, 2, 3
last_reader = None      # the reader of the last read_gauge_field (module note)


def _is_hdf5_path(path) -> bool:
    return str(path).endswith((".h5", ".hdf5"))


def _h5py(what: str):
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(f"HDF5 {what} IO requires h5py") from e
    return h5py


def _extents(raw: bytes, path):
    """(lattice, endian) of a file with the binary format's header."""
    dims = np.frombuffer(raw, dtype="<i4", count=4)
    endian = "<"
    if not all(0 < d <= 4096 for d in dims):
        dims = np.frombuffer(raw, dtype=">i4", count=4)
        if not all(0 < d <= 4096 for d in dims):
            raise ValueError(f"{path}: cannot parse lattice extents")
        endian = ">"
    return tuple(int(d) for d in dims), endian


def _apply_bc(U, anti_periodic: bool):
    """A copy of U with the T links of the last slice negated (their sign
    applied or undone), or U itself."""
    if not anti_periodic:
        return U
    U = np.array(U)
    U[T, -1] = -U[T, -1]
    return U


def _site_major(U) -> np.ndarray:
    """Links [4, *lat, 3, 3] -> little-endian doubles [*lat, 4, 3, 3, 2]."""
    site_major = np.moveaxis(np.asarray(U), 0, 4)
    flat = np.empty((*site_major.shape, 2), dtype="<f8")
    flat[..., 0] = site_major.real
    flat[..., 1] = site_major.imag
    return flat


def _from_site_major(links) -> np.ndarray:
    """Doubles [*lat, 4, 3, 3, 2] -> complex128 links [4, *lat, 3, 3]."""
    U = links[..., 0] + 1j * links[..., 1]
    return np.ascontiguousarray(np.moveaxis(U, 4, 0), dtype=np.complex128)


def _write_binary(path, lattice, flat, plaquette: float):
    with open(path, "wb") as f:
        f.write(np.array(lattice, dtype="<i4").tobytes())
        f.write(np.array([plaquette], dtype="<f8").tobytes())
        f.write(flat.tobytes())


def read_gauge_field(path: str, anti_periodic: bool = True):
    """Returns (U complex128 [4, T, Z, Y, X, 3, 3], header plaquette);
    `.h5` / `.hdf5` paths are read as HDF5.  The native reader goes first;
    numpy reads where it is unavailable or refuses the file (and then
    raises its own error for a malformed one); last_reader names the
    reader."""
    global last_reader
    if _is_hdf5_path(path):
        last_reader = "hdf5"
        return read_gauge_field_hdf5(path, anti_periodic=anti_periodic)
    try:
        out = native.read_gauge_field(str(path), anti_periodic=anti_periodic)
    except OSError:
        out = None
    if out is not None:
        last_reader = "native"
        return out
    last_reader = "numpy"
    with open(path, "rb") as f:
        raw = f.read()
    (lt, lz, ly, lx), endian = _extents(raw, path)
    plaq = float(np.frombuffer(raw, dtype=f"{endian}f8", count=1, offset=16)[0])
    expected = lt * lz * ly * lx * 4 * 18
    if len(raw) < 24 + 8 * expected:
        raise ValueError(f"{path}: truncated gauge field")
    data = np.frombuffer(raw, dtype=f"{endian}f8", count=expected, offset=24)
    U = _from_site_major(data.reshape(lt, lz, ly, lx, 4, 3, 3, 2))
    return _apply_bc(U, anti_periodic), plaq


def write_gauge_field(path: str, U, plaquette: float, anti_periodic: bool = True) -> None:
    """Write links [4, T, Z, Y, X, 3, 3] in the binary format (the inverse of
    read_gauge_field: with anti_periodic the sign on the last slice is
    undone first); `.h5` / `.hdf5` paths are written as HDF5."""
    if _is_hdf5_path(path):
        return write_gauge_field_hdf5(path, U, plaquette, anti_periodic=anti_periodic)
    if native.write_gauge_field(str(path), U, plaquette, anti_periodic=anti_periodic):
        return
    U = _apply_bc(U, anti_periodic)
    _write_binary(path, U.shape[1:5], _site_major(U), plaquette)


def write_gauge_field_hdf5(path: str, U, plaquette: float,
                           anti_periodic: bool = True) -> None:
    """HDF5 gauge field (reference HAVE_HDF5 gauge IO): a "configuration"
    dataset [T, Z, Y, X, 4, 3, 3, 2] with the attributes "lattice" and
    "plaquette"."""
    h5py = _h5py("gauge")
    U = _apply_bc(U, anti_periodic)
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("configuration", data=_site_major(U))
        ds.attrs["lattice"] = np.array(U.shape[1:5], np.int32)
        ds.attrs["plaquette"] = float(plaquette)


def read_gauge_field_hdf5(path: str, anti_periodic: bool = True):
    """The inverse of write_gauge_field_hdf5: (U, header plaquette)."""
    h5py = _h5py("gauge")
    with h5py.File(path, "r") as f:
        ds = f["configuration"]
        flat = np.asarray(ds)
        plaq = float(ds.attrs.get("plaquette", 0.0))
    return _apply_bc(_from_site_major(flat), anti_periodic), plaq


def _proc_postfix(coords) -> str:
    """The file name postfix of a rank (reference read_conf_multi,
    src/io.c:599)."""
    return f".pt{coords[T]}pz{coords[Z]}py{coords[Y]}px{coords[X]}"


def _blocks(lattice, proc_grid):
    """(rank coordinates, the rank's slices of [*lattice]) of every rank."""
    ll = tuple(lattice[mu] // proc_grid[mu] for mu in range(4))
    for c in np.ndindex(*proc_grid):
        yield c, tuple(slice(c[mu] * ll[mu], (c[mu] + 1) * ll[mu]) for mu in range(4))


def split_gauge_field(path_in: str, path_out: str, proc_grid) -> list[str]:
    """Split a one-file configuration into one file a rank of proc_grid
    (ranks per dimension; the reference's conf/split/split_conf.c):
    `path_out` + the rank's postfix, each the global header and its block.
    Returns the file names."""
    U, plaq = read_gauge_field(path_in, anti_periodic=False)
    names = []
    for c, sl in _blocks(U.shape[1:5], proc_grid):
        name = path_out + _proc_postfix(c)
        _write_binary(name, U.shape[1:5], _site_major(U[(slice(None),) + sl]), plaq)
        names.append(name)
    return names


def read_gauge_field_multi(path: str, proc_grid, anti_periodic: bool = True):
    """Read a configuration written one file a rank by split_gauge_field
    (reference read_conf_multi, src/io.c:566-700): (U, header plaquette)."""
    U = plaq = None
    for c in np.ndindex(*proc_grid):
        with open(path + _proc_postfix(c), "rb") as f:
            raw = f.read()
        lattice = tuple(int(d) for d in np.frombuffer(raw, dtype="<i4", count=4))
        plaq = float(np.frombuffer(raw, dtype="<f8", count=1, offset=16)[0])
        if U is None:
            U = np.zeros((4, *lattice, 3, 3), dtype=np.complex128)
            slices = dict(_blocks(lattice, proc_grid))
        ll = tuple(lattice[mu] // proc_grid[mu] for mu in range(4))
        data = np.frombuffer(raw, dtype="<f8", count=math.prod(ll) * 4 * 18, offset=24)
        U[(slice(None),) + slices[c]] = _from_site_major(data.reshape(*ll, 4, 3, 3, 2))
    return _apply_bc(U, anti_periodic), plaq


def _odd_sites(lattice):
    """Coordinates [4, n_odd] of the odd sites (t + z + y + x odd) in
    lexicographic order."""
    coords = np.indices(lattice).reshape(4, -1)
    return coords[:, coords.sum(axis=0) % 2 == 1]


def _minus(oc, mu, lattice):
    """The -mu neighbours of the sites oc."""
    nc = oc.copy()
    nc[mu] = (nc[mu] - 1) % lattice[mu]
    return nc


def read_gauge_field_ddhmc(path: str, anti_periodic: bool = True):
    """Read a DDHMC configuration (reference converter
    conf/convert/DDHMC2DDalphaAMG.c:34-95): the binary format's header, then
    for every odd site in lexicographic order 8 row-major complex SU(3)
    matrices, +T, -T, +Z, -Z, +Y, -Y, +X, -X, where the -mu matrix is the +mu
    link of the site's (even) -mu neighbour, so that the odd sites' records
    hold every link once.  Returns (U, header plaquette)."""
    with open(path, "rb") as f:
        raw = f.read()
    lattice, endian = _extents(raw, path)
    plaq = float(np.frombuffer(raw, dtype=f"{endian}f8", count=1, offset=16)[0])
    nsite = math.prod(lattice)
    if nsite % 2:
        raise ValueError(f"{path}: the DDHMC layout needs an even site count")
    expected = (nsite // 2) * 8 * 18
    data = np.frombuffer(raw, dtype=f"{endian}f8", count=expected, offset=24)
    if data.size != expected:
        raise ValueError(f"{path}: truncated DDHMC gauge field")
    rec = data.reshape(nsite // 2, 8, 3, 3, 2)
    rec = rec[..., 0] + 1j * rec[..., 1]
    oc = _odd_sites(lattice)
    U = np.empty((4, *lattice, 3, 3), dtype=np.complex128)
    for mu in range(4):
        U[(mu, *oc)] = rec[:, 2 * mu]
        U[(mu, *_minus(oc, mu, lattice))] = rec[:, 2 * mu + 1]
    return _apply_bc(U, anti_periodic), plaq


def write_gauge_field_ddhmc(path: str, U, plaquette: float,
                            anti_periodic: bool = True) -> None:
    """Write a configuration in the DDHMC layout (the inverse of
    read_gauge_field_ddhmc)."""
    U = _apply_bc(U, anti_periodic)
    lattice = U.shape[1:5]
    oc = _odd_sites(lattice)
    rec = np.empty((oc.shape[1], 8, 3, 3), dtype=np.complex128)
    for mu in range(4):
        rec[:, 2 * mu] = U[(mu, *oc)]
        rec[:, 2 * mu + 1] = U[(mu, *_minus(oc, mu, lattice))]
    flat = np.empty((*rec.shape, 2), dtype="<f8")
    flat[..., 0] = rec.real
    flat[..., 1] = rec.imag
    _write_binary(path, lattice, flat, plaquette)


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
    from the per-vector files path.00 ... (interpolation 4), or from an
    HDF5 file."""
    if _is_hdf5_path(path):
        return read_test_vectors_hdf5(path, lattice, n, dof)
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
    `header`, one headerless file a vector, or an HDF5 file)."""
    tvs = np.asarray(tvs)
    if _is_hdf5_path(path):
        return write_test_vectors_hdf5(path, tvs, header)
    if not single_file:
        for i in range(tvs.shape[0]):
            write_vector(f"{path}.{i:02d}", tvs[i])
        return
    with open(path, "wb") as f:
        f.write(_header_text({"vectors": tvs.shape[0], **(header or {})}))
        f.write(_interleaved(tvs))


def write_test_vectors_hdf5(path: str, tvs, header: dict | None = None) -> None:
    """HDF5 test vectors (reference HAVE_HDF5 vector_io, src/io.c:32-370):
    an "eigenmodes" group with `header` and the count "vectors" as
    attributes and one dataset "eigenmode<i>" [T, Z, Y, X, dof, 2] a
    vector."""
    h5py = _h5py("test-vector")
    tvs = np.asarray(tvs, np.complex128)
    with h5py.File(path, "w") as f:
        grp = f.create_group("eigenmodes")
        for k, v in (header or {}).items():
            grp.attrs[k] = v
        grp.attrs["vectors"] = tvs.shape[0]
        for i in range(tvs.shape[0]):
            flat = np.empty((*tvs.shape[1:], 2), dtype="<f8")
            flat[..., 0] = tvs[i].real
            flat[..., 1] = tvs[i].imag
            grp.create_dataset(f"eigenmode{i}", data=flat)


def read_test_vectors_hdf5(path: str, lattice, n: int, dof: int = 12) -> np.ndarray:
    """n test vectors [n, T, Z, Y, X, dof] from write_test_vectors_hdf5's file."""
    h5py = _h5py("test-vector")
    with h5py.File(path, "r") as f:
        grp = f["eigenmodes"]
        out = [np.asarray(grp[f"eigenmode{i}"]) for i in range(n)]
    return np.stack([(d[..., 0] + 1j * d[..., 1]).reshape(*lattice, dof) for d in out])
