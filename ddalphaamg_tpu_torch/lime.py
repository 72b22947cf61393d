"""LIME/ILDG container IO, numpy only (reference src/lime_io.c:222-533; the
JAX package's lime.py, whose files this module writes byte for byte).

LIME record framing (c-lime library format):
    int32  magic = 0x456789ab          (big-endian)
    int16  version = 1
    int16  flags: bit15 = message-begin, bit14 = message-end
    int64  data length (bytes)
    char[128] record type, NUL-padded
    data, zero-padded to a multiple of 8 bytes

Gauge configurations (ILDG):
  * "ildg-format" XML record: <precision>, <lx> <ly> <lz> <lt>;
  * "xlf-info" text record: "plaquette = %lf" (normalized to [0,1]);
  * "ildg-binary-data": big-endian floats, site order t slowest / x fastest,
    per site 4 links in +X,+Y,+Z,+T order (the reference reverses to its
    internal +T,+Z,+Y,+X with swap_spin_in_conf, src/lime_io.c:70-75),
    each a row-major 3x3 complex matrix.

Vectors ("scidac-binary-data"): same site order, 4 spins x 3 colors complex,
spin order reversed relative to the internal order (swap_spin_in_vector,
src/lime_io.c:74).
"""

from __future__ import annotations

import numpy as np

_MAGIC = 0x456789AB
_HDR = np.dtype([("magic", ">u4"), ("version", ">u2"), ("flags", ">u2"),
                 ("length", ">u8")])

T, Z, Y, X = 0, 1, 2, 3


def _pad8(n: int) -> int:
    return (8 - n % 8) % 8


def read_records(path: str):
    """Yield (type, bytes) for each LIME record in the file."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(16)
            if len(hdr) < 16:
                return
            h = np.frombuffer(hdr, dtype=_HDR, count=1)[0]
            if int(h["magic"]) != _MAGIC:
                raise ValueError(f"{path}: bad LIME magic {int(h['magic']):#x}")
            rtype = f.read(128).split(b"\0", 1)[0].decode("ascii")
            length = int(h["length"])
            data = f.read(length)
            f.read(_pad8(length))
            yield rtype, data


def write_records(path: str, records):
    """Write [(type, bytes)] as one LIME message."""
    with open(path, "wb") as f:
        n = len(records)
        for i, (rtype, data) in enumerate(records):
            flags = (0x8000 if i == 0 else 0) | (0x4000 if i == n - 1 else 0)
            hdr = np.zeros(1, dtype=_HDR)
            hdr["magic"], hdr["version"] = _MAGIC, 1
            hdr["flags"], hdr["length"] = flags, len(data)
            f.write(hdr.tobytes())
            t = rtype.encode("ascii")[:128]
            f.write(t + b"\0" * (128 - len(t)))
            f.write(data)
            f.write(b"\0" * _pad8(len(data)))


def _parse_tag(xml: bytes, tag: str):
    key = f"<{tag}>".encode()
    i = xml.find(key)
    if i < 0:
        return None
    j = xml.find(b"<", i + len(key))
    return xml[i + len(key): j].decode().strip()


def read_gauge_field(path: str, anti_periodic: bool = True):
    """Read an ILDG gauge configuration.

    Returns (U [4,T,Z,Y,X,3,3] complex128 with internal +T,+Z,+Y,+X link
    order, header plaquette normalized to [0,3] like the plain binary
    format -- the xlf-info value is stored in [0,1])."""
    dims = None
    precision = 64
    plaq = float("nan")
    payload = None
    for rtype, data in read_records(path):
        if rtype == "ildg-format":
            precision = int(_parse_tag(data, "precision") or 64)
            dims = tuple(int(_parse_tag(data, k)) for k in ("lt", "lz", "ly", "lx"))
        elif rtype == "xlf-info":
            for line in data.decode(errors="replace").splitlines():
                if "plaquette" in line and "=" in line:
                    try:
                        plaq = float(line.split("=", 1)[1].split()[0])
                    except ValueError:
                        pass
        elif rtype == "ildg-binary-data":
            payload = data
    if payload is None:
        raise ValueError(f"{path}: no ildg-binary-data record")
    if dims is None:
        raise ValueError(f"{path}: no ildg-format record")
    lt, lz, ly, lx = dims
    ftype = ">f8" if precision == 64 else ">f4"
    data = np.frombuffer(payload, dtype=ftype).astype(np.float64)
    links = data.reshape(lt, lz, ly, lx, 4, 3, 3, 2)
    U = links[..., 0] + 1j * links[..., 1]
    U = U[..., ::-1, :, :]                    # +X,+Y,+Z,+T -> +T,+Z,+Y,+X
    U = np.ascontiguousarray(np.moveaxis(U, 4, 0))
    if anti_periodic:
        U[T, -1] = -U[T, -1]
    return U, 3.0 * plaq


def write_gauge_field(path: str, U: np.ndarray, plaquette: float,
                      anti_periodic: bool = True, precision: int = 64) -> None:
    """Write an ILDG gauge configuration (plaquette given in [0,3])."""
    U = np.asarray(U)
    if anti_periodic:
        U = U.copy()
        U[T, -1] = -U[T, -1]
    _, lt, lz, ly, lx = U.shape[:5]
    site_major = np.moveaxis(U, 0, 4)[..., ::-1, :, :]  # internal -> XYZT
    ftype = ">f8" if precision == 64 else ">f4"
    flat = np.empty((*site_major.shape, 2), dtype=ftype)
    flat[..., 0] = site_major.real
    flat[..., 1] = site_major.imag
    fmt = (f"<?xml version=\"1.0\" encoding=\"UTF-8\"?>\n<ildgFormat>\n"
           f"  <version>1.0</version>\n  <field>su3gauge</field>\n"
           f"  <precision>{precision}</precision>\n"
           f"  <lx>{lx}</lx> <ly>{ly}</ly> <lz>{lz}</lz> <lt>{lt}</lt>\n"
           f"</ildgFormat>").encode()
    xlf = f" plaquette = {plaquette / 3.0:.13f}\n".encode()
    write_records(path, [("ildg-format", fmt), ("xlf-info", xlf),
                         ("ildg-binary-data", flat.tobytes())])


def read_vector(path: str, lattice=None):
    """Read a spinor from a LIME file (scidac-binary-data), spin order
    converted from file (reversed) to internal (src/lime_io.c:74)."""
    payload = None
    dims = lattice
    for rtype, data in read_records(path):
        if rtype in ("scidac-binary-data", "ildg-binary-data"):
            payload = data
        elif rtype in ("etmc-source-format", "etmc-propagator-format",
                       "ildg-format"):
            got = [_parse_tag(data, k) for k in ("lt", "lz", "ly", "lx")]
            if all(g is not None for g in got):
                dims = tuple(int(g) for g in got)
    if payload is None:
        raise ValueError(f"{path}: no binary data record")
    lt, lz, ly, lx = dims
    data = np.frombuffer(payload, dtype=">f8").astype(np.float64)
    v = data.reshape(lt, lz, ly, lx, 4, 3, 2)
    v = (v[..., 0] + 1j * v[..., 1])[..., ::-1, :]  # reverse spin order
    return np.ascontiguousarray(v)


def write_vector(path: str, v: np.ndarray) -> None:
    v = np.asarray(v).reshape(*v.shape[:4], 4, 3)[..., ::-1, :]
    flat = np.empty((*v.shape, 2), dtype=">f8")
    flat[..., 0] = v.real
    flat[..., 1] = v.imag
    write_records(path, [("scidac-binary-data", flat.tobytes())])
