"""ctypes binding of the native gauge IO library, csrc/ddio.cpp (the port's
copy of the JAX package's native/ddio.cpp; its native.py).

The library is built at first use with g++ into build/native/ (ignored by
git), keyed by a hash of the source, and loaded with ctypes.  Where it
cannot be built or loaded, load() returns None and `error` says why; io.py
then reads with numpy and records which reader served each read
(io.last_reader), so a failed build shows instead of hiding.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "ddio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None
error: Optional[str] = None     # why the library is unavailable (None: loaded or not tried)

_DPTR = ctypes.POINTER(ctypes.c_double)
_IPTR = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "dd_read_gauge_header": [ctypes.c_char_p, _IPTR, _DPTR, _IPTR],
    "dd_read_gauge": [ctypes.c_char_p, _DPTR, _DPTR, ctypes.c_int32],
    "dd_write_gauge": [ctypes.c_char_p, _DPTR, _DPTR, _IPTR, ctypes.c_double, ctypes.c_int32],
    "dd_read_vector": [ctypes.c_char_p, ctypes.c_int64, _DPTR, _DPTR, ctypes.c_int64],
}


def build() -> Path:
    """Compile the library if no build of the current source exists;
    returns its path (RuntimeError without g++ or on a compile error)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libddio_{digest}.so"
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native gauge IO is built with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "libddio.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", out, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(out, so)
    return so


def load():
    """The loaded library, built at first use; None where it cannot be built
    or loaded (`error` holds the reason, and no second attempt is made)."""
    global _lib, error
    if _lib is None and error is None:
        try:
            handle = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
            error = str(e)
            return None
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(_DPTR)


def read_gauge_field(path: str, anti_periodic: bool = True):
    """(U complex128 [4, T, Z, Y, X, 3, 3], header plaquette) read by the
    library, with the anti-periodic sign applied as io.read_gauge_field
    does; None where the library is unavailable.  Raises OSError for a file
    it cannot read."""
    lib = load()
    if lib is None:
        return None
    dims = (ctypes.c_int32 * 4)()
    plaq = ctypes.c_double()
    big = ctypes.c_int32()
    name = os.fsencode(path)
    rc = lib.dd_read_gauge_header(name, dims, ctypes.byref(plaq), ctypes.byref(big))
    if rc:
        raise OSError(f"{path}: bad gauge header ({rc})")
    shape = (4, *dims, 3, 3)
    re = np.empty(shape, dtype=np.float64)
    im = np.empty(shape, dtype=np.float64)
    rc = lib.dd_read_gauge(name, _dptr(re), _dptr(im), int(anti_periodic))
    if rc:
        raise OSError(f"{path}: native gauge read failed ({rc})")
    return re + 1j * im, float(plaq.value)


def write_gauge_field(path: str, U, plaquette: float, anti_periodic: bool = True) -> bool:
    """Write links [4, T, Z, Y, X, 3, 3] in the binary format by the library
    (the sign on the last slice undone with anti_periodic); False where the
    library is unavailable."""
    lib = load()
    if lib is None:
        return False
    U = np.asarray(U)
    if U.ndim != 7 or U.shape[0] != 4 or U.shape[-2:] != (3, 3):
        raise ValueError(f"links are [4, T, Z, Y, X, 3, 3], got {U.shape}")
    re = np.ascontiguousarray(U.real, dtype=np.float64)
    im = np.ascontiguousarray(U.imag, dtype=np.float64)
    dims = (ctypes.c_int32 * 4)(*U.shape[1:5])
    rc = lib.dd_write_gauge(os.fsencode(path), _dptr(re), _dptr(im), dims, float(plaquette),
                            int(anti_periodic))
    if rc:
        raise OSError(f"{path}: native gauge write failed ({rc})")
    return True
