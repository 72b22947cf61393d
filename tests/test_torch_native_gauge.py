"""The port's native gauge IO (ddalphaamg_tpu_torch/native.py, csrc/ddio.cpp,
built with g++ at first use) and its gauge helpers (gauge.plaquette_field,
unit_gauge, random_gauge) against its numpy IO and the JAX package:

  (a) a configuration written under tmp_path (random SU(3) links from a
      seed) read by the native reader, by the port's numpy reader and by
      the JAX package's io: bit-equal links and header, the same computed
      plaquette, with and without the anti-periodic sign, also from a
      big-endian file; the native writer's file byte for byte the numpy
      writer's and the JAX package's; io.last_reader names the reader; a
      truncated file still raises the numpy reader's error;
  (b) unit_gauge and plaquette_field bit for bit against the JAX package on
      numpy links from a seed; random_gauge SU(3) to 1e-12 (U U^H = 1,
      det U = 1), reproducible from a torch.Generator seed, with the Haar
      moment E|tr U|^2 = 1 as the JAX package's draw has it.
The native tests skip, saying so, only where g++ is missing.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddalphaamg_tpu import gauge as jgauge
from ddalphaamg_tpu import io as jio
from ddalphaamg_tpu_torch import gauge, io, native, tools

LAT = (4, 2, 4, 2)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native gauge IO is built with g++")
    handle = native.load()
    assert handle is not None, native.error
    return handle


@pytest.fixture
def numpy_only(monkeypatch):
    """The port's io with the native library unavailable."""
    monkeypatch.setattr(native, "load", lambda: None)


@pytest.fixture(scope="module")
def links():
    return tools.random_su3(np.random.default_rng(5), (4, *LAT))


def _read(path, anti_periodic):
    U, plaq = io.read_gauge_field(str(path), anti_periodic=anti_periodic)
    return U, plaq, io.last_reader


@pytest.mark.parametrize("anti_periodic", [True, False], ids=["anti-periodic", "periodic"])
def test_native_reader_and_writer_against_numpy_and_jax(lib, links, tmp_path, monkeypatch,
                                                        anti_periodic):
    header = 1.23456789012345
    native_file, numpy_file = tmp_path / "native.bin", tmp_path / "numpy.bin"
    io.write_gauge_field(str(native_file), links, header, anti_periodic=anti_periodic)
    jio.write_gauge_field(str(tmp_path / "jax.bin"), links, header,
                          anti_periodic=anti_periodic)
    with monkeypatch.context() as mp:
        mp.setattr(native, "load", lambda: None)
        io.write_gauge_field(str(numpy_file), links, header, anti_periodic=anti_periodic)
        U_np, plaq_np, reader_np = _read(native_file, anti_periodic)
    assert native_file.read_bytes() == numpy_file.read_bytes() == (
        tmp_path / "jax.bin").read_bytes()
    U_nat, plaq_nat, reader_nat = _read(native_file, anti_periodic)
    U_jax, plaq_jax = jio.read_gauge_field(str(native_file), anti_periodic=anti_periodic)
    assert (reader_nat, reader_np) == ("native", "numpy")
    assert U_nat.dtype == np.complex128 and U_nat.shape == (4, *LAT, 3, 3)
    np.testing.assert_array_equal(U_nat, U_np)
    np.testing.assert_array_equal(U_nat, np.asarray(U_jax))
    assert plaq_nat == plaq_np == plaq_jax == header
    # the sign is applied on read: the links written come back
    np.testing.assert_array_equal(U_nat, links)
    plaq = [gauge.average_plaquette(torch.as_tensor(U)) for U in (U_nat, U_np)]
    assert plaq[0] == plaq[1] == pytest.approx(float(jgauge.average_plaquette(
        jnp.asarray(U_jax))), rel=1e-13)


def test_native_reader_reads_a_big_endian_file(lib, links, tmp_path):
    flat = io._site_major(links).astype(">f8")
    path = tmp_path / "big.bin"
    path.write_bytes(np.array(LAT, ">i4").tobytes() + np.array([2.5], ">f8").tobytes()
                     + flat.tobytes())
    U, plaq, reader = _read(path, False)
    assert reader == "native" and plaq == 2.5
    np.testing.assert_array_equal(U, links)


def test_a_truncated_file_raises_the_numpy_readers_error(lib, links, tmp_path):
    path = tmp_path / "short.bin"
    io.write_gauge_field(str(path), links, 1.0, anti_periodic=False)
    path.write_bytes(path.read_bytes()[:-8])
    with pytest.raises(ValueError, match="truncated"):
        io.read_gauge_field(str(path))
    assert io.last_reader == "numpy"


def test_without_the_library_numpy_reads_and_says_so(numpy_only, links, tmp_path):
    path = tmp_path / "c.bin"
    io.write_gauge_field(str(path), links, 3.0, anti_periodic=True)
    U, plaq, reader = _read(path, True)
    assert reader == "numpy" and plaq == 3.0
    np.testing.assert_array_equal(U, links)


# ---------------------------------------------------------------------------
# (b) the gauge helpers
# ---------------------------------------------------------------------------

def test_unit_gauge_matches_jax():
    got = gauge.unit_gauge(LAT, "cpu")
    want = np.asarray(jgauge.unit_gauge(LAT))
    assert got.dtype == torch.complex128 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert gauge.average_plaquette(got) == 3.0


@pytest.mark.parametrize("kind", ["Gaussian", "SU(3)"])
def test_plaquette_field_matches_jax_bit_for_bit(kind):
    rng = np.random.default_rng(11)
    shape = (4, *LAT, 3, 3)
    U = (rng.normal(size=shape) + 1j * rng.normal(size=shape) if kind == "Gaussian"
         else tools.random_su3(rng, (4, *LAT)))
    for mu in range(4):
        for nu in range(4):
            got = gauge.plaquette_field(torch.as_tensor(U), mu, nu).numpy()
            want = np.asarray(jgauge.plaquette_field(jnp.asarray(U), mu, nu))
            np.testing.assert_array_equal(got, want)


def test_random_gauge_is_su3_reproducible_and_haar():
    lat = (4, 4, 4, 4)
    draw = [gauge.random_gauge(lat, torch.Generator().manual_seed(s), "cpu")
            for s in (7, 7, 8)]
    U = draw[0]
    assert U.shape == (4, *lat, 3, 3) and U.dtype == torch.complex128
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    eye = torch.eye(3, dtype=U.dtype)
    assert float((U @ U.conj().transpose(-1, -2) - eye).abs().max()) < 1e-12
    assert float((torch.linalg.det(U) - 1).abs().max()) < 1e-12
    # E|tr U|^2 = 1 under Haar SU(3) (1,024 matrices: standard error ~0.03)
    ours = float((torch.diagonal(U, dim1=-2, dim2=-1).sum(-1).abs() ** 2).mean())
    J = np.asarray(jgauge.random_gauge(lat, seed=7))
    theirs = float((np.abs(np.trace(J, axis1=-2, axis2=-1)) ** 2).mean())
    assert abs(ours - 1) < 0.15 and abs(theirs - 1) < 0.15
    single = gauge.random_gauge(lat, torch.Generator().manual_seed(7), "cpu",
                                dtype=torch.complex64)
    assert single.dtype == torch.complex64
    assert float((torch.linalg.det(single.to(torch.complex128)) - 1).abs().max()) < 1e-5
