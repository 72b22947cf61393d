"""The port's gauge-field and vector formats and configuration tools against
the JAX package's, on the CPU (numpy only on both sides):

  (a) binary, LIME/ILDG (64 and 32 bit), DDHMC, multi-file over (1,2,1,1)
      and (2,2,1,1) and HDF5 gauge fields: the port's writer gives the JAX
      writer's bytes, and each package reads the other's file to the same
      links bit for bit (with and without the anti-periodic sign);
  (b) HDF5 test vectors: the same bytes and cross reads, through
      read/write_test_vectors's dispatch on `.h5` / `.hdf5`;
  (c) without h5py every HDF5 function raises a RuntimeError naming it;
  (d) random_su3, rough_su3, make_*_conf: the JAX package's arrays bit for
      bit from three seeds; every `tools` subcommand writes the JAX
      tools.main's file byte for byte.
"""

import sys

import numpy as np
import pytest

from ddalphaamg_tpu import io as jio
from ddalphaamg_tpu import lime as jlime
from ddalphaamg_tpu import tools as jtools
from ddalphaamg_tpu_torch import io, lime, tools

LAT = (4, 4, 2, 2)


@pytest.fixture(scope="module")
def links():
    U = tools.random_su3(np.random.default_rng(7), (4, *LAT))
    return U, tools._plaquette(U)


def _both_write(tmp_path, name, port_write, jax_write):
    """Write with each package; returns (port path, JAX path) after checking
    the bytes are equal."""
    p, j = str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")
    port_write(p)
    jax_write(j)
    assert open(p, "rb").read() == open(j, "rb").read(), name
    return p, j


def _cross_read(paths, port_read, jax_read, want):
    for path in paths:
        for read in (port_read, jax_read):
            got, plaq = read(path)
            assert got.dtype == np.complex128
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ap", [True, False], ids=["anti-periodic", "periodic"])
@pytest.mark.parametrize("fmt", ["binary", "lime64", "lime32", "ddhmc", "hdf5"])
def test_gauge_formats_match_jax_bytes_and_cross_read(tmp_path, links, fmt, ap):
    U, plaq = links
    if ap:
        U = U.copy()
        U[0, -1] *= -1.0        # what a reader with anti_periodic returns
    if fmt == "binary":
        w, r = (io.write_gauge_field, jio.write_gauge_field), (io.read_gauge_field,
                                                                jio.read_gauge_field)
    elif fmt.startswith("lime"):
        prec = int(fmt[4:])
        w = tuple(lambda path, U, plaq, anti_periodic, f=f: f(
            path, U, plaq, anti_periodic=anti_periodic, precision=prec)
            for f in (lime.write_gauge_field, jlime.write_gauge_field))
        r = (lime.read_gauge_field, jlime.read_gauge_field)
    elif fmt == "ddhmc":
        w = (io.write_gauge_field_ddhmc, jio.write_gauge_field_ddhmc)
        r = (io.read_gauge_field_ddhmc, jio.read_gauge_field_ddhmc)
    else:
        w, r = (io.write_gauge_field, jio.write_gauge_field), (io.read_gauge_field,
                                                                jio.read_gauge_field)
    name = "conf.h5" if fmt == "hdf5" else "conf"
    paths = _both_write(tmp_path, name, lambda p: w[0](p, U, plaq, anti_periodic=ap),
                        lambda p: w[1](p, U, plaq, anti_periodic=ap))
    want = U.astype(np.complex64).astype(np.complex128) if fmt == "lime32" else U
    _cross_read(paths, lambda p: r[0](p, anti_periodic=ap),
                lambda p: r[1](p, anti_periodic=ap), want)
    assert abs(r[0](paths[0], anti_periodic=ap)[1] - plaq) < 1e-12  # LIME: 13 digits


@pytest.mark.parametrize("grid", [(1, 2, 1, 1), (2, 2, 1, 1)], ids=["1x2x1x1", "2x2x1x1"])
def test_multi_file_matches_jax(tmp_path, links, grid):
    U, plaq = links
    one = str(tmp_path / "one")
    io.write_gauge_field(one, U, plaq, anti_periodic=False)
    names = io.split_gauge_field(one, str(tmp_path / "port"), grid)
    jnames = jio.split_gauge_field(one, str(tmp_path / "jax"), grid)
    assert len(names) == len(jnames) == int(np.prod(grid))
    for a, b in zip(names, jnames):
        assert a.split("port")[-1] == b.split("jax")[-1]
        assert open(a, "rb").read() == open(b, "rb").read()
    for prefix in ("port", "jax"):
        path = str(tmp_path / prefix)
        for ap in (False, True):
            got, gplaq = io.read_gauge_field_multi(path, grid, anti_periodic=ap)
            want, _ = jio.read_gauge_field_multi(path, grid, anti_periodic=ap)
            np.testing.assert_array_equal(got, want)
            assert gplaq == plaq
        np.testing.assert_array_equal(io.read_gauge_field_multi(path, grid, False)[0], U)


@pytest.mark.parametrize("name", ["tv.h5", "tv.hdf5"])
def test_hdf5_test_vectors_match_jax(tmp_path, name):
    rng = np.random.default_rng(8)
    tvs = rng.normal(size=(3, *LAT, 12)) + 1j * rng.normal(size=(3, *LAT, 12))
    header = {"m0": -0.5, "csw": 1.0}
    p, j = _both_write(tmp_path, name,
                       lambda path: io.write_test_vectors(path, tvs, header=header),
                       lambda path: jio.write_test_vectors(path, tvs, header=header))
    for path in (p, j):
        np.testing.assert_array_equal(io.read_test_vectors(path, LAT, 3), tvs)
        np.testing.assert_array_equal(jio.read_test_vectors(path, LAT, 3), tvs)


def test_hdf5_without_h5py_raises(tmp_path, links, monkeypatch):
    U, plaq = links
    monkeypatch.setitem(sys.modules, "h5py", None)       # import h5py fails
    tvs = np.zeros((1, *LAT, 12), complex)
    calls = [lambda: io.write_gauge_field(str(tmp_path / "c.h5"), U, plaq),
             lambda: io.read_gauge_field(str(tmp_path / "c.hdf5")),
             lambda: io.write_test_vectors(str(tmp_path / "t.h5"), tvs),
             lambda: io.read_test_vectors(str(tmp_path / "t.h5"), LAT, 1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="h5py"):
            call()


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_random_fields_match_jax_bit_for_bit(seed):
    lat = (2, 2, 2, 4)
    a = tools.random_su3(np.random.default_rng(seed), (4, *lat))
    b = jtools.random_su3(np.random.default_rng(seed), (4, *lat))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tools.rough_su3(lat, seed=seed),
                                  jtools.rough_su3(lat, seed=seed))
    assert tools._plaquette(a) == jtools._plaquette(b)


def test_tools_subcommands_write_the_jax_files(tmp_path, links, capsys):
    U, plaq = links
    src = str(tmp_path / "src")
    jio.write_gauge_field(src, U, plaq, anti_periodic=False)
    ddhmc = str(tmp_path / "src.ddhmc")
    jio.write_gauge_field_ddhmc(ddhmc, U, plaq, anti_periodic=False)
    lat = [str(e) for e in LAT]
    cases = {"unit": lambda out: ["unit", out, *lat],
             "random": lambda out: ["random", out, *lat, "--seed", "4"],
             "random-mix": lambda out: ["random", out, *lat, "--seed", "2",
                                        "--epsilon", "0.3"],
             "tolime": lambda out: ["tolime", src, out],
             "tobin": lambda out: ["tobin", str(tmp_path / "jax_tolime"), out],
             "fromddhmc": lambda out: ["fromddhmc", ddhmc, out]}
    for name, argv in cases.items():
        assert jtools.main(argv(str(tmp_path / f"jax_{name}"))) == 0
        assert tools.main(argv(str(tmp_path / f"port_{name}"))) == 0
        a = (tmp_path / f"port_{name}").read_bytes()
        assert a == (tmp_path / f"jax_{name}").read_bytes(), name
    # tobin of tolime gives back the input's links and plaquette
    np.testing.assert_array_equal(io.read_gauge_field(str(tmp_path / "port_tobin"), False)[0],
                                  U)
    assert tools.main(["split", src, str(tmp_path / "port_split"), "1", "2", "1", "1"]) == 0
    assert jtools.main(["split", src, str(tmp_path / "jax_split"), "1", "2", "1", "1"]) == 0
    for z in (0, 1):
        post = f".pt0pz{z}py0px0"
        assert ((tmp_path / f"port_split{post}").read_bytes()
                == (tmp_path / f"jax_split{post}").read_bytes())
    out = capsys.readouterr().out
    assert "wrote unit config" in out and "(ILDG)" in out and "wrote 2 files" in out
    for lattice, seed in ((LAT, 0), ((2, 2, 2, 2), 3)):
        a, b = str(tmp_path / "rough_p"), str(tmp_path / "rough_j")
        assert tools.make_rough_conf(a, lattice, seed=seed) == \
            jtools.make_rough_conf(b, lattice, seed=seed)
        assert open(a, "rb").read() == open(b, "rb").read()
