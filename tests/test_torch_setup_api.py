"""The rest of the port's setup and library API on the CPU, on 4^4 rough
fields, two levels, 8 test vectors:

  (a) shift_stencil / Multigrid.shift_update / Solver.shift_update against
      a rebuild at the new mass from the same test vectors: every level's
      stencil, its inverses and one preconditioner cycle to 1e-12 in
      complex128 and 1e-6 in complex64, with no setup iteration run;
  (b) interpolation 1 (twolevel_extension_setup) against the JAX package on
      the same injected test vectors, complex64: the test vectors to 1e-5;
  (c) update_setup(1) against the JAX package's extra bootstrap iteration
      (complex128): test vectors and a preconditioner cycle to 1e-9;
  (d) test-vector files written by one package and read by the other, bit
      for bit, one file and one file a vector; a Solver with
      interpolation 4 reading what write_test_vectors wrote solves in the
      writer's iterations; an HDF5 path round-trips against the JAX
      package's HDF5 writer;
  (e) solve(x0=) from a converged x returns in 0 iterations; method 0 from a
      random x0 takes the JAX package's iterations;
  (f) open boundaries (bc 0) as the JAX package's test_api.py:98 builds
      them: the hopping time links zeroed, the operator equal to the JAX
      package's, no coupling across the boundary, a solve to 1e-8;
  (g) apply_preconditioner lowers the residual for every method;
  (h) the methods without multigrid on a spawned (1, 1, 1, 2) gloo grid
      against one rank.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks
from torch_parity import random_spinor, rel_err, rough_field

from ddalphaamg_tpu import api as japi
from ddalphaamg_tpu import config as jconfig
from ddalphaamg_tpu import io as jio
from ddalphaamg_tpu.mg.hierarchy import Multigrid as JMultigrid
from ddalphaamg_tpu_torch import api, config, convert, io
from ddalphaamg_tpu_torch.mg.hierarchy import Multigrid
from ddalphaamg_tpu_torch.operators import fast
from ddalphaamg_tpu_torch.operators.stencil import shift_stencil
from ddalphaamg_tpu_torch.parallel import launch

torch.set_num_threads(1)

LAT = (4, 4, 4, 4)
INI = """configuration: none
number of levels: 2
d0 global lattice: 4 4 4 4
d0 block lattice: 2 2 2 2
d0 test vectors: 8
d0 setup iter: {s0}
m0: {m0}
csw: 1.0
tolerance for relative residual: 1E-10
iterations between restarts: 50
maximum of restarts: 20
method: {method}
interpolation: {interp}
mixed precision: {mp}
"""


def _ini(s0=1, m0=-0.5, method=2, interp=2, mp=0):
    return INI.format(s0=s0, m0=m0, method=method, interp=interp, mp=mp)


@pytest.fixture(scope="module")
def field():
    return rough_field(LAT, seed=21)


@pytest.fixture(scope="module")
def tv0():
    return random_spinor((8, *LAT, 4, 3), seed=22)


def _solver(U, text, tv=None):
    """A port Solver set up from text (bootstrap on the injected test
    vectors tv when given)."""
    s = api.Solver(config.parse_ini(text), device="cpu")
    s.set_conf(U, links_have_bc=True)
    if tv is None:
        s.setup()
        return s
    mg = s.build_hierarchy()
    mg.set_test_vectors(tv)
    mg.bootstrap_setup()
    return s


def _stencil_tensors(s):
    names = ("links", "cdiag", "coff", "cdiag_inv", "coff_inv", "Pk", "Pk_inv")
    return {n: getattr(s, n) for n in names if hasattr(s, n)}


# ---------------------------------------------------------------------------
# (a) shift_update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp, tol", [(0, 1e-12), (1, 1e-6)], ids=["complex128", "complex64"])
def test_shift_update_equals_a_rebuild(field, tv0, monkeypatch, mp, tol):
    delta = 0.1
    s = _solver(field, _ini(mp=mp), tv0)
    eta = convert.fields(random_spinor((*LAT, 4, 3), seed=23))
    tvs = s.mg.get_test_vectors()
    monkeypatch.setattr(Multigrid, "bootstrap_setup",
                        lambda *a, **k: pytest.fail("shift_update ran a setup"))
    s.shift_update(-0.5 + delta)
    assert s.p.m0 == -0.5 + delta
    monkeypatch.undo()

    fresh = api.Solver(config.parse_ini(_ini(m0=-0.5 + delta, mp=mp)), device="cpu")
    fresh.set_conf(field, links_have_bc=True)
    fresh.build_hierarchy().set_test_vectors(tvs)
    for name, t in _stencil_tensors(s.outer).items():
        assert rel_err(t.numpy(), getattr(fresh.outer, name).numpy()) < 1e-12, name
    for got, want in zip(s.mg._levels(), fresh.mg._levels()):
        assert got.cycle_stencil is None and got.dense_inv is None and got.block_inv is None
        for name, t in _stencil_tensors(got.stencil).items():
            assert rel_err(t.numpy(), getattr(want.stencil, name).numpy()) < tol, \
                (got.depth, name)
    assert rel_err(s.mg(eta).numpy(), fresh.mg(eta).numpy()) < tol
    x, info = s.solve()
    assert info.converged and s.true_residual(x, np.ones((*LAT, 4, 3))) < 1e-10
    # a coarse stencil alone: +delta on the self blocks, inverse recomputed
    cs = s.mg.fine.next.stencil
    back = shift_stencil(cs, -delta)
    want = fresh.mg.fine.next.stencil
    d = cs.dof
    eye = torch.eye(d, dtype=cs.Pk.dtype)[:, :, None]
    assert rel_err((cs.Pk[0] - back.Pk[0]).numpy(), (delta * eye).expand_as(cs.Pk[0]).numpy()) \
        < tol
    assert rel_err(cs.Pk_inv.numpy(), want.Pk_inv.numpy()) < tol


# ---------------------------------------------------------------------------
# (b), (c) interpolation 1 and update_setup against the JAX package
# ---------------------------------------------------------------------------

def _jax_mg(U, text, tv):
    js = japi.Solver(jconfig.parse_ini(text))
    js.set_conf(U, links_have_bc=True)
    jmg = JMultigrid(js.op, js._mg_config())
    js.mg = js.preconditioner = jmg
    jmg.set_test_vectors(tv)
    return js, jmg


def test_twolevel_extension_setup_matches_jax(field, tv0):
    text = _ini(s0=2, interp=1, mp=1)
    js, jmg = _jax_mg(field, text, tv0)
    jmg.twolevel_extension_setup()
    s = api.Solver(config.parse_ini(text), device="cpu")
    s.set_conf(field, links_have_bc=True)
    mg = s.build_hierarchy()
    mg.set_test_vectors(tv0)
    mg.twolevel_extension_setup()
    assert rel_err(mg.get_test_vectors(), np.asarray(jmg.fine.test_vectors)) < 1e-5
    # update_setup runs the configured kind of setup
    before = mg.get_test_vectors()
    s.update_setup(1)
    jmg.twolevel_extension_setup(1)
    assert rel_err(mg.get_test_vectors(), np.asarray(jmg.fine.test_vectors)) < 1e-5
    assert rel_err(mg.get_test_vectors(), before) > 1e-3


def test_update_setup_matches_jax(field, tv0):
    text = _ini(s0=1)
    js, jmg = _jax_mg(field, text, tv0)
    jmg.bootstrap_setup()
    jmg.bootstrap_setup(1)
    s = _solver(field, text, tv0)
    s.update_setup(1)
    assert rel_err(s.mg.get_test_vectors(), np.asarray(jmg.fine.test_vectors)) < 1e-9
    eta = random_spinor((*LAT, 4, 3), seed=24)
    got = fast.spinor_from_soa(s.mg(convert.fields(eta)), LAT).numpy()
    assert rel_err(got, np.asarray(jmg(jnp.asarray(eta)))) < 1e-9


# ---------------------------------------------------------------------------
# (d) test-vector files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("single", [True, False], ids=["one-file", "per-vector"])
def test_test_vector_files_cross_read_bit_for_bit(tmp_path, single):
    tvs = random_spinor((3, 2, 2, 2, 4, 12), seed=25)
    header = {"m0": -0.5, "csw": 1.0}
    io.write_test_vectors(str(tmp_path / "port"), tvs, single_file=single, header=header)
    jio.write_test_vectors(str(tmp_path / "jax"), tvs, single_file=single, header=header)
    files = ["port", "jax"] if single else [f"{n}.{i:02d}" for n in ("port", "jax")
                                            for i in range(3)]
    data = {f: (tmp_path / f).read_bytes() for f in files}
    if single:
        assert data["port"] == data["jax"] and data["port"].startswith(b"<header>\n")
    else:
        assert all(data[f"port.{i:02d}"] == data[f"jax.{i:02d}"] for i in range(3))
    for writer in ("port", "jax"):
        path = str(tmp_path / writer)
        got = io.read_test_vectors(path, (2, 2, 2, 4), 3, single_file=single)
        want = jio.read_test_vectors(path, (2, 2, 2, 4), 3, single_file=single)
        np.testing.assert_array_equal(got, tvs)
        np.testing.assert_array_equal(want, tvs)
    v = io.read_vector(str(tmp_path / ("port" if single else "port.01")), (2, 2, 2, 4),
                       12 * (3 if single else 1))
    assert v.shape == (2, 2, 2, 4, 36 if single else 12)
    h5 = {w: str(tmp_path / f"{w}.h5") for w in ("port", "jax")}
    io.write_test_vectors(h5["port"], tvs, header=header)
    jio.write_test_vectors(h5["jax"], tvs, header=header)
    for path in h5.values():
        np.testing.assert_array_equal(io.read_test_vectors(path, (2, 2, 2, 4), 3), tvs)
        np.testing.assert_array_equal(jio.read_test_vectors(path, (2, 2, 2, 4), 3), tvs)


@pytest.mark.parametrize("single", [True, False], ids=["one-file", "per-vector"])
def test_interpolation_4_reads_what_was_written(field, tmp_path, single):
    s = _solver(field, _ini(s0=1))
    x, info = s.solve()
    path = str(tmp_path / "tv")
    s.write_test_vectors(path, single_file=single)
    text = _ini(interp=4) + (f"test vector io file name: {path}\n"
                             f"test vector io from single file: {int(single)}\n")
    r = _solver(field, text)
    np.testing.assert_array_equal(r.mg.get_test_vectors(), s.mg.get_test_vectors())
    _, rinfo = r.solve()
    assert rinfo.converged and rinfo.iterations == info.iterations


# ---------------------------------------------------------------------------
# (e) initial guesses
# ---------------------------------------------------------------------------

def test_solve_from_x0(field, tv0):
    s = _solver(field, _ini(), tv0)
    rhs = np.ones((*LAT, 4, 3), np.complex128)
    x, info = s.solve(rhs)
    assert info.converged and info.iterations > 0
    x2, info2 = s.solve(rhs, x0=x)
    assert info2.iterations == 0 and info2.converged
    np.testing.assert_array_equal(x2, x)
    xs, infos = s.solve_multi(np.stack([rhs, rhs]), x0=np.stack([x, np.zeros_like(x)]))
    assert [i.iterations for i in infos] == [0, info.iterations]

    text = _ini(method=0, interp=0)
    x0 = random_spinor((*LAT, 4, 3), seed=26)
    p = api.Solver(config.parse_ini(text), device="cpu")
    p.set_conf(field, links_have_bc=True)
    px, pinfo = p.solve(rhs, x0=x0)
    js = japi.Solver(jconfig.parse_ini(text))
    js.set_conf(field, links_have_bc=True)
    jx, jinfo = js.solve(rhs, x0=x0)
    assert pinfo.converged and pinfo.iterations == jinfo.iterations
    assert rel_err(px, np.asarray(jx)) < 1e-8


# ---------------------------------------------------------------------------
# (f) open boundaries
# ---------------------------------------------------------------------------

def test_open_boundaries_match_jax(field):
    text = _ini(s0=1)
    U = field.copy()
    U[0, -1] *= -1.0                      # raw links, as a file holds them
    p = config.parse_ini(text)
    p.bc, p.anti_pbc = 0, False
    s = api.Solver(p, device="cpu")
    with pytest.raises(ValueError):
        s.set_conf(U)                     # a nonzero U_T on the last slice
    U[0, -1] = 0.0
    plaq = s.set_conf(U)
    links = s.op.links.numpy()
    for t in (0, -2, -1):
        assert np.abs(links[0, t]).max() == 0.0
    jp = jconfig.parse_ini(text)
    jp.bc, jp.anti_pbc = 0, False
    js = japi.Solver(jp)
    jplaq = js.set_conf(U)
    assert abs(plaq - jplaq) < 1e-12
    np.testing.assert_allclose(links, np.asarray(js.op.links), rtol=0, atol=1e-15)
    np.testing.assert_allclose(s.op.clover.numpy(), np.asarray(js.op.clover), atol=1e-12)
    phi = random_spinor((*LAT, 4, 3), seed=27)
    got = fast.spinor_from_soa(s.apply_operator(convert.fields(phi)), LAT).numpy()
    assert rel_err(got, np.asarray(js.apply_operator(phi))) < 1e-12
    phi = np.zeros((*LAT, 4, 3), complex)
    phi[0] = 1.0                          # a source on the first slice
    out = fast.spinor_from_soa(s.apply_operator(convert.fields(phi)), LAT).numpy()
    assert np.abs(out[-1]).max() == 0.0
    s.setup()
    x, info = s.solve(tol=1e-8)
    assert info.converged and s.true_residual(x, np.ones((*LAT, 4, 3))) < 1e-8


# ---------------------------------------------------------------------------
# (g), (h)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method, interp", [(2, 2), (1, 0), (3, 0), (4, 0), (5, 0), (0, 0)])
def test_apply_preconditioner_lowers_the_residual(field, method, interp):
    s = _solver(field, _ini(method=method, interp=interp, mp=1))
    b = random_spinor((*LAT, 4, 3), seed=28)
    z = s.apply_preconditioner(b)
    assert z.shape == b.shape and z.dtype == np.complex128
    if method == 0:
        np.testing.assert_array_equal(z, b)
        return
    r = b - fast.spinor_from_soa(s.apply_operator(convert.fields(z)), LAT).numpy()
    assert np.linalg.norm(r) < 0.5 * np.linalg.norm(b)


GRID_METHODS = (-1, 0, 1, 4, 5)


@pytest.fixture(scope="module")
def grid_solves(field):
    """Each method without multigrid solved on a spawned (1, 1, 1, 2) gloo
    grid (tests/torch_parallel_ranks.py) and on one rank."""
    cases = {m: ("solve", dict(ini=_ini(method=m, interp=0), U=field)) for m in GRID_METHODS}
    res = launch.run_ranks(ranks.run, (1, 1, 1, 2), "gloo", ["cpu"] * 2, cases)
    return res, {m: ranks.solve(None, _ini(method=m, interp=0), field) for m in GRID_METHODS}


@pytest.mark.parametrize("method", GRID_METHODS)
def test_methods_without_multigrid_refuse_a_mesh(grid_solves, method):
    """The method runs on a grid that splits x as on one rank: every rank
    returns the same x, which converges to the tolerance in the single
    rank's iterations (within 2 % or 1) and agrees with its x."""
    res, single = grid_solves
    x1, it1, _, exact1 = single[method]
    x0, it0, relres0, _ = res[0][method]
    for r in res:
        x, it, relres, exact = r[method]
        assert it == it0 and relres == relres0
        np.testing.assert_array_equal(x, x0)
        assert relres < 1e-10 and exact < 1e-10 and exact1 < 1e-10
        assert abs(it - it1) <= max(1, 0.02 * it1), (it, it1)
        assert rel_err(x, x1) < 1e-8
