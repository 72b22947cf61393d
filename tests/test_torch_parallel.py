"""The port's domain-decomposed path (ddalphaamg_tpu_torch/parallel) against
the JAX package's sharded path and the port's own single-rank path, on the
CPU: ranks are spawned processes on the gloo transport (parallel/launch.py),
each running tests/torch_parallel_ranks.py, which imports no JAX.

  (a) mesh helpers and slab slicing equal the JAX package's (a y split
      too: tests/test_torch_grid4d.py covers the y/x grids);
  (b) the plain version of K5 on slabs plus faces equals the JAX package's
      coarse_sharded full / hop / block on a (2, 2, 1, 1) mesh, Pallas in
      interpret mode (float32, 1e-5 relative);
  (c) the sharded fine operator equals the JAX soa_dslash_shmap (1e-5 in
      complex64, 1e-12 in complex128), and the sharded coarse full / hop
      through exchanged faces equal the single-rank stencil;
  (d) one 3-level multigrid cycle over 2 ranks, depth 1 sharded along z,
      equals the single-rank cycle (complex128, 1e-5 relative);
  (e) Solver on 2 and 4 ranks against one rank: iterations within 1, x
      within 1e-6, exact relres below the tolerance;
  (f) slabs at an odd global offset give the single-rank odd-even results;
  (g) method 3 (sixteen-colour SAP) with multigrid on a (1, 2, 1, 1) grid
      against one rank: iterations within 1, exact relres below the
      tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks
from torch_parity import random_spinor, rel_err, rough_field, to_numpy

from ddalphaamg_tpu import cplx
from ddalphaamg_tpu import parallel as jparallel
from ddalphaamg_tpu.geometry import Geometry as JGeometry
from ddalphaamg_tpu.operators import stencil as jstencil
from ddalphaamg_tpu.operators import wilson as jwilson
from ddalphaamg_tpu.operators.coarse import CoarseOperator as JCoarseOperator
from ddalphaamg_tpu.parallel import shard_ops as jshard
from ddalphaamg_tpu_torch import api, config, convert
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.mg.hierarchy import MGConfig, Multigrid
from ddalphaamg_tpu_torch.operators import coarse
from ddalphaamg_tpu_torch.operators.stencil import ODD, CoarseStencilSoA, WilsonStencilSoA
from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator
from ddalphaamg_tpu_torch.parallel import launch
from ddalphaamg_tpu_torch.parallel import mesh as pmesh
from ddalphaamg_tpu_torch.parallel.comm import face
from ddalphaamg_tpu_torch.smoothers.sap import SchwarzPreconditioner

torch.set_num_threads(1)

M0, CSW = -0.5, 1.0
FINE = (4, 4, 4, 4)              # (c), (e)
COARSE = (4, 4, 2, 2)            # (b), (c): coarse lattice, d = 8
MG_LEVELS = ((4, 8, 4, 4), (2, 4, 2, 2), (1, 2, 1, 1))    # (d)
ODD_LAT, ODD_BLOCK = (2, 6, 2, 2), (2, 1, 2, 2)           # (f)
INI = """number of levels: 2
d0 global lattice: 4 4 4 4
d0 block lattice: 2 2 2 2
d0 post smooth iter: 2
d0 block iter: 4
d0 test vectors: 8
d0 setup iter: 2
method: 2
interpolation: 2
mixed precision: 1
odd even preconditioning: 1
kcycle: 1
m0: -0.5
csw: 1.0
tolerance for relative residual: 1e-10
iterations between restarts: 50
maximum of restarts: 20
"""

INI_METHOD3 = INI.replace("method: 2", "method: 3")


def _jmesh(dims):
    n = int(np.prod(dims))
    return jparallel.make_solver_mesh(dims=dims, devices=jax.devices()[:n])


def _coarse_blocks(lat, d, seed):
    rng = np.random.default_rng(seed)

    def c(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    A = c(*lat, d, d) + 5.0 * np.eye(d)
    return A, c(4, *lat, d, d), c(4, *lat, d, d)


def _fine_phi(lat, seed):
    """A random fine field [12, V] (the JAX SoA [4, 3, T, Z, M] flattened)."""
    return random_spinor((12, int(np.prod(lat))), seed)


# ---------------------------------------------------------------------------
# the ranks: one spawn per mesh runs every case of that mesh
# ---------------------------------------------------------------------------

def _inputs():
    U = rough_field(FINE, seed=3)
    Uodd = rough_field(ODD_LAT, seed=4)
    tv0 = random_spinor((4, *MG_LEVELS[0], 4, 3), seed=5)
    tv1 = random_spinor((4, *MG_LEVELS[1], 8), seed=6)
    eta = random_spinor((*MG_LEVELS[0], 4, 3), seed=7)
    return dict(U=U, Uodd=Uodd, Umg=rough_field(MG_LEVELS[0], seed=8), tv0=tv0,
                tv1=tv1, eta=eta, phi=_fine_phi(FINE, 9),
                cblocks=_coarse_blocks(COARSE, 8, 10),
                cv=random_spinor((2, 8, int(np.prod(COARSE))), 11),
                oblocks=_coarse_blocks(ODD_LAT, 4, 12),
                ov=random_spinor((4, int(np.prod(ODD_LAT))), 13),
                ophi=_fine_phi(ODD_LAT, 14))


def _cases(dims, x):
    cases = {
        f"fine_{dt}": ("fine_full_op", dict(lattice=FINE, U=x["U"], m0=M0, csw=CSW,
                                           phi=x["phi"], dtype=dt))
        for dt in (torch.complex64, torch.complex128)}
    A, Df, Db = x["cblocks"]
    cases["coarse"] = ("coarse_hops", dict(lattice=COARSE, A=A, Df=Df, Db=Db, v=x["cv"]))
    cases["solve"] = ("solve", dict(ini=INI, U=x["U"]))
    if dims == (1, 2, 1, 1):
        cases["solve3"] = ("solve", dict(ini=INI_METHOD3, U=x["U"]))
        cases["cycle"] = ("mg_cycle", dict(
            levels=ranks.level_configs(MG_LEVELS, ((2, 2, 2, 2), (1, 1, 1, 1), (1, 1, 1, 1)), 4),
            U=x["Umg"], tv0=x["tv0"], tv1=x["tv1"], eta=x["eta"], seed=1))
        A, Df, Db = x["oblocks"]
        cases["odd"] = ("odd_offset", dict(lattice=ODD_LAT, block=ODD_BLOCK, U=x["Uodd"],
                                           phi=x["ophi"], A=A, Df=Df, Db=Db, v=x["ov"]))
    return cases


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def runs(inputs):
    """runs(dims): the results of every rank of one spawned process grid,
    which runs all its cases once."""
    done = {}

    def get(dims):
        if dims not in done:
            n = int(np.prod(dims))
            done[dims] = launch.run_ranks(ranks.run, dims, "gloo", ["cpu"] * n,
                                          _cases(dims, inputs))
        return done[dims]
    return get


MESHES = pytest.mark.parametrize("dims", [(1, 2, 1, 1), (2, 2, 1, 1)],
                                 ids=["mesh1x2", "mesh2x2"])


# ---------------------------------------------------------------------------
# (a) mesh helpers and slabs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(1, 2, 1, 1), (2, 1, 1, 1), (2, 2, 1, 1), (1, 4, 1, 1)])
def test_mesh_and_slabs_match_jax(dims):
    lat = (8, 8, 4, 2)
    for n in (2, 4, 6, 8, 16):
        assert pmesh.factor_devices(n, lat) == jparallel.factor_devices(n, lat)
        assert pmesh.factor_devices(n) == jparallel.factor_devices(n)
    jm = _jmesh(dims)
    assert pmesh.local_lattice(pmesh.SolverMesh(dims), lat) == jshard.local_lattice(jm, lat)
    assert pmesh.active_axes(pmesh.SolverMesh(dims), lat) == jshard.active_axes(jm, lat)
    v = random_spinor((3, *lat[:2], lat[2] * lat[3]), seed=1)
    vt = torch.as_tensor(v.reshape(3, -1))
    jv = jparallel.shard_field(jm, jnp.asarray(v), lat, soa=True)
    devices = list(np.asarray(jm.devices).reshape(-1))
    for shard in jv.addressable_shards:
        rank = devices.index(shard.device)
        mine = pmesh.shard_field(pmesh.SolverMesh(dims, rank), vt, lat)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data).reshape(3, -1))
    # the slabs of all ranks tile a stack of fields
    tv = random_spinor((2, 12, int(np.prod(lat))), seed=2)
    slabs = [pmesh.shard_field(pmesh.SolverMesh(dims, r), torch.as_tensor(tv), lat)
             for r in range(int(np.prod(dims)))]
    assert sum(s.numel() for s in slabs) == tv.size
    # interpolation rows follow their coarse sites
    clat = (4, 4, 2, 1)
    P = random_spinor((*clat, 2, 3, 5), seed=3)
    jP = jparallel.shard_interpolation(jm, jnp.asarray(P), clat)
    for shard in jP.addressable_shards:
        mesh = pmesh.SolverMesh(dims, devices.index(shard.device))
        np.testing.assert_array_equal(convert.interpolation(P, mesh=mesh).numpy(),
                                      np.asarray(shard.data).reshape(-1, 2, 3, 5))
    # a y split builds and slices as the JAX package's logical layout shards
    ym = _jmesh((1, 1, 2, 1))
    assert pmesh.active_axes(pmesh.SolverMesh((1, 1, 2, 1)), lat) == (2,)
    w = random_spinor((*lat, 12), seed=4)
    jw = jparallel.shard_field(ym, jnp.asarray(w), lat)
    ydev = list(np.asarray(ym.devices).reshape(-1))
    for shard in jw.addressable_shards:
        mine = pmesh.shard_field(pmesh.SolverMesh((1, 1, 2, 1), ydev.index(shard.device)),
                                 torch.as_tensor(w.reshape(-1, 12).T), lat)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data).reshape(-1, 12).T)


# ---------------------------------------------------------------------------
# (b) plain K5 on slabs + faces vs the JAX "tz" sharded coarse ops
# ---------------------------------------------------------------------------

def test_plain_k5_matches_jax_coarse_sharded():
    d, dims = 8, (2, 2, 1, 1)
    A, Df, Db = _coarse_blocks(COARSE, d, 21)
    jcop = JCoarseOperator(cplx.as_carray(A), cplx.as_carray(Df),
                           cplx.as_carray(Db)).astype(jnp.complex64)
    js = jstencil.CoarseStencilSoA.build(jcop, JGeometry(lattice=COARSE, block=(2, 2, 2, 2)),
                                         use_pallas=True)
    jm = _jmesh(dims)
    js_sh = jparallel.shard_stencil(jm, js)
    assert js_sh.layout == "tz" and js_sh.use_pallas and js_sh.mesh is not None
    v = random_spinor((d, *COARSE[:2], COARSE[2] * COARSE[3]), seed=22).astype(np.complex64)
    v_sh = jparallel.shard_field(jm, cplx.as_carray(v), COARSE, soa=True)
    want = {name: to_numpy(jax.jit(getattr(js_sh, name))(v_sh)).reshape(d, -1)
            for name in ("full_op", "hop", "block_op")}
    Pk = to_numpy(js_sh.Pk)
    vg = torch.as_tensor(v.reshape(d, -1))
    for rank in range(4):
        mesh = pmesh.SolverMesh(dims, rank)
        loc = pmesh.local_lattice(mesh, COARSE)
        blocks = convert.packed_blocks(Pk, COARSE, mesh=mesh)
        vl = pmesh.shard_field(mesh, vg, COARSE)
        halos = {}
        for mu in (0, 1):       # faces cut from the global field's neighbors
            fwd = pmesh.shard_field(mesh, coarse.neighbor(vg, 1 + mu, COARSE), COARSE)
            bwd = pmesh.shard_field(mesh, coarse.neighbor(vg, 5 + mu, COARSE), COARSE)
            halos[mu] = (face(fwd, loc, mu, loc[mu] - 1), face(bwd, loc, mu, 0))
        got = {"full_op": coarse.coarse_apply_halo_plain(blocks, vl, loc, halos),
               "hop": coarse.coarse_apply_halo_plain(blocks, vl, loc, halos, (1, 9)),
               "block_op": coarse.coarse_apply_plain(blocks, vl, loc, (0, 9), (2, 2, 2, 2))}
        for name, g in got.items():
            ref = pmesh.shard_field(mesh, torch.as_tensor(want[name]), COARSE).numpy()
            assert rel_err(g.numpy(), ref) < 1e-5, (rank, name)


# ---------------------------------------------------------------------------
# (c) sharded operators through the ranks
# ---------------------------------------------------------------------------

@MESHES
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_sharded_fine_operator_matches_jax(runs, inputs, dims, dtype):
    res = runs(dims)
    jdt, tol = ((jnp.complex64, 1e-5) if dtype == torch.complex64
                else (jnp.complex128, 1e-12))
    U = inputs["U"]
    jop = jwilson.WilsonOperator.from_gauge(cplx.as_carray(U), m0=M0, csw=CSW)
    js = jstencil.WilsonStencilSoA.build(jop, JGeometry(lattice=FINE, block=(2, 2, 2, 2)),
                                         dtype=jdt, use_pallas=False)
    jm = _jmesh(dims)
    phi = inputs["phi"].reshape(4, 3, FINE[0], FINE[1], FINE[2] * FINE[3])
    phi_sh = jparallel.shard_field(jm, cplx.as_carray(phi.astype(
        np.complex64 if dtype == torch.complex64 else np.complex128)), FINE, soa=True)
    want = to_numpy(jax.jit(lambda st, v: jparallel.soa_dslash_shmap(jm, st, v))(
        jparallel.shard_stencil(jm, js), phi_sh)).reshape(12, -1)
    for r in res:
        assert rel_err(r[f"fine_{dtype}"], want) < tol


@MESHES
def test_sharded_coarse_hops_match_single_rank(runs, inputs, dims):
    res = runs(dims)
    A, Df, Db = inputs["cblocks"]
    s = CoarseStencilSoA.build(convert.coarse_operator(A, Df, Db, dtype=torch.complex64),
                               Geometry(COARSE, (2, 2, 2, 2)))
    v = torch.as_tensor(inputs["cv"]).to(torch.complex64)
    for name in ("full_op", "hop"):
        want = getattr(s, name)(v).numpy()
        for r in res:
            assert rel_err(r["coarse"][name], want) < 1e-6, name


# ---------------------------------------------------------------------------
# (d) one multigrid cycle, depth 1 sharded
# ---------------------------------------------------------------------------

def test_sharded_cycle_matches_single_rank(runs, inputs):
    res = runs((1, 2, 1, 1))
    levels = ranks.level_configs(MG_LEVELS, ((2, 2, 2, 2), (1, 1, 1, 1), (1, 1, 1, 1)), 4)
    op = WilsonOperator.from_gauge(torch.as_tensor(inputs["Umg"]), -0.5, 1.0)
    mg = Multigrid(op, MGConfig(levels=levels, dtype=torch.complex128, seed=1))
    mg.set_test_vectors(inputs["tv0"])
    mg.set_test_vectors(inputs["tv1"], depth=1)
    want = mg(convert.fields(inputs["eta"])).numpy()
    for r in res:
        got, sharded = r["cycle"]
        assert sharded == [True, True, False]       # depth 1 runs K5's path
        assert rel_err(got, want) < 1e-5


# ---------------------------------------------------------------------------
# (e) the Solver on the mesh against one rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single_solve(inputs):
    s = api.Solver(config.parse_ini(INI), device="cpu")
    s.set_conf(inputs["U"], links_have_bc=True)
    s.setup()
    rhs = config.make_rhs("ones", s.lattice)
    x, info = s.solve(rhs)
    return x, info.iterations, s.true_residual(x, rhs)


@MESHES
def test_sharded_solver_matches_single_rank(runs, single_solve, dims):
    res = runs(dims)
    x1, it1, exact1 = single_solve
    assert exact1 < 1e-10
    x0, it0, relres0, _ = res[0]["solve"]
    for r in res:
        x, it, relres, exact = r["solve"]
        assert it == it0 and relres == relres0            # every rank agrees
        np.testing.assert_array_equal(x, x0)
        assert exact < 1e-10 and relres < 1e-10
        assert abs(it - it1) <= 1, (it, it1)
        np.testing.assert_allclose(x, x1, atol=1e-6)


# ---------------------------------------------------------------------------
# (f) odd global offsets
# ---------------------------------------------------------------------------

def test_odd_offset_slabs_match_single_rank(runs, inputs):
    res = runs((1, 2, 1, 1))
    assert [r["odd"]["parity"] for r in res] == [0, 1]    # z offsets 0 and 3
    op = WilsonOperator.from_gauge(torch.as_tensor(inputs["Uodd"]), -0.5, 1.0)
    s = WilsonStencilSoA.build(op, Geometry(ODD_LAT, ODD_BLOCK))
    p = torch.as_tensor(inputs["ophi"])
    sap = SchwarzPreconditioner(s, block_iter=2, cycles=2, odd_even=True)
    cs = CoarseStencilSoA.build(convert.coarse_operator(*inputs["oblocks"]),
                                Geometry(ODD_LAT, (1, 1, 1, 1)))
    want = {"even": s.even, "self_inv": s.self_inv(p, ODD), "sap": sap(p),
            "coarse_even": cs.even,
            "coarse_self_inv": cs.self_inv(torch.as_tensor(inputs["ov"]), ODD)}
    for r in res:
        for name, w in want.items():
            assert rel_err(r["odd"][name], w.numpy()) < 1e-12, name


# ---------------------------------------------------------------------------
# (g) method 3 with multigrid on the grid
# ---------------------------------------------------------------------------

def test_sharded_method3_matches_single_rank(runs, inputs):
    res = runs((1, 2, 1, 1))
    s = api.Solver(config.parse_ini(INI_METHOD3), device="cpu")
    s.set_conf(inputs["U"], links_have_bc=True)
    s.setup()
    assert len(s.mg.fine.smoother.colors) == 16
    rhs = config.make_rhs("ones", s.lattice)
    x1, info = s.solve(rhs)
    assert info.converged and s.true_residual(x1, rhs) < 1e-10
    x0, it0, _, _ = res[0]["solve3"]
    for r in res:
        x, it, relres, exact = r["solve3"]
        assert it == it0
        np.testing.assert_array_equal(x, x0)
        assert exact < 1e-10 and relres < 1e-10
        assert abs(it - info.iterations) <= 1, (it, info.iterations)
        np.testing.assert_allclose(x, x1, atol=1e-6)
