"""The port's process grid in all four directions (ddalphaamg_tpu_torch/
parallel on grids that split y and x) against the JAX package and the
port's single-rank path, on the CPU.  Ranks are spawned processes on the
gloo transport running tests/torch_parallel_ranks.py, which imports no JAX;
inputs come from numpy seeds (tests/torch_parity.py).

  (a) mesh helpers and slabs of (1,1,2,1), (1,1,1,2), (1,2,2,1), (2,1,1,2)
      and (2,2,2,1) equal the JAX package's shardings of its logical
      layout bit for bit; grids that do not divide the lattice or the
      Schwarz blocks raise ValueError;
  (b) plain K5 with y and x faces (cut by comm.face) on every slab of
      (1,1,2,2) and (2,2,2,1) equals the JAX coarse operator on the global
      field (complex128, 1e-12);
  (c) one spawned (1,1,2,2) grid:
      - the exchanged faces equal the faces of the globally shifted field;
      - the fine operator in complex64 / complex128 equals the JAX
        wilson.d_plus_clover (1e-6 / 1e-12), the coarse hops the single
        rank's (1e-6);
      - one cycle of a 3-level hierarchy whose depth 1 is sharded along y
        and x equals one rank's (complex128, 1e-5, as
        tests/test_torch_parallel.py (d));
      - the 2-level 4^4 solve from the same initial test vectors takes the
        iterations of the single-rank port and of the JAX package within
        1, x within 1e-8 relative;
      - methods -1, 0, 4, 5 and SAP alone stop as the single-rank port does
        (iterations within 2 % or 1) and their x agrees with the JAX
        package's (1e-8 relative); so does krylov.fgcr with one rank's;
      - an m0 scan row with CGN error tracking agrees with one rank's;
      - the three accelerator options on a 3-level hierarchy whose depth 1
        is sharded keep full-precision coarse blocks and bf16 inverses, as
        the JAX package on a y/x mesh, within 2 iterations of one rank;
      - slabs whose global offset is odd in y (fine level) and in x alone
        (a coarse level) give the single-rank even masks, clover inverse,
        SAP sweep, method 4's parity hops and Schur complement, and coarse
        self-inverse (1e-12).

The JAX references and the single-rank runs are computed in this process
while the ranks run.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks
from test_torch_direct_mg import BF16, CLIP, GRID_BASE, GRID_INI
from test_torch_parallel import INI as INI_MG
from torch_parity import random_spinor, rel_err, rough_field

from ddalphaamg_tpu import api as japi
from ddalphaamg_tpu import config as jconfig
from ddalphaamg_tpu import parallel as jparallel
from ddalphaamg_tpu.mg import hierarchy as jhierarchy
from ddalphaamg_tpu.operators import coarse as jcoarse
from ddalphaamg_tpu.operators import wilson as jwilson
from ddalphaamg_tpu_torch import api, config, convert, io
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.mg.hierarchy import MGConfig, Multigrid
from ddalphaamg_tpu_torch.operators import coarse, fast
from ddalphaamg_tpu_torch.operators.oddeven import OddEvenOperator
from ddalphaamg_tpu_torch.operators.stencil import ODD, CoarseStencilSoA, WilsonStencilSoA
from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator
from ddalphaamg_tpu_torch.parallel import launch
from ddalphaamg_tpu_torch.parallel import mesh as pmesh
from ddalphaamg_tpu_torch.parallel.comm import face
from ddalphaamg_tpu_torch.smoothers.sap import SchwarzPreconditioner

torch.set_num_threads(1)

GRID = (1, 1, 2, 2)
M0, CSW = -0.5, 1.0
FINE = (4, 4, 4, 4)
COARSE = (2, 2, 4, 4)             # (b), (c): d = 8
ODD_FINE, ODD_BLOCK = (2, 2, 6, 4), (2, 2, 3, 2)    # slabs (2, 2, 3, 2): y offset 3
ODD_COARSE = (2, 2, 2, 6)         # slabs (2, 2, 1, 3): x offset 3
# a 3-level hierarchy whose depth 1, (2, 2, 4, 4), stays sharded on the grid
MG_LEVELS = ((4, 4, 8, 8), (2, 2, 4, 4), (1, 1, 2, 2))
MG_BLOCKS = ((2, 2, 2, 2), (1, 1, 1, 1), (1, 1, 1, 1))
# the 2-level solve at mixed precision 0, where both packages' outer loops
# run in complex128 and their iterations agree
INI_SOLVE = INI_MG.replace("mixed precision: 1", "mixed precision: 0")
INI_METHOD = """configuration: {conf}
number of levels: 1
d0 global lattice: 4 4 4 4
d0 block lattice: 2 2 2 2
m0: -0.5
csw: 1.0
tolerance for relative residual: 1E-10
iterations between restarts: 50
maximum of restarts: 20
method: {method}
interpolation: 0
mixed precision: 0
"""
METHODS = {"cgn": -1, "gmres": 0, "oddeven": 4, "bicgstab": 5, "sap": 2}
# the three accelerator options on a 3-level hierarchy whose depth 1 is
# sharded on the grid (tests/test_torch_direct_mg.py's ini at 4 4 8 8)
INI_OPTIONS = GRID_BASE.replace("d0 global lattice: 4 8 4 4",
                                "d0 global lattice: 4 4 8 8") + GRID_INI[len(GRID_BASE):] + BF16
SCAN = dict(scan_variable="m0", start_val=-0.5, end_val=-0.5, step_size=0.01,
            track_cgn_error=True)


def _jmesh(dims):
    n = int(np.prod(dims))
    return jparallel.make_solver_mesh(dims=dims, devices=jax.devices()[:n])


def _coarse_blocks(lat, d, seed):
    rng = np.random.default_rng(seed)

    def c(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    return c(*lat, d, d) + 5.0 * np.eye(d), c(4, *lat, d, d), c(4, *lat, d, d)


def _logical(v, lat):
    """[12, V] or [d, V] -> [T, Z, Y, X, dof] numpy."""
    return np.moveaxis(np.asarray(v), 0, -1).reshape(*lat, -1)


# ---------------------------------------------------------------------------
# (a) mesh helpers and slabs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(1, 1, 2, 1), (1, 1, 1, 2), (1, 2, 2, 1), (2, 1, 1, 2),
                                  (2, 2, 2, 1)])
def test_mesh_and_slabs_match_jax(dims):
    lat = (4, 2, 4, 6)
    jm = _jmesh(dims)
    spec = jparallel.site_spec(jm, lat)
    mesh = pmesh.SolverMesh(dims)
    assert pmesh.active_axes(mesh, lat) == tuple(mu for mu in range(4) if spec[mu] is not None)
    assert mesh.splits_yx == (dims[2] > 1 or dims[3] > 1)
    v = random_spinor((*lat, 12), seed=1)
    jv = jparallel.shard_field(jm, jnp.asarray(v), lat)
    devices = list(np.asarray(jm.devices).reshape(-1))
    for shard in jv.addressable_shards:
        rank = devices.index(shard.device)
        mesh = pmesh.SolverMesh(dims, rank)
        loc = pmesh.local_lattice(mesh, lat)
        assert tuple(shard.data.shape[:4]) == loc
        assert mesh.offsets(loc) == tuple(s.start or 0 for s in shard.index[:4])
        assert mesh.parity(loc) == sum(s.start or 0 for s in shard.index[:4]) % 2
        mine = pmesh.shard_field(mesh, torch.as_tensor(v.reshape(-1, 12).T), lat)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data).reshape(-1, 12).T)
    # interpolation rows and operator slabs follow their sites
    clat = (2, 2, 2, 2)
    P = random_spinor((*clat, 2, 3, 5), seed=3)
    jP = jparallel.shard_interpolation(jm, jnp.asarray(P), clat)
    U = rough_field(lat, seed=2)
    op = convert.wilson_operator(U, np.zeros((*lat, 2, 6, 6)))
    jU = jparallel.shard_field(jm, jnp.asarray(np.moveaxis(U, 0, 4)), lat)
    for shard, ushard in zip(jP.addressable_shards, jU.addressable_shards):
        mesh = pmesh.SolverMesh(dims, devices.index(shard.device))
        np.testing.assert_array_equal(convert.interpolation(P, mesh=mesh).numpy(),
                                      np.asarray(shard.data).reshape(-1, 2, 3, 5))
        umesh = pmesh.SolverMesh(dims, devices.index(ushard.device))
        np.testing.assert_array_equal(
            pmesh.shard_operator(umesh, op).links.numpy(),
            np.moveaxis(np.asarray(ushard.data), 4, 0))


@pytest.mark.parametrize("dims, lat, block", [((1, 1, 2, 1), (4, 4, 3, 4), (2, 2, 1, 2)),
                                              ((1, 1, 1, 2), (4, 4, 4, 4), (2, 2, 2, 4)),
                                              ((1, 1, 2, 2), (4, 4, 4, 4), (2, 2, 4, 2))],
                         ids=["lattice", "x-block", "y-block"])
def test_grids_that_do_not_divide_raise(dims, lat, block):
    """The JAX package's assertions (parallel/mesh.py:146-160): the grid
    divides the lattice, and the Schwarz blocks divide the slab."""
    U = rough_field(lat, seed=6)
    ini = INI_METHOD.format(conf="none", method=2).replace(
        "d0 global lattice: 4 4 4 4", "d0 global lattice: " + " ".join(map(str, lat))).replace(
        "d0 block lattice: 2 2 2 2", "d0 block lattice: " + " ".join(map(str, block)))
    s = api.Solver(config.parse_ini(ini), device="cpu", mesh=pmesh.SolverMesh(dims, 0))
    with pytest.raises(ValueError):
        s.set_conf(U, links_have_bc=True)
        s.setup()


# ---------------------------------------------------------------------------
# (b) plain K5 with y / x faces against the JAX coarse operator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(1, 1, 2, 2), (2, 2, 2, 1)])
def test_plain_k5_with_yx_faces_matches_jax(dims):
    d = 8
    A, Df, Db = _coarse_blocks(COARSE, d, 21)
    v = random_spinor((d, int(np.prod(COARSE))), seed=22)
    jphi = jnp.asarray(_logical(v, COARSE))
    jcop = jcoarse.CoarseOperator(jnp.asarray(A), jnp.asarray(Df), jnp.asarray(Db))
    want = {(0, 9): np.asarray(jcoarse.coarse_apply(jcop, jphi)),
            (1, 9): np.asarray(jcoarse.coarse_hop(jcop.Df, jcop.Db, jphi))}
    cop = convert.coarse_operator(A, Df, Db)
    vg = torch.as_tensor(v)
    split = set()
    for rank in range(int(np.prod(dims))):
        mesh = pmesh.SolverMesh(dims, rank)
        loc = pmesh.local_lattice(mesh, COARSE)
        blocks = ranks._coarse_slab(mesh, cop, COARSE).pack()
        halos = {}
        for mu in pmesh.active_axes(mesh, COARSE):   # faces of the shifted field's slabs
            fwd = pmesh.shard_field(mesh, coarse.neighbor(vg, 1 + mu, COARSE), COARSE)
            bwd = pmesh.shard_field(mesh, coarse.neighbor(vg, 5 + mu, COARSE), COARSE)
            halos[mu] = (face(fwd, loc, mu, loc[mu] - 1), face(bwd, loc, mu, 0))
        split |= set(halos)
        vl = pmesh.shard_field(mesh, vg, COARSE)
        for terms, w in want.items():
            got = coarse.coarse_apply_halo_plain(blocks, vl, loc, halos, terms)
            ref = pmesh.shard_field(mesh, torch.as_tensor(
                w.reshape(-1, d).T.copy()), COARSE).numpy()
            assert rel_err(got.numpy(), ref) < 1e-12, (rank, terms)
    assert split == {mu for mu in range(4) if dims[mu] > 1}


# ---------------------------------------------------------------------------
# (c) the spawned (1, 1, 2, 2) grid
# ---------------------------------------------------------------------------

def _jax_tvs(self, level, key):
    v = ranks.draw_test_vectors(level)
    return jnp.asarray(v.reshape(v.shape[0], *level.geom.lattice, *level.dof_shape),
                       dtype=self.cfg.dtype)


def _jax_solve(ini, U, rhs):
    js = japi.Solver(jconfig.parse_ini(ini))
    js.set_conf(U, links_have_bc=True)
    js.setup()
    jx, jinfo = js.solve(rhs)
    return np.asarray(jx), jinfo.iterations


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """Starts the grid's ranks, computes the references meanwhile; returns
    (inputs, the ranks' results, references)."""
    conf = str(tmp_path_factory.mktemp("grid4d") / "conf4")
    U = rough_field(FINE, seed=3)
    Um = rough_field(FINE, seed=11)
    io.write_gauge_field(conf, U, plaquette=0.0, anti_periodic=True)
    x = dict(U=U, Um=Um, phi=random_spinor((12, int(np.prod(FINE))), seed=9),
             cblocks=_coarse_blocks(COARSE, 8, 10),
             cv=random_spinor((2, 8, int(np.prod(COARSE))), 11),
             rhs=random_spinor((*FINE, 4, 3), seed=12),
             Uodd=rough_field(ODD_FINE, seed=4),
             ophi=random_spinor((12, int(np.prod(ODD_FINE))), 14),
             oblocks=_coarse_blocks(ODD_COARSE, 4, 12),
             ov=random_spinor((4, int(np.prod(ODD_COARSE))), 13),
             Umg=rough_field(MG_LEVELS[0], seed=8),
             tv0=random_spinor((4, *MG_LEVELS[0], 4, 3), seed=5),
             tv1=random_spinor((4, *MG_LEVELS[1], 8), seed=6),
             eta=random_spinor((*MG_LEVELS[0], 4, 3), seed=7))
    A, Df, Db = x["cblocks"]
    cases = {f"fine_{dt}": ("fine_full_op", dict(lattice=FINE, U=U, m0=M0, csw=CSW,
                                                 phi=x["phi"], dtype=dt))
             for dt in (torch.complex64, torch.complex128)}
    cases["coarse"] = ("coarse_hops", dict(lattice=COARSE, A=A, Df=Df, Db=Db, v=x["cv"]))
    cases["faces"] = ("faces", dict(lattice=COARSE, v=x["cv"][0]))
    cases["solve"] = ("solve", dict(ini=INI_SOLVE, U=U, same_tvs=True))
    method_inis = {name: INI_METHOD.format(conf="none", method=m) for name, m in METHODS.items()}
    for name, ini in method_inis.items():
        cases[name] = ("solve", dict(ini=ini, U=Um, rhs=x["rhs"]))
    scan_ini = INI_SOLVE.replace("number of levels", f"configuration: {conf}\nnumber of levels")
    cases["scan"] = ("scan", dict(ini=scan_ini, sc=SCAN))
    cases["fgcr"] = ("fgcr", dict(lattice=FINE, U=Um, b=x["phi"]))
    cases["options"] = ("solve_sharded_levels", dict(ini=INI_OPTIONS, U=x["Umg"],
                                                     inner_tol_clip=CLIP))
    cases["cycle"] = ("mg_cycle", dict(levels=ranks.level_configs(MG_LEVELS, MG_BLOCKS, 4),
                                       U=x["Umg"], tv0=x["tv0"], tv1=x["tv1"], eta=x["eta"],
                                       seed=1))
    A, Df, Db = x["oblocks"]
    cases["odd"] = ("odd_offset", dict(lattice=ODD_FINE, block=ODD_BLOCK, U=x["Uodd"],
                                       phi=x["ophi"], A=A, Df=Df, Db=Db, v=x["ov"],
                                       clattice=ODD_COARSE))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(launch.run_ranks, ranks.run, GRID, "gloo",
                              ["cpu"] * int(np.prod(GRID)), cases)
        ref = {"single": {name: ranks.solve(None, ini, Um, x["rhs"])
                          for name, ini in method_inis.items()},
               "jax": {name: _jax_solve(ini, Um, x["rhs"])
                       for name, ini in method_inis.items()}}
        ref["single"]["solve"] = ranks.solve(None, INI_SOLVE, U, same_tvs=True)
        mp = pytest.MonkeyPatch()
        mp.setattr(jhierarchy.Multigrid, "_initial_test_vectors", _jax_tvs)
        try:
            ref["jax"]["solve"] = _jax_solve(INI_SOLVE, U, config.make_rhs("ones", FINE))
        finally:
            mp.undo()
        ref["scan"] = ranks.scan(None, scan_ini, SCAN)
        ref["fgcr"] = ranks.fgcr(None, FINE, Um, x["phi"])
        ref["options"] = ranks.solve_sharded_levels(None, INI_OPTIONS, x["Umg"], CLIP)
        res = spawned.result()
    return x, res, ref


def test_exchanged_faces_are_the_shifted_fields(grid):
    _, res, _ = grid
    for r in res:
        assert sorted(r["faces"]) == [2, 3]
        for pairs in r["faces"].values():
            for got, want in pairs:
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_fine_operator_matches_jax(grid, dtype):
    x, res, _ = grid
    jop = jwilson.WilsonOperator.from_gauge(jnp.asarray(x["U"]), M0, CSW)
    want = np.asarray(jwilson.d_plus_clover(jop, jnp.asarray(
        fast.spinor_from_soa(torch.as_tensor(x["phi"]), FINE).numpy())))
    tol = 1e-6 if dtype == torch.complex64 else 1e-12
    for r in res:
        got = fast.spinor_from_soa(torch.as_tensor(r[f"fine_{dtype}"]), FINE).numpy()
        assert rel_err(got, want) < tol


def test_coarse_hops_match_single_rank(grid):
    x, res, _ = grid
    s = CoarseStencilSoA.build(convert.coarse_operator(*x["cblocks"], dtype=torch.complex64),
                               Geometry(COARSE, (2, 2, 2, 2)))
    v = torch.as_tensor(x["cv"]).to(torch.complex64)
    for name in ("full_op", "hop"):
        want = getattr(s, name)(v).numpy()
        for r in res:
            assert rel_err(r["coarse"][name], want) < 1e-6, name


def _agree(res, key):
    """Every rank returned the same result; returns rank 0's."""
    x0, it0, relres0, _ = res[0][key]
    for r in res:
        x, it, relres, _ = r[key]
        assert it == it0 and relres == relres0
        np.testing.assert_array_equal(x, x0)
    return res[0][key]


def test_cycle_with_a_sharded_coarse_level_matches_single_rank(grid):
    """Depth 1 sharded along y and x: K5 with y / x faces, the coarse
    Galerkin build's halo shifts and the SAP on the coarse slab."""
    x, res, _ = grid
    op = WilsonOperator.from_gauge(torch.as_tensor(x["Umg"]), M0, CSW)
    mg = Multigrid(op, MGConfig(levels=ranks.level_configs(MG_LEVELS, MG_BLOCKS, 4),
                                dtype=torch.complex128, seed=1))
    mg.set_test_vectors(x["tv0"])
    mg.set_test_vectors(x["tv1"], depth=1)
    want = mg(convert.fields(x["eta"])).numpy()
    for r in res:
        got, sharded = r["cycle"]
        assert sharded == [True, True, False]
        assert rel_err(got, want) < 1e-5


def test_options_on_a_yx_grid_keep_full_precision_blocks(grid):
    """On a grid that splits y or x the JAX package runs its logical layouts,
    whose coarse stencils have no bf16 copy: coarse block bf16 stores only
    the inverses in bf16 (its hierarchy.py:526-535, :595-604, :613-624).
    One rank compresses its blocks; the grid's iterations stay within 2 of
    it (the bound of bf16 blocks, tests/test_split_mode.py:192)."""
    _, res, ref = grid
    _, it1, exact1, levels1 = ref["options"]
    assert levels1[1][1] == "torch.bfloat16"              # one rank: bf16 blocks
    x0, it0, _, levels0 = res[0]["options"]
    assert levels0 == [(True, None, None, "NoneType"),
                       (True, None, "torch.bfloat16", "NoneType"),
                       (False, None, None, "Tensor")]
    for r in res:
        x, it, exact, _ = r["options"]
        assert it == it0 and exact < 1e-10
        np.testing.assert_array_equal(x, x0)
    assert exact1 < 1e-10 and abs(it0 - it1) <= 2, (it0, it1)


def test_multigrid_solve_matches_single_rank_and_jax(grid):
    _, res, ref = grid
    x, it, relres, exact = _agree(res, "solve")
    x1, it1, _, exact1 = ref["single"]["solve"]
    jx, jit = ref["jax"]["solve"]
    assert exact < 1e-10 and relres < 1e-10 and exact1 < 1e-10
    assert abs(it - it1) <= 1 and abs(it - jit) <= 1, (it, it1, jit)
    assert rel_err(x, x1) < 1e-8 and rel_err(x, jx) < 1e-8


@pytest.mark.parametrize("name", list(METHODS))
def test_method_without_multigrid_matches_single_rank_and_jax(grid, name):
    _, res, ref = grid
    x, it, relres, exact = _agree(res, name)
    x1, it1, relres1, _ = ref["single"][name]
    jx, jit = ref["jax"][name]
    assert (relres < 1e-10) == (relres1 < 1e-10)
    assert relres < 1e-10 and exact < 1e-10
    assert abs(it - it1) <= max(1, 0.02 * it1), (it, it1, jit)
    assert rel_err(x, jx) < 1e-8


def test_fgcr_matches_single_rank(grid):
    _, res, ref = grid
    x1, it1 = ref["fgcr"]
    for r in res:
        x, it = r["fgcr"]
        np.testing.assert_array_equal(x, res[0]["fgcr"][0])
        assert abs(it - it1) <= max(1, 0.02 * it1), (it, it1)
        assert rel_err(x, x1) < 1e-8


def test_scan_row_with_cgn_error_matches_single_rank(grid):
    _, res, ref = grid
    (row1,) = ref["scan"]
    (row0,) = res[0]["scan"]
    for r in res:
        (row,) = r["scan"]
        # every rank agrees (each times its own setup)
        assert {k: v for k, v in row.items() if k != "setup_time"} == \
            {k: v for k, v in row0.items() if k != "setup_time"}
        assert abs(row["solve_iters"] - row1["solve_iters"]) <= 1
        assert row["relres"] < 1e-10 and row["error"] < 1e-8 and row1["error"] < 1e-8


def test_odd_offsets_in_y_and_x_match_single_rank(grid):
    x, res, _ = grid
    # fine slabs (2, 2, 3, 2): y offset 3 on y coordinate 1; coarse slabs
    # (2, 2, 1, 3): offsets y and 3x, odd from x alone on rank (y 0, x 1)
    assert [r["odd"]["parity"] for r in res] == [0, 0, 1, 1]
    assert [r["odd"]["coarse_parity"] for r in res] == [0, 1, 1, 0]
    op = WilsonOperator.from_gauge(torch.as_tensor(x["Uodd"]), M0, CSW)
    s = WilsonStencilSoA.build(op, Geometry(ODD_FINE, ODD_BLOCK))
    p = torch.as_tensor(x["ophi"])
    oe = OddEvenOperator(s)
    cs = CoarseStencilSoA.build(convert.coarse_operator(*x["oblocks"]),
                                Geometry(ODD_COARSE, (1, 1, 1, 1)))
    want = {"even": s.even, "self_inv": s.self_inv(p, ODD),
            "sap": SchwarzPreconditioner(s, block_iter=2, cycles=2, odd_even=True)(p),
            "hop_from_odd": oe.hop_from_odd(p), "hop_from_even": oe.hop_from_even(p),
            "schur": oe.schur(oe.even * p), "coarse_even": cs.even,
            "coarse_self_inv": cs.self_inv(torch.as_tensor(x["ov"]), ODD)}
    for r in res:
        for name, w in want.items():
            assert rel_err(r["odd"][name], w.numpy()) < 1e-12, name
