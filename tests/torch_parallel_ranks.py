"""The rank side of tests/test_torch_parallel.py, tests/test_torch_grid4d.py,
tests/test_torch_setup_api.py and tests/test_torch_setup_graph.py:
functions that every rank of a spawned process grid runs
(parallel/launch.run_ranks).  This module imports the
port and never JAX, so the spawned ranks stay free of it; the test process
makes the inputs with numpy and holds the results against the JAX package
and the single-rank port (which runs the same functions with mesh None)."""

import dataclasses

import numpy as np
import torch

from ddalphaamg_tpu_torch import api, config, convert, evaluation
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.mg.hierarchy import LevelConfig, MGConfig, Multigrid
from ddalphaamg_tpu_torch.operators import coarse
from ddalphaamg_tpu_torch.operators.coarse import CoarseOperator
from ddalphaamg_tpu_torch.operators.oddeven import OddEvenOperator
from ddalphaamg_tpu_torch.operators.stencil import ODD, CoarseStencilSoA, WilsonStencilSoA
from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator
from ddalphaamg_tpu_torch.parallel.comm import exchange_faces, face
from ddalphaamg_tpu_torch.parallel.mesh import (active_axes, gather_field, local_lattice,
                                                shard_field)
from ddalphaamg_tpu_torch.smoothers.sap import SchwarzPreconditioner
from ddalphaamg_tpu_torch.solvers import krylov


def draw_test_vectors(level):
    """The initial test vectors of a level, [N, T, Z, Y, X, dof] (numpy on
    the global lattice), drawn alike for the port and the JAX package."""
    rng = np.random.default_rng(100 + level.depth)
    dof = 12 if level.depth == 0 else 2 * level.cfg.num_test_vectors
    shape = (level.cfg.num_test_vectors, *level.geom.lattice, dof)
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _drawn_test_vectors(self, level, gen):
    """Multigrid._initial_test_vectors replaced by draw_test_vectors (this
    rank's slab of it)."""
    s = level.stencil
    return s.slab(s.from_logical(torch.as_tensor(draw_test_vectors(level)))).to(s.device,
                                                                                s.dtype)


def _coarse_slab(mesh, cop, lattice):
    """This rank's slab of a site-major coarse operator (sites on axis -3)."""
    def slab(a):
        return shard_field(mesh, a.movedim(-3, -1), lattice).movedim(-1, -3).contiguous()

    return CoarseOperator(slab(cop.A), slab(cop.Df), slab(cop.Db))


def fine_full_op(mesh, lattice, U, m0, csw, phi, dtype):
    """The sharded fine operator on the global field phi [12, V]."""
    op = WilsonOperator.from_gauge(torch.as_tensor(U), m0, csw)
    loc = local_lattice(mesh, lattice)
    s = WilsonStencilSoA.build(convert.wilson_operator(op.links, op.clover, mesh=mesh),
                               Geometry(loc, (2, 2, 2, 2)), dtype=dtype, mesh=mesh)
    out = s.full_op(shard_field(mesh, torch.as_tensor(phi).to(dtype), lattice))
    return gather_field(mesh, out, loc).numpy()


def coarse_hops(mesh, lattice, A, Df, Db, v):
    """The sharded coarse full_op and hop (K5 with exchanged faces)."""
    cop = convert.coarse_operator(A, Df, Db, dtype=torch.complex64)
    loc = local_lattice(mesh, lattice)
    s = CoarseStencilSoA.build(_coarse_slab(mesh, cop, lattice),
                               Geometry(loc, (2, 2, 2, 2)), mesh=mesh)
    vs = shard_field(mesh, torch.as_tensor(v).to(torch.complex64), lattice)
    return {name: gather_field(mesh, getattr(s, name)(vs), loc).numpy()
            for name in ("full_op", "hop")}


def mg_cycle(mesh, levels, U, tv0, tv1, eta, seed):
    """One complex128 multigrid cycle with injected test vectors; every
    intermediate level sharded (min_local_sites=0).  Returns the gathered
    cycle output and which levels were sharded."""
    lattice = levels[0].lattice
    op = WilsonOperator.from_gauge(torch.as_tensor(U), -0.5, 1.0)
    mg = Multigrid(convert.wilson_operator(op.links, op.clover, mesh=mesh),
                   MGConfig(levels=levels, dtype=torch.complex128, seed=seed,
                            mesh=mesh, min_local_sites=0))
    mg.set_test_vectors(tv0)
    mg.set_test_vectors(tv1, depth=1)
    x = mg(convert.fields(eta, mesh=mesh))
    sharded = [lvl.stencil.mesh is not None for lvl in mg._levels()]
    return gather_field(mesh, x, local_lattice(mesh, lattice)).numpy(), sharded


def solve(mesh, ini, U, rhs=None, same_tvs=False):
    """Solver on the mesh (None: one rank) of rhs (None: ones): (x,
    iterations, solver relres, exact relres).  same_tvs: the hierarchy
    starts from draw_test_vectors."""
    initial = Multigrid._initial_test_vectors
    if same_tvs:
        Multigrid._initial_test_vectors = _drawn_test_vectors
    try:
        s = api.Solver(config.parse_ini(ini), device="cpu", mesh=mesh)
        s.set_conf(U, links_have_bc=True)
        s.setup()
        rhs = config.make_rhs("ones", s.lattice) if rhs is None else rhs
        x, info = s.solve(rhs)
    finally:
        Multigrid._initial_test_vectors = initial
    return x, info.iterations, info.relres, s.true_residual(x, rhs)


def fgcr(mesh, lattice, U, b):
    """krylov.fgcr on the complex128 fine operator (sharded over the mesh;
    None: one rank) of rhs b [12, V]: (gathered x, iterations)."""
    loc = lattice if mesh is None else local_lattice(mesh, lattice)
    op = WilsonOperator.from_gauge(torch.as_tensor(U), -0.5, 1.0)
    s = WilsonStencilSoA.build(convert.wilson_operator(op.links, op.clover, mesh=mesh),
                               Geometry(loc, (2, 2, 2, 2)), mesh=mesh)
    bs = torch.as_tensor(b) if mesh is None else shard_field(mesh, torch.as_tensor(b), lattice)
    res = krylov.fgcr(s.full_op, bs, tol=1e-10, restart_length=30, mesh=mesh)
    x = res.x if mesh is None else gather_field(mesh, res.x, loc)
    return x.numpy(), res.iterations


def scan(mesh, ini, sc):
    """evaluation.run_scan of the ScanConfig fields sc on the mesh (None:
    one rank): the rows as dicts."""
    rows = evaluation.run_scan(config.parse_ini(ini), evaluation.ScanConfig(**sc),
                               printer=lambda text: None, device="cpu", mesh=mesh)
    return [dataclasses.asdict(r) for r in rows]


def faces(mesh, lattice, v):
    """{mu: (fwd, bwd)} of the global field v [d, V] as comm.exchange_faces
    delivers them to this rank, and as cut from the slabs of the globally
    shifted field, for every split axis."""
    loc = local_lattice(mesh, lattice)
    vg = torch.as_tensor(v)
    out = {}
    for mu in active_axes(mesh, lattice):
        got = exchange_faces(mesh, shard_field(mesh, vg, lattice), loc, mu)
        fwd = shard_field(mesh, coarse.neighbor(vg, 1 + mu, lattice), lattice)
        bwd = shard_field(mesh, coarse.neighbor(vg, 5 + mu, lattice), lattice)
        want = (face(fwd, loc, mu, loc[mu] - 1), face(bwd, loc, mu, 0))
        out[mu] = [(g.numpy(), w.numpy()) for g, w in zip(got, want)]
    return out


def solve_multi(mesh, ini, U, rhs):
    """Solver.solve_multi on the mesh (None: one rank) of the right-hand
    sides rhs [B, T, Z, Y, X, 4, 3]: (x, iterations, exact relres of each
    lane)."""
    s = api.Solver(config.parse_ini(ini), device="cpu", mesh=mesh)
    s.set_conf(U, links_have_bc=True)
    s.setup()
    x, infos = s.solve_multi(rhs)
    return (x, [i.iterations for i in infos],
            [s.true_residual(xi, bi) for xi, bi in zip(x, rhs)])


def setup_programs(mesh, ini, U):
    """A Solver's setup on the mesh (None: one rank) with device programs
    allowed on the CPU through the stand-in capture: (programs asked for,
    captures, programs held after the setup), none on a mesh."""
    from torch_graph_stub import StubGraph

    from ddalphaamg_tpu_torch.mg import hierarchy

    asked = []
    real = Multigrid._program

    def program(self, *args, **kwargs):
        asked.append(args[0].__name__)
        return real(self, *args, **kwargs)

    saved = hierarchy.GRAPH_DEVICES, hierarchy.GRAPH_CAPTURE
    hierarchy.GRAPH_DEVICES, hierarchy.GRAPH_CAPTURE = ("cuda", "cpu"), StubGraph
    Multigrid._program = program
    StubGraph.captures = 0
    try:
        s = api.Solver(config.parse_ini(ini), device="cpu", mesh=mesh)
        s.set_conf(U, links_have_bc=True)
        s.setup()
    finally:
        hierarchy.GRAPH_DEVICES, hierarchy.GRAPH_CAPTURE = saved
        Multigrid._program = real
    return asked, StubGraph.captures, len(s.mg.programs)


def solve_sharded_levels(mesh, ini, U, inner_tol_clip=None):
    """Solver whose intermediate levels are all sharded (min_local_sites 0;
    mesh None: one rank): (x, iterations, exact relres, per level (sharded,
    cycle stencil dtype, block inverse dtype, dense inverse kind))."""
    p = config.parse_ini(ini)
    p.inner_tol_clip = inner_tol_clip
    s = api.Solver(p, device="cpu", mesh=mesh)
    s.set_conf(U, links_have_bc=True)
    cfg = s._mg_config()
    cfg.min_local_sites = 0
    s.mg = Multigrid(s._op_slab, cfg)
    s.mg.bootstrap_setup()
    rhs = config.make_rhs("ones", s.lattice)
    x, info = s.solve(rhs)
    levels = [(lvl.stencil.mesh is not None,
               None if lvl.cycle_stencil is None else str(lvl.cycle_stencil.Pk.dtype),
               None if lvl.block_inv is None else str(lvl.block_inv.dtype),
               type(lvl.dense_inv).__name__) for lvl in s.mg._levels()]
    return x, info.iterations, s.true_residual(x, rhs), levels


def odd_offset(mesh, lattice, block, U, phi, A, Df, Db, v, clattice=None):
    """Odd-even pieces on slabs whose global offset is odd: the fine even
    mask, odd-site clover inverse, a block odd-even SAP sweep and method 4's
    pieces (D_eo, D_oe, the Schur complement), and the coarse odd-site
    self-coupling inverse on clattice (default: lattice), all gathered."""
    loc = local_lattice(mesh, lattice)
    clattice = lattice if clattice is None else clattice
    cloc = local_lattice(mesh, clattice)
    op = WilsonOperator.from_gauge(torch.as_tensor(U), -0.5, 1.0)
    s = WilsonStencilSoA.build(convert.wilson_operator(op.links, op.clover, mesh=mesh),
                               Geometry(loc, block), mesh=mesh)
    p = shard_field(mesh, torch.as_tensor(phi), lattice)
    sap = SchwarzPreconditioner(s, block_iter=2, cycles=2, odd_even=True)
    oe = OddEvenOperator(s)
    cs = CoarseStencilSoA.build(_coarse_slab(mesh, convert.coarse_operator(A, Df, Db),
                                             clattice),
                                Geometry(cloc, (1, 1, 1, 1)), mesh=mesh)
    out = {"even": s.even, "self_inv": s.self_inv(p, ODD), "sap": sap(p),
           "hop_from_odd": oe.hop_from_odd(p), "hop_from_even": oe.hop_from_even(p),
           "schur": oe.schur(oe.even * p)}
    out = {k: gather_field(mesh, o, loc).numpy() for k, o in out.items()}
    cout = {"coarse_even": cs.even,
            "coarse_self_inv": cs.self_inv(shard_field(mesh, torch.as_tensor(v), clattice), ODD)}
    out.update({k: gather_field(mesh, o, cloc).numpy() for k, o in cout.items()})
    return {"parity": s.parity_offset, "coarse_parity": cs.parity_offset, **out}


def run(mesh, device, cases):
    """Every case of `cases` ({name: (function name, kwargs)}) on this rank."""
    torch.set_num_threads(1)
    fns = {"fine_full_op": fine_full_op, "coarse_hops": coarse_hops,
           "mg_cycle": mg_cycle, "solve": solve, "odd_offset": odd_offset,
           "solve_sharded_levels": solve_sharded_levels, "solve_multi": solve_multi,
           "scan": scan, "faces": faces, "fgcr": fgcr, "setup_programs": setup_programs}
    return {name: fns[fn](mesh, **kw) for name, (fn, kw) in cases.items()}


def level_configs(lattices, blocks, n):
    """LevelConfigs of a small hierarchy (no bootstrap iterations)."""
    return [LevelConfig(lattice=lat, block=blk, post_smooth_iter=1, block_iter=2,
                        num_test_vectors=n, setup_iter=0)
            for lat, blk in zip(lattices, blocks)]
