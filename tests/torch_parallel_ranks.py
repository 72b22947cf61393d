"""The rank side of tests/test_torch_parallel.py: functions that every rank
of a spawned process grid runs (parallel/launch.run_ranks).  This module
imports the port and never JAX, so the spawned ranks stay free of it; the
test process makes the inputs with numpy and holds the results against the
JAX package and the single-rank port."""

import torch

from ddalphaamg_tpu_torch import api, config, convert
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.mg.hierarchy import LevelConfig, MGConfig, Multigrid
from ddalphaamg_tpu_torch.operators.coarse import CoarseOperator
from ddalphaamg_tpu_torch.operators.stencil import ODD, CoarseStencilSoA, WilsonStencilSoA
from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator
from ddalphaamg_tpu_torch.parallel.mesh import gather_field, local_lattice, shard_field
from ddalphaamg_tpu_torch.smoothers.sap import SchwarzPreconditioner


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


def solve(mesh, ini, U):
    """Solver on the mesh: (x, iterations, solver relres, exact relres)."""
    s = api.Solver(config.parse_ini(ini), device="cpu", mesh=mesh)
    s.set_conf(U, links_have_bc=True)
    s.setup()
    rhs = config.make_rhs("ones", s.lattice)
    x, info = s.solve(rhs)
    return x, info.iterations, info.relres, s.true_residual(x, rhs)


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


def odd_offset(mesh, lattice, block, U, phi, A, Df, Db, v):
    """Odd-even pieces on slabs whose global offset is odd: the fine even
    mask, odd-site clover inverse and a block odd-even SAP sweep, and the
    coarse odd-site self-coupling inverse, all gathered."""
    loc = local_lattice(mesh, lattice)
    op = WilsonOperator.from_gauge(torch.as_tensor(U), -0.5, 1.0)
    s = WilsonStencilSoA.build(convert.wilson_operator(op.links, op.clover, mesh=mesh),
                               Geometry(loc, block), mesh=mesh)
    p = shard_field(mesh, torch.as_tensor(phi), lattice)
    sap = SchwarzPreconditioner(s, block_iter=2, cycles=2, odd_even=True)
    cs = CoarseStencilSoA.build(_coarse_slab(mesh, convert.coarse_operator(A, Df, Db), lattice),
                                Geometry(loc, (1, 1, 1, 1)), mesh=mesh)
    out = {"parity": s.parity_offset, "even": s.even, "self_inv": s.self_inv(p, ODD),
           "sap": sap(p), "coarse_even": cs.even,
           "coarse_self_inv": cs.self_inv(shard_field(mesh, torch.as_tensor(v), lattice), ODD)}
    return {k: o if isinstance(o, int) else gather_field(mesh, o, loc).numpy()
            for k, o in out.items()}


def run(mesh, device, cases):
    """Every case of `cases` ({name: (function name, kwargs)}) on this rank."""
    torch.set_num_threads(1)
    fns = {"fine_full_op": fine_full_op, "coarse_hops": coarse_hops,
           "mg_cycle": mg_cycle, "solve": solve, "odd_offset": odd_offset,
           "solve_sharded_levels": solve_sharded_levels, "solve_multi": solve_multi}
    return {name: fns[fn](mesh, **kw) for name, (fn, kw) in cases.items()}


def level_configs(lattices, blocks, n):
    """LevelConfigs of a small hierarchy (no bootstrap iterations)."""
    return [LevelConfig(lattice=lat, block=blk, post_smooth_iter=1, block_iter=2,
                        num_test_vectors=n, setup_iter=0)
            for lat, blk in zip(lattices, blocks)]
