"""The rank side of tests/test_torch_grid_programs.py: functions that every
rank of a spawned gloo grid on the CPU runs (parallel/launch.run_ranks).
This module imports the port and never JAX; the test process makes the
inputs with numpy and holds the results against the JAX package.

Device programs run through the stand-in capture (tests/torch_graph_stub.
StubGraph: every loop body recorded once with host reads refused, then
replayed with its control flow on the host; here also refusing tensors
made from host data, StrictStub).  `programs(levels_too)` lets
the hierarchy capture on the CPU: the replicated levels always (their
solves hold no collective), the sharded ones too with levels_too, which
lets the stand-in hold gloo's collectives as a CUDA capture holds NCCL's.
"""

import contextlib
import sys

import torch
from torch_graph_stub import StubGraph

from ddalphaamg_tpu_torch import convert
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.mg import hierarchy
from ddalphaamg_tpu_torch.mg.hierarchy import MGConfig, Multigrid
from ddalphaamg_tpu_torch.operators import cuda_coarse, cuda_dslash
from ddalphaamg_tpu_torch.operators.stencil import CoarseStencilSoA, WilsonStencilSoA
from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator
from ddalphaamg_tpu_torch.parallel import comm, shard_ops, soa_halo
from ddalphaamg_tpu_torch.parallel.comm import exchange, exchange_faces, exchange_start, face
from ddalphaamg_tpu_torch.parallel.mesh import (active_axes, gather_field, local_lattice,
                                                shard_field)
from ddalphaamg_tpu_torch.profiling import OFF, PROF, SPANS
from ddalphaamg_tpu_torch.solvers.fgmres import fgmres, fgmres_mp
from torch_parallel_ranks import _coarse_slab, level_configs


def _from_host(*args, **kwargs):
    raise RuntimeError("a captured program made a tensor from host data (a copy from the "
                       "host, which a CUDA capture refuses)")


# the kernels' plain versions, which run on the CPU only (on a card the
# wrappers launch the kernels instead)
PLAIN_MODULES = tuple(f"ddalphaamg_tpu_torch.operators.{m}" for m in (
    "fast", "coarse", "cuda_coarse", "cuda_dense", "cuda_dslash", "cuda_gcr"))


class StrictStub(StubGraph):
    """The stand-in capture, which also refuses tensors made from host data
    (torch.tensor, torch.as_tensor of a non-tensor, torch.from_numpy) outside
    the kernels' plain versions: on a card they copy from pageable host
    memory, which a capture refuses."""

    @contextlib.contextmanager
    def _capturing(self):
        saved = torch.tensor, torch.as_tensor, torch.from_numpy

        def strict(fn):
            def made(data, *args, **kwargs):
                caller = sys._getframe(1).f_globals.get("__name__", "")
                if not isinstance(data, torch.Tensor) and not caller.startswith(PLAIN_MODULES):
                    _from_host()
                return fn(data, *args, **kwargs)
            return made

        torch.tensor, torch.as_tensor, torch.from_numpy = (strict(f) for f in saved)
        try:
            with super()._capturing():
                yield
        finally:
            torch.tensor, torch.as_tensor, torch.from_numpy = saved


@contextlib.contextmanager
def programs(levels_too: bool):
    """Device programs on the CPU through the stand-in capture (module
    note)."""
    saved = (hierarchy.GRAPH_DEVICES, hierarchy.GRAPH_CAPTURE, comm.CAPTURED_TRANSPORTS)
    hierarchy.GRAPH_DEVICES, hierarchy.GRAPH_CAPTURE = ("cpu",), StrictStub
    if levels_too:
        comm.CAPTURED_TRANSPORTS = ("nccl", "gloo")
    StubGraph.captures = 0
    try:
        yield StubGraph
    finally:
        hierarchy.GRAPH_DEVICES, hierarchy.GRAPH_CAPTURE, comm.CAPTURED_TRANSPORTS = saved


@contextlib.contextmanager
def host_loops():
    """No device program, the CPU's default."""
    saved = hierarchy.GRAPH_DEVICES
    hierarchy.GRAPH_DEVICES = ()
    try:
        yield
    finally:
        hierarchy.GRAPH_DEVICES = saved


def _multigrid(mesh, lattices, blocks, n_tv, U, tvs, **cfg):
    """A complex64 Multigrid on the mesh with injected test vectors (the
    global arrays tvs, one per level but the coarsest)."""
    op = WilsonOperator.from_gauge(torch.as_tensor(U), -0.5, 1.0)
    mg = Multigrid(convert.wilson_operator(op.links, op.clover, mesh=mesh),
                   MGConfig(levels=level_configs(lattices, blocks, n_tv),
                            dtype=torch.complex64, seed=1, mesh=mesh, **cfg))
    for depth, tv in enumerate(tvs):
        mg.set_test_vectors(tv, depth=depth)
    return mg


def _bits(t) -> str:
    """A fingerprint of a tensor's bits (ranks compare theirs)."""
    return t.contiguous().view(torch.uint8).numpy().tobytes().hex()[-64:] + \
        f"{float(t.abs().sum()):.17g}"


def replicated_coarsest(mesh, lattices, blocks, n_tv, U, tvs, b, eta, r, m):
    """The replicated coarsest level's GCR on a gloo grid: one stand-in
    replay against the host loop, bit for bit; a whole cycle and an inner
    restart of length m with the sharded level's host loops around the
    coarsest replays against them with host loops only.  b [B, d, Vc] is
    global (every rank solves it whole), eta [12, V] and r [B, 12, V]
    global."""
    mg = _multigrid(mesh, lattices, blocks, n_tv, U, tvs)
    lvl = mg._levels()[-1]
    bt = torch.as_tensor(b).to(torch.complex64)
    etas = shard_field(mesh, convert.fields(eta).to(torch.complex64), lattices[0])
    rs = shard_field(mesh, convert.fields(r).to(torch.complex64), lattices[0])
    replays = []
    PROF.reset()
    PROF.set_level(SPANS)           # its counters count the replays
    with programs(False) as stub:
        x_g, c_g = mg._coarsest_solve(lvl, bt)
        replays.append(PROF.counters["replays"])
        cyc_g = mg(etas)
        replays.append(PROF.counters["replays"])
        z_g, it_g = mg.inner_restart(rs, 1e-3, m=m)
        replays.append(PROF.counters["replays"])
        used = (mg.uses_graphs(bt, lvl), mg.uses_graphs(etas))
        captures = stub.captures
        programs_made = len(mg.programs)
    PROF.set_level(OFF)
    PROF.reset()
    mg.drop_graphs()
    with host_loops():
        x_h, c_h = mg._coarsest_solve(lvl, bt)
        cyc_h = mg(etas)
        z_h, it_h = mg.inner_restart(rs, 1e-3, m=m)
    return dict(sharded=[lv.stencil.mesh is not None for lv in mg._levels()],
                used=used, captures=captures, replays=replays, programs=programs_made,
                coarsest_equal=bool(torch.equal(x_g, x_h) and torch.equal(c_g, c_h)),
                cycle_equal=bool(torch.equal(cyc_g, cyc_h)),
                inner_equal=bool(torch.equal(z_g, z_h) and torch.equal(it_g, it_h)),
                inner_iterations=it_g.tolist(),
                bits=_bits(x_g), iterations=c_g[:, 0].tolist())


def slab_programs(mesh, lattices, blocks, n_tv, U, tvs, r, eta, m):
    """The sharded inner restart and cycle as stand-in programs with gloo's
    collectives inside (their capture refuses every host read) against
    the host loops: (bit-equal flags, iterations, the gathered z)."""
    mg = _multigrid(mesh, lattices, blocks, n_tv, U, tvs)
    loc = local_lattice(mesh, lattices[0])
    rs = shard_field(mesh, convert.fields(r).to(torch.complex64), lattices[0])
    etas = shard_field(mesh, convert.fields(eta).to(torch.complex64), lattices[0])
    rel = torch.tensor([1e-3, 1e-2][:rs.shape[0]], dtype=torch.float64)
    with programs(True) as stub:
        z_g, it_g = mg.inner_restart(rs, rel, m=m)
        cyc_g = mg(etas)
        kinds = sorted(k[0] for k in mg.programs)
        captures = stub.captures
        stats_g = dict(mg.stats)
    mg.drop_graphs()
    for key in mg.stats:
        mg.stats[key] = 0.0
    with host_loops():
        z_h, it_h = mg.inner_restart(rs, rel, m=m)
        cyc_h = mg(etas)
    return dict(sharded=[lv.stencil.mesh is not None for lv in mg._levels()],
                programs=kinds, captures=captures,
                z_equal=bool(torch.equal(z_g, z_h)), iters_equal=bool(torch.equal(it_g, it_h)),
                cycle_equal=bool(torch.equal(cyc_g, cyc_h)),
                stats_equal=stats_g == dict(mg.stats), iterations=it_g.tolist(),
                z=gather_field(mesh, z_g, loc).numpy())


def setup_on_grid(mesh, U, lattices, blocks, n_tv, setup_iter):
    """The bootstrap setup of a Multigrid whose intermediate level is sharded
    too (min_local_sites 0), its sweeps as stand-in programs with the gloo
    collectives inside and re_setup in place (the replicated coarsest
    level's blocks gathered into their storage), against the setup with
    host loops: per level, whether the gathered test vectors are bit-equal;
    the programs' kinds and captures."""
    from ddalphaamg_tpu_torch.mg.hierarchy import LevelConfig

    levels = [LevelConfig(lattice=lat, block=blk, post_smooth_iter=1, block_iter=2,
                          num_test_vectors=n_tv, setup_iter=setup_iter)
              for lat, blk in zip(lattices, blocks)]
    op = WilsonOperator.from_gauge(torch.as_tensor(U), -0.5, 1.0)
    lop = convert.wilson_operator(op.links, op.clover, mesh=mesh)
    runs = []
    for way in ("programs", "host loops"):
        mg = Multigrid(lop, MGConfig(levels=levels, dtype=torch.complex64, seed=5, mesh=mesh,
                                     min_local_sites=0))
        asked = []
        real = Multigrid._program

        def program(self, *args, **kwargs):
            asked.append(args[0].__name__)
            return real(self, *args, **kwargs)

        Multigrid._program = program
        try:
            with programs(True) if way == "programs" else host_loops() as stub:
                mg.bootstrap_setup()
                captures = stub.captures if way == "programs" else 0
        finally:
            Multigrid._program = real
        tvs = [gather_field(mesh, lvl.test_vectors, lvl.stencil.lattice)
               if lvl.stencil.mesh is not None else lvl.test_vectors
               for lvl in mg._levels()[:-1]]
        runs.append((tvs, sorted(set(asked)), captures,
                     [lvl.stencil.mesh is not None for lvl in mg._levels()]))
    (tg, kinds, captures, sharded), (th, _, _, _) = runs
    return dict(equal=[bool(torch.equal(a, b)) for a, b in zip(tg, th)], kinds=kinds,
                captures=captures, sharded=sharded)


def _blocking_face_corrections(mesh, links, phi, out, lattice, parity=None):
    """The face corrections as the port made them before the overlap: one
    blocking exchange and two products per axis, one axis after another."""
    p = phi.reshape(*phi.shape[:-2], 4, 3, *lattice)
    o = out.view(p.shape)
    u = links.reshape(4, 3, 3, *lattice)
    tb = soa_halo.face_tables(phi.device, phi.dtype)
    keep = None
    if parity is not None:
        from ddalphaamg_tpu_torch.operators.fast import _cached_mask
        keep = _cached_mask(tuple(lattice), int(parity), mesh.parity(lattice),
                            p.real.dtype, p.device).reshape(lattice)
    for mu in active_axes(mesh, mesh.global_lattice(lattice)):
        n = lattice[mu]
        ax = p.dim() - 4 + mu
        u_last = u[mu].narrow(2 + mu, n - 1, 1)
        h_first = soa_halo._half(p.narrow(ax, 0, 1), mu, -1, tb)
        w_last = torch.einsum("BAtzyx,...sBtzyx->...sAtzyx", u_last.conj(),
                              soa_halo._half(p.narrow(ax, n - 1, 1), mu, +1, tb))
        recv_h, recv_w = exchange(mesh, mu, to_minus=h_first, to_plus=w_last)
        fwd = soa_halo._lift(torch.einsum("ABtzyx,...sBtzyx->...sAtzyx", u_last,
                                          recv_h - h_first), mu, -1, tb)
        bwd = soa_halo._lift(recv_w - w_last, mu, +1, tb)
        if keep is not None:
            fwd = fwd * keep.narrow(mu, n - 1, 1)
            bwd = bwd * keep.narrow(mu, 0, 1)
        o.narrow(ax, n - 1, 1).add_(fwd)
        o.narrow(ax, 0, 1).add_(bwd)
    return out


def overlap_ops(mesh, lattice, U, phi, clattice, A, Df, Db, v):
    """The start / finish exchange, the overlapped fine operator (full and
    odd-site hop) and the overlapped K5 plain path against the blocking
    forms, on this rank's slab; the gathered overlapped results for the
    JAX package's sharded operators."""
    loc, cloc = local_lattice(mesh, lattice), local_lattice(mesh, clattice)
    out = {}
    vg = torch.as_tensor(v).to(torch.complex64)
    vs = shard_field(mesh, vg, clattice)
    axes = active_axes(mesh, clattice)
    blocking = [exchange_faces(mesh, vs, cloc, mu) for mu in axes]
    started = exchange_start(mesh, [(mu, face(vs, cloc, mu, 0),
                                     face(vs, cloc, mu, cloc[mu] - 1)) for mu in axes]).finish()
    out["exchange_equal"] = all(torch.equal(a, b) for pa, pb in zip(blocking, started)
                                for a, b in zip(pa, pb))
    op = WilsonOperator.from_gauge(torch.as_tensor(U), -0.5, 1.0)
    for dt in (torch.complex64, torch.complex128):
        s = WilsonStencilSoA.build(convert.wilson_operator(op.links, op.clover, mesh=mesh),
                                   Geometry(loc, (2, 2, 2, 2)), dtype=dt, mesh=mesh)
        ps = shard_field(mesh, torch.as_tensor(phi).to(dt), lattice)
        full = s.full_op(ps)
        old = _blocking_face_corrections(mesh, s.links, ps, cuda_dslash.d_plus_clover(
            s.links, s.cdiag, s.coff, ps, loc), loc)
        hop = shard_ops.wilson_hopping(mesh, s.links, ps, loc, 1)
        old_hop = _blocking_face_corrections(mesh, s.links, ps, cuda_dslash.hopping(
            s.links, ps, loc, 1, mesh.parity(loc)), loc, 1)
        name = "c64" if dt == torch.complex64 else "c128"
        out[f"fine_{name}"] = gather_field(mesh, full, loc).numpy()
        out[f"fine_err_{name}"] = float((full - old).abs().max() / old.abs().max())
        out[f"hop_err_{name}"] = float((hop - old_hop).abs().max() / old_hop.abs().max())
    cs = CoarseStencilSoA.build(_coarse_slab(mesh, convert.coarse_operator(
        A, Df, Db, dtype=torch.complex64), clattice), Geometry(cloc, (2, 2, 2, 2)), mesh=mesh)
    halos = dict(zip(axes, blocking))
    whole = cuda_coarse.coarse_apply_halo(cs.Pk, vs, cloc, halos)
    hops = shard_ops.coarse_hops(mesh, cs.Pk, vs, cloc, (0, 9))
    out["k5_equal"] = bool(torch.equal(hops, whole))
    out["k5"] = gather_field(mesh, hops, cloc).numpy()
    return out


def fgmres_grid(mesh, lattice, U, b, kinds):
    """The port's fgmres (complex128) and fgmres_mp (complex64 Arnoldi) of
    the sharded fine operator with each single_reduce value of kinds:
    {(solver, value): (iterations, converged, gathered x)}."""
    loc = lattice if mesh is None else local_lattice(mesh, lattice)
    op = WilsonOperator.from_gauge(torch.as_tensor(U), -0.5, 1.0)
    lop = convert.wilson_operator(op.links, op.clover, mesh=mesh)
    s128 = WilsonStencilSoA.build(lop, Geometry(loc, (2, 2, 2, 2)), mesh=mesh)
    s64 = WilsonStencilSoA.build(lop, Geometry(loc, (2, 2, 2, 2)), dtype=torch.complex64,
                                 mesh=mesh)
    bg = convert.fields(b)
    bs = bg if mesh is None else shard_field(mesh, bg, lattice)

    def mp_op(v):
        return (s128 if v.dtype == torch.complex128 else s64).full_op(v)

    out = {}
    for kind in kinds:
        for name in ("fgmres", "fgmres_mp"):
            if name == "fgmres":
                res = fgmres(s128.full_op, bs, tol=1e-9, restart_length=20, max_restarts=30,
                             mesh=mesh, single_reduce=kind)
            else:
                res = fgmres_mp(mp_op, bs, tol=1e-9, restart_length=10, max_restarts=60,
                                mesh=mesh, single_reduce=kind)
            x = res.x if mesh is None else gather_field(mesh, res.x, loc)
            out[(name, kind)] = (res.iterations, res.converged, x.numpy())
    return out


def run(mesh, device, cases):
    """Every case of `cases` ({name: (function name, kwargs)}) on this rank."""
    torch.set_num_threads(1)
    fns = {"replicated_coarsest": replicated_coarsest, "slab_programs": slab_programs,
           "overlap_ops": overlap_ops, "fgmres_grid": fgmres_grid,
           "setup_on_grid": setup_on_grid}
    return {name: fns[fn](mesh, **kw) for name, (fn, kw) in cases.items()}
