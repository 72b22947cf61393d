"""Multigrid hierarchy: level construction, K-cycles, the coarsest solve and
the adaptive (bootstrap) setup.

Reference call paths rebuilt here (as in the JAX package's mg/hierarchy.py):
  * initial hierarchy: coarse_grid_correction_PRECISION_setup
    (src/setup_generic.c:29-108) -- random test vectors smoothed with 1, 2, 3
    SAP cycles (src/setup_generic.c:215-236), aggregate QR -> P, Galerkin
    coarse operator, recurse;
  * cycles: vcycle_PRECISION (src/vcycle_generic.c:91-141) with K-cycle
    FGMRES wrappers on intermediate levels and the odd-even Schur GCR
    coarsest solver (coarse_solve_odd_even_PRECISION,
    src/coarse_oddeven_generic.c:1139);
  * bootstrap: inv_iter_inv_fcycle_PRECISION (src/setup_generic.c:441-503)
    with test_vector_PRECISION_update pulling coarse solutions out of the
    cycle, re_setup_PRECISION rebuilding P and D_c, and the F-cycle
    recursion into coarser levels.

Fields of every level are [dof, V] (operators/stencil.py).  The cycles run a
batch of right-hand sides ("lanes") [B, dof, V] at once, each lane with its
own early exit in every GCR (solvers/device_gmres.py), as the JAX package
vmaps its cycle: the bootstrap runs the cycles of all test vectors of a
level as one batch (_setup_cycles_batch), Solver.solve_multi its right-hand
sides, and a single right-hand side is batch 1 of the same code.  The
cycles' coarse-work counters stay on the device ([B, 3]) and are added to
stats once per preconditioner call or inner restart.

Under a mesh (MGConfig.mesh, a process grid over any of the four axes)
the fine level and every
intermediate level whose slab keeps at least min_local_sites sites are
sharded: each rank holds its slab of the stencil, the test vectors and P,
and the aggregates divide the slab.  The coarsest level, and any level
below a replicated one, is replicated (the reference's gathering,
src/gathering_generic.c:44-209): its right-hand side is all-gathered after
the restriction, every rank solves the same problem on the same bits, and
each keeps its slab of the solution for the interpolation.  Initial test
vectors are drawn on the global lattice and then sliced, so a sharded run
builds the hierarchy a single-rank run builds.

Three options of the JAX package's accelerator configuration (its
mg/hierarchy.py:291-308), each off by default:
  * coarse_block_bf16: the cycles (the bootstrap's setup cycles included)
    see a bf16-compressed copy of every coarse stencil (_cycle_view),
    applied by K4-bf16 / K5-bf16; the Galerkin builds and the inverse
    builds read the full-precision stencil;
  * coarsest_direct: one matvec with a dense inverse of the coarsest
    operator (its even-site Schur complement where odd-even applies)
    replaces the coarsest GCR;
  * smoother_direct: the SAP of every coarse level with a smoother solves
    its blocks with precomputed block inverses instead of MinRes.
The inverses are built lazily at the first cycle after the setup (never
during bootstrap_setup), stored in bf16 with coarse_block_bf16, dropped by
re_setup, and timed (Multigrid.build_times).  On a mesh the replicated
coarsest level builds its inverse redundantly on every rank, and a sharded
level the inverses of the blocks of its slab.  On a mesh that splits y or
x the JAX package runs its logical layouts (its api.py:199-204, and its
parallel/mesh.py:161-187 refuses the packed ones there), whose coarse
stencils have no bf16 copy: there coarse_block_bf16 leaves the coarse
blocks in full precision and stores only the inverses in bf16, as the JAX
package does (its hierarchy.py:526-535, :595-604, :613-624).

Memory (a 32^4 lattice with 28 test vectors: a depth-1 stencil of 9 x 56^2
blocks at 65,536 sites is 14.8 GB in complex64): re_setup drops a level's
stale stencil, bf16 view and inverses before it builds their successors,
the Galerkin build writes the packed blocks directly (mg/galerkin.py), and
the initial test-vector smoothing, the setup cycles and the Galerkin
basis run their lanes in chunks that fit SETUP_MEMORY_SHARE of the card's
free memory (one chunk unless the level is large).  slim_for_solve drops
the test vectors and the full-precision coarse stencils (their bf16 views
stay) once the setup is done.

Device programs (mg/programs.py, mg/coarsest.py).  On a card (uses_graphs:
one rank, or a grid whose sharded levels' collectives a graph's loop body
can hold: nccl, through K8, parallel/peer.py) every inner restart is one
replay of a CUDA graph that holds the fine GCR with the whole cycle inside
(the JAX package's _inner_restart_impl, on a grid its sharded
inner_restart_batch with the face exchanges, all-reduces and gathers
inside), and every preconditioner call
(Multigrid.__call__, methods 1 and 3) one replay of a graph of one cycle:
each GCR in them, the fine one, the K-cycle's and the coarsest, is one
loop with one body and a device-side iteration index, nested, and no
replay reads the device.  The setup's sweeps are programs too (the JAX
package's _setup_cycles_batch and vmapped _inv_iter_2lvl): every chunk of
a level's bootstrap cycles one replay of SetupCycleGraph, every chunk of
an interpolation-1 update one of TwoLevelUpdateGraph.  Inside a setup
(_setup_scope) a level's lane chunk is fixed at the setup's start, the last
chunk padded with copies of a real lane (padded_chunk; the host loops take
the same chunks), and re_setup writes the new P, coarse blocks, their
inverse and bf16 view into the storage the programs read, so one capture
per (program, depth) serves the whole setup; the Gram-Schmidt, the
test-vector updates and the Galerkin builds stay host-launched between the
replays.  A coarsest GCR outside any program on a card is one replay of a
graph of its own (CoarsestGraph); a level keeps one per (batch, field
dtype, block dtype) and checks that its stencil is the one captured.  The
Multigrid keeps one program of each kind (of each kind and depth for the
setup's), for the last (batch, GCR length, dtype, fine operator), and
checks by identity every stencil, interpolation, inverse and smoother it
captured.  re_setup outside a setup, shift_update, slim_for_solve, the
start and end of a setup, Solver.set_conf and Solver.setup drop the
graphs.  A capture or replay that fails raises.  The host loops
(HostControl) stay for tensors on the CPU and for the levels sharded over
gloo, whose collectives no capture holds; a replicated level (the
coarsest, or an intermediate level too small to shard) solves with no
collective, so on any grid its coarsest GCR is a replay of its own graph,
which every rank replays on the same gathered bits (the JAX package's
replicated coarse levels, its hierarchy.py:223-232).

Tracing (profiling.PROF): from level 2 the setup's phases are rows by the
JAX package's names and depths (_prof: the coarsest dense inverse, the
initial test-vector smoothing, the block inverses, and per bootstrap
iteration the Gram-Schmidt, the test-vector cycles and the P / Galerkin
rebuild), each timed by CUDA events with no synchronization; every host
read of the cycles' counters is a span, every capture counted with the
pools' peak bytes.  At level 4 the cycle's call sites are marked sections
(site: the residual, the restriction, the coarsest solve or the K-cycle
GCR, the interpolation and add, the smoother, by depth), captured into the
programs; a program or graph captured at another level is captured again
(one of a kind, the old one dropped first).  Off, they run as they are.
No phase is inside a captured body.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import Optional

import numpy as np
import torch

from ..geometry import Geometry
from ..operators import fast
from ..operators.stencil import (CoarseStencilSoA, WilsonStencilSoA, dense_inverse,
                                 dense_schur_inverse, dense_schur_solve, dense_solve,
                                 schur_even_indices, shift_stencil)
from ..operators.wilson import WilsonOperator
from ..parallel import comm
from ..parallel.mesh import check_blocks, gather_field, local_lattice, shard_field
from ..profiling import PROF, site, span
from ..smoothers.sap import (SchwarzPreconditioner, build_block_inverse, sap_smooth,
                             sap_smooth_from)
from ..solvers.cuda_graph import CudaGraph
from ..solvers.device_gmres import COUNTER_DTYPE, HostControl, gcr_program
from .coarsest import CoarsestGraph, coarsest_gcr
from .programs import CycleGraph, InnerRestartGraph, SetupCycleGraph, TwoLevelUpdateGraph
from .galerkin import build_coarse_blocks, gather_blocks
from .interpolation import Aggregation, block_qr, build_interpolation, interpolate, restrict

# devices whose GCR solves run as CUDA graphs, and the graph class
GRAPH_DEVICES = ("cuda",)
GRAPH_CAPTURE = CudaGraph
HOST = HostControl()        # the control of the GCRs driven from the host
# the setup's memory estimate (_lane_bytes, _setup_chunk): fields of one
# lane a level holds at once in a cycle (SAP, restriction, GCR temporaries),
# fields of one basis column of a Galerkin build (the basis field, its
# images, a masked copy, the aggregate copy of restrict), and the share of
# the card's free memory the setup's lanes may take
LANE_FIELDS = 32
GALERKIN_FIELDS = 6
SETUP_MEMORY_SHARE = 0.5


@dataclasses.dataclass
class LevelConfig:
    """Per-level parameters (reference ini `d<i> ...` keys)."""

    lattice: tuple
    block: tuple = (2, 2, 2, 2)
    post_smooth_iter: int = 2
    block_iter: int = 4
    num_test_vectors: int = 20
    setup_iter: int = 4
    n_cy: int = 1  # preconditioner cycles


@dataclasses.dataclass
class MGConfig:
    """Solver-wide parameters (reference ini global keys)."""

    levels: list
    kcycle: bool = True
    kcycle_tol: float = 1e-1
    kcycle_length: int = 5
    kcycle_restarts: int = 2
    coarse_tol: float = 5e-2
    coarse_iter: int = 100
    coarse_restart: int = 5
    odd_even: bool = True
    scheme: str = "red_black"
    dtype: torch.dtype = torch.complex64
    seed: int = 42
    # process grid (parallel/mesh.SolverMesh) or None for one rank
    mesh: object = None
    # an intermediate level whose slab would hold fewer sites is replicated
    # instead of sharded (the JAX package's default, mg/hierarchy.py:315)
    min_local_sites: int = 256
    # the accelerator options of the module note (complex64 dtype only for
    # coarse_block_bf16: K4-bf16 / K5-bf16 take complex64 fields)
    coarse_block_bf16: bool = False
    coarsest_direct: bool = False
    smoother_direct: bool = False

    @property
    def num_levels(self):
        return len(self.levels)


@dataclasses.dataclass
class MGLevel:
    depth: int
    geom: Geometry
    cfg: LevelConfig
    stencil: object                      # WilsonStencilSoA | CoarseStencilSoA
    smoother: Optional[SchwarzPreconditioner] = None
    agg: Optional[Aggregation] = None    # to the next level
    P: Optional[torch.Tensor] = None
    test_vectors: Optional[torch.Tensor] = None  # [N, dof, V]
    next: Optional["MGLevel"] = None
    cycle_stencil: Optional[CoarseStencilSoA] = None  # bf16 view (coarse_block_bf16)
    # coarsest_direct: the inverse [1, n, n], or (Schur inverse, even indices)
    dense_inv: Optional[object] = None
    block_inv: Optional[torch.Tensor] = None   # [nblocks, m, m] (smoother_direct)
    # the coarsest GCR's CUDA graphs by (batch, field dtype, block dtype)
    graphs: dict = dataclasses.field(default_factory=dict)

    @property
    def is_coarsest(self):
        return self.next is None

    @property
    def gathers(self) -> bool:
        """True where a sharded level meets a replicated next level."""
        return self.stencil.mesh is not None and self.next.stencil.mesh is None


def _normalize(v, s):
    """Each field of a stack (leading axis) of stencil s's level scaled to
    unit norm (global norms on a sharded level)."""
    flat = v.reshape(v.shape[0], -1)
    if s.mesh is None:
        n = torch.linalg.vector_norm(flat, dim=1)
    else:
        n = torch.sqrt(s.allsum((flat.conj() * flat).real.sum(dim=1)))
    return v / n.reshape(-1, *([1] * (v.dim() - 1)))


def _prof(name: str, depth: int, fn, device):
    """fn() as the tracer's row `name` at `depth` (the JAX package's setup
    phases, its hierarchy.py:166-178; the reference profiles its setup too,
    prof_print src/solver_analysis.c:65), timed by CUDA events on the card;
    fn() itself while PROF is off."""
    if not PROF.on:
        return fn()
    with PROF.region(name, depth, device=device):
        return fn()


def _slab_geom(geom: Geometry, mesh) -> Geometry:
    """The geometry of this rank's slab of a level (geom itself unsharded)."""
    if mesh is None:
        return geom
    return Geometry(lattice=local_lattice(mesh, geom.lattice),
                    block=tuple(geom.block), dof=geom.dof)


def lane_chunk(n: int, lane_bytes: int, device, mesh=None, held: int = 0) -> int:
    """Lanes of one batch: all n, except where SETUP_MEMORY_SHARE of the
    card's free memory (the caching allocator's idle blocks counted free,
    but for the `held` bytes of graph pools, whose idle blocks only their
    graphs reuse) cannot hold n lanes of lane_bytes each.  Under a mesh
    every rank takes the smallest rank's chunk, so that all ranks make the
    same collective calls."""
    dev = torch.device(device)
    chunk = n
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        free += max(0, torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
                    - held)
        chunk = max(1, min(n, int(SETUP_MEMORY_SHARE * free) // max(lane_bytes, 1)))
    if mesh is not None:
        chunk = -int(comm.all_reduce_max(mesh, -chunk))
    return chunk


def lane_chunks(n: int, lane_bytes: int, device, mesh=None):
    """[(start, stop)] of the chunks lane_chunk cuts n lanes into."""
    chunk = lane_chunk(n, lane_bytes, device, mesh)
    return [(c0, min(n, c0 + chunk)) for c0 in range(0, n, chunk)]


def padded_chunk(v, c0: int, chunk: int):
    """Lanes c0 .. c0 + chunk of v, the lanes past its end copies of its
    last lane (a copy iterates as its original, so no loop runs longer and
    no lane's bits depend on it; a zero lane would normalize to NaN)."""
    n = v.shape[0]
    if c0 + chunk <= n:
        return v[c0:c0 + chunk]
    idx = torch.arange(c0, c0 + chunk, device=v.device).clamp(max=n - 1)
    return v.index_select(0, idx)


class Multigrid:
    """The AMG preconditioner: hierarchy + cycles + adaptive setup.  Initial
    test vectors are drawn from a torch.Generator seeded with cfg.seed;
    set_test_vectors injects others (tests give the JAX package and the
    port the same vectors this way).  Under cfg.mesh, op is this rank's
    slab of the operator (parallel/mesh.shard_operator)."""

    def __init__(self, op: WilsonOperator, cfg: MGConfig):
        if cfg.coarse_block_bf16 and cfg.dtype != torch.complex64:
            raise ValueError("coarse block bf16 needs complex64 coarse levels (mixed "
                             "precision 1 or 2): K4-bf16 / K5-bf16 take complex64 fields")
        self.cfg = cfg
        # [coarsest GCR iterations (one per dense apply with coarsest_direct),
        #  coarsest operator applications of the GCR, dense-inverse applies]
        self.stats = {"coarse_iterations": 0.0, "coarse_matvecs": 0.0,
                      "coarsest_inverse_applies": 0.0}
        self.build_times: dict[str, float] = {}     # seconds of each inverse build
        # the device programs (mg/programs.py) by (kind, batch, GCR length, dtype)
        self.programs: dict = {}
        self._defer_dense = False
        # a setup's fixed lane chunks by depth (None outside a setup: _setup_scope)
        self._chunks: Optional[dict] = None
        self.slim = False                           # slim_for_solve ran
        self.fine = None
        self.fine = self._build(op)

    # ------------------------------------------------------------------
    # hierarchy construction
    # ------------------------------------------------------------------

    def _levels(self) -> list:
        out, lvl = [], self.fine
        while lvl is not None:
            out.append(lvl)
            lvl = lvl.next
        return out

    def _level_mesh(self, depth: int, geom: Geometry, prev_mesh):
        """The mesh a level is sharded over, or None where it is replicated:
        the coarsest level, a level below a replicated one, a level the
        mesh does not divide and an intermediate level whose slab would
        hold fewer than min_local_sites sites."""
        cfg = self.cfg
        mesh = cfg.mesh
        if mesh is None or (depth > 0 and (prev_mesh is None
                                           or depth == cfg.num_levels - 1)):
            return None
        if not mesh.divides(geom.lattice):
            if depth == 0:
                raise ValueError(f"mesh {mesh.dims} does not divide the "
                                 f"lattice {geom.lattice}")
            return None
        loc = local_lattice(mesh, geom.lattice)
        if depth > 0 and int(np.prod(loc)) < cfg.min_local_sites:
            return None
        check_blocks(mesh, geom.lattice, geom.block)
        return mesh

    def _build(self, op: WilsonOperator) -> MGLevel:
        cfg = self.cfg
        gen = torch.Generator().manual_seed(int(cfg.seed))
        levels: list[MGLevel] = []
        for d, lc in enumerate(cfg.levels):
            geom = Geometry(lattice=tuple(lc.lattice), block=tuple(lc.block))
            mesh = self._level_mesh(d, geom, levels[-1].stencil.mesh if levels else None)
            if d == 0:
                stencil = WilsonStencilSoA.build(op, _slab_geom(geom, mesh),
                                                 dtype=cfg.dtype, mesh=mesh)
            else:
                prev = levels[-1]
                coarsening = tuple(prev.geom.lattice[mu] // lc.lattice[mu]
                                   for mu in range(4))
                if prev.stencil.mesh is not None:
                    check_blocks(prev.stencil.mesh, prev.geom.lattice,
                                 coarsening, "aggregate")
                prev.agg = Aggregation(
                    fine_lattice=prev.stencil.lattice, coarsening=coarsening,
                    num_vectors=prev.cfg.num_test_vectors,
                    fine_dpc=prev.stencil.field_shape[0] // 2)
                prev.test_vectors = self._initial_test_vectors(prev, gen)
                prev.P, stencil = self._resetup(prev, geom, mesh)
            level = MGLevel(depth=d, geom=geom, cfg=lc, stencil=stencil)
            if d < cfg.num_levels - 1:
                # reference: block odd-even solver at depth 0 only
                level.smoother = SchwarzPreconditioner(
                    stencil, block_iter=lc.block_iter, cycles=lc.post_smooth_iter,
                    odd_even=(d == 0 and cfg.odd_even), scheme=cfg.scheme)
            if levels:
                levels[-1].next = level
            levels.append(level)
        return levels[0]

    def _initial_test_vectors(self, level: MGLevel, gen) -> torch.Tensor:
        """Random vectors progressively smoothed with 1, 2, 3 SAP cycles
        (reference interpolation_PRECISION_define,
        src/setup_generic.c:215-246), all test vectors as one batch, in
        chunks of lanes that fit the card (lane_chunk)."""
        s = level.stencil
        shape = (level.cfg.num_test_vectors, s.field_shape[0], level.geom.num_sites)
        rdtype = torch.empty((), dtype=self.cfg.dtype).real.dtype
        tv = torch.complex(torch.randn(shape, generator=gen, dtype=rdtype),
                           torch.randn(shape, generator=gen, dtype=rdtype))
        tv = s.slab(tv)
        sm = level.smoother
        lane = LANE_FIELDS * math.prod(s.field_shape) * s.dtype.itemsize

        def smooth():
            out = []
            for c0, c1 in lane_chunks(shape[0], lane, s.device, s.mesh):
                v = tv[c0:c1].to(device=s.device, dtype=s.dtype)
                for ncy in (1, 2, 3):
                    v = sap_smooth(s, sm.colors, v, ncy, sm.block_iter, sm.odd_even)
                out.append(v)
            return _normalize(torch.cat(out), s)

        return _prof("setup: initial tv smoothing", level.depth, smooth, s.device)

    def _resetup(self, level: MGLevel, next_geom: Geometry, next_mesh, into=None):
        """One coarsening rebuild: P from the level's test vectors, then the
        Galerkin coarse stencil (on next_mesh, or gathered whole onto every
        rank when the next level is replicated).  into: the (P, stencil,
        bf16 view or None) of the last rebuild, whose storage the new ones
        are written into and which are returned (re_setup in a setup whose
        sweeps are device programs)."""
        s = level.stencil
        mesh = s.mesh
        gathers = mesh is not None and next_mesh is None
        P = build_interpolation(level.agg, level.test_vectors,
                                out=None if into is None else into[0])
        column = GALERKIN_FIELDS * math.prod(s.field_shape) * s.dtype.itemsize
        Pk = build_coarse_blocks(s, level.agg, P, chunk=lane_chunk(
            2 * level.agg.num_vectors, column, s.device, mesh, held=self.graph_pool_bytes()),
            out=None if into is None or gathers else into[1].Pk)
        if gathers:
            Pk = gather_blocks(mesh, Pk, level.agg.coarse_lattice)
        if into is not None:
            if gathers:         # the replicated level's blocks, whole, into its storage
                into[1].Pk.copy_(Pk)
            into[1].refresh(into[2])
            return into[:2]
        return P, CoarseStencilSoA.from_blocks(Pk.to(self.cfg.dtype),
                                               _slab_geom(next_geom, next_mesh),
                                               mesh=next_mesh)

    def re_setup(self, level: MGLevel, depth_only: bool = False):
        """Rebuild P and the Galerkin operators from `level` downward
        (re_setup_PRECISION); depth_only rebuilds this one coarsening only
        (the interpolation-1 setup's rebuild, src/setup_generic.c:373-390).
        The stale P, stencil, bf16 view and inverses are dropped before
        their successors are built (the views and inverses are rebuilt at
        first use).  Inside a setup whose sweeps run as device programs
        (_setup_scope, uses_graphs) P, the stencil's blocks and its bf16
        view are rewritten in place instead, so that the programs, which
        read them, serve the whole setup; only the inverses are dropped."""
        self.require_setup("re_setup")
        in_place = self._chunks is not None and self.uses_graphs(level.test_vectors, level)
        if not in_place:
            self.drop_graphs()
        lvl = level
        while lvl is not None and not lvl.is_coarsest:
            nxt = lvl.next
            mesh = nxt.stencil.mesh
            nxt.dense_inv = nxt.block_inv = None
            if in_place:
                self._resetup(lvl, nxt.geom, mesh, into=(lvl.P, nxt.stencil, nxt.cycle_stencil))
                if depth_only:
                    break
                lvl = nxt
                continue
            lvl.P = nxt.stencil = nxt.cycle_stencil = None
            if nxt.smoother is not None:
                nxt.smoother.replace_stencil(None)
            lvl.P, nxt.stencil = self._resetup(lvl, nxt.geom, mesh)
            if nxt.smoother is not None:
                nxt.smoother.replace_stencil(nxt.stencil)
            if depth_only:
                break
            lvl = nxt

    def shift_update(self, delta: float, op: WilsonOperator):
        """Shift the mass of every level by delta without a new setup (the
        JAX package's hierarchy.py:1052-1072, the reference's shift_update):
        the fine stencil is rebuilt from op, the caller's complex128
        operator (slab) already shifted by delta, every coarse stencil gets
        +delta I on its self blocks, and the bf16 views and stored inverses
        are dropped, to be rebuilt at first use.  No bootstrap and no
        Galerkin build runs."""
        self.require_setup("shift_update")
        self.drop_graphs()
        for lvl in self._levels():
            lvl.stencil = shift_stencil(lvl.stencil, delta, op)
            if lvl.smoother is not None:
                lvl.smoother.replace_stencil(lvl.stencil)
            lvl.cycle_stencil = lvl.dense_inv = lvl.block_inv = None

    def require_setup(self, what: str):
        """Refuse a call that needs what slim_for_solve dropped."""
        if self.slim:
            raise ValueError(f"{what}: the hierarchy was slimmed for solves "
                             "(slim_for_solve dropped its test vectors and full-precision "
                             "coarse stencils); call setup() first")

    def slim_for_solve(self):
        """Drop what a set-up hierarchy needs only for more setup (the JAX
        package's Multigrid.slim_for_solve, hierarchy.py:1020-1045): the
        test vectors of every level and, where coarse_block_bf16 keeps a
        bf16 view of a coarse stencil, the full-precision stencil, which the
        view replaces (it is all the cycles read).  The port's Galerkin
        builds read the stencils themselves, so there is no Galerkin
        operator apart from them to drop.  Missing inverses are built first,
        from the full-precision stencils, so the solves that follow give the
        bits they would have given.  Afterwards re_setup, the setups,
        shift_update and the test-vector calls raise (require_setup)."""
        if self.slim:
            return
        self.drop_graphs()
        self._ensure_inverses()
        for lvl in self._levels():
            lvl.test_vectors = None
            view = self._cycle_view(lvl)
            if view is not lvl.stencil:
                lvl.stencil = view
                if lvl.smoother is not None:
                    lvl.smoother.replace_stencil(view)
        self.slim = True

    def get_test_vectors(self) -> np.ndarray:
        """The fine level's test vectors as numpy [N, T, Z, Y, X, 4, 3]
        (gathered whole onto every rank under a mesh; checkpointing)."""
        self.require_setup("write_test_vectors")
        lvl = self.fine
        tv = lvl.test_vectors
        if lvl.stencil.mesh is not None:
            tv = gather_field(lvl.stencil.mesh, tv, lvl.stencil.lattice)
        return fast.spinor_from_soa(tv, lvl.geom.lattice).cpu().numpy()

    def set_test_vectors(self, tvs, depth: int = 0):
        """Install test vectors [N, T, Z, Y, X, *dof] at `depth` and rebuild
        the hierarchy from there (reference read_tv_from_file_PRECISION,
        src/setup_generic.c:131-162)."""
        self.require_setup("set_test_vectors")
        level = self._levels()[depth]
        s = level.stencil
        n = level.cfg.num_test_vectors
        tv = torch.as_tensor(np.asarray(tvs)).reshape(n, *level.geom.lattice, -1)
        level.test_vectors = s.slab(s.from_logical(tv)).to(device=s.device,
                                                           dtype=s.dtype)
        self.re_setup(level)

    # ------------------------------------------------------------------
    # cycles
    # ------------------------------------------------------------------

    def _coarsest_solve(self, level: MGLevel, b, ctl=None):
        """The coarsest solve of every lane of b [B, d, V]: one product with
        the dense inverse (coarsest_direct), else odd-even Schur GCR
        (coarse_solve_odd_even_PRECISION): inside a device program (ctl)
        the program's own GCR, else one replay of the level's graph on a
        card with one rank, else the host loop (module note).  Returns (x,
        counters [B, 3]) with counters = [iterations, GCR operator
        applications, dense applies] as in the JAX package
        (hierarchy.py:659-699): a dense apply counts as one iteration and
        as no GCR application."""
        cfg = self.cfg
        s = self._cycle_view(level)
        args = (cfg.coarse_iter, cfg.coarse_tol, cfg.coarse_restart, self._odd_even(level))
        if level.dense_inv is not None:
            # the Schur inverse is built exactly where odd-even applies
            x = (dense_schur_solve(s, *level.dense_inv, b) if self._odd_even(level)
                 else dense_solve(level.dense_inv, b))
            one = torch.zeros((b.shape[0], 3), dtype=COUNTER_DTYPE, device=b.device)
            one[:, 0::2] = 1.0
            return x, one
        if ctl is not None:
            return coarsest_gcr(s, b, *args, gcr=functools.partial(gcr_program, ctl))
        if self.uses_graphs(b, level):
            return self._coarsest_graph(level, s, b.shape[0])(b)
        return coarsest_gcr(s, b, *args)

    def uses_graphs(self, b, level: Optional[MGLevel] = None) -> bool:
        """Whether the GCR solves of lanes b from `level` (the fine level by
        default) down run as CUDA graphs: on a card (GRAPH_DEVICES), where
        the level is replicated (no mesh: one rank, or a replicated level
        of a grid, whose solves have no collective) or sharded over a
        transport whose collectives a capture holds
        (comm.CAPTURED_TRANSPORTS: NCCL).  The levels below a sharded level
        share its mesh or are replicated, so its rule holds for them."""
        mesh = (level or self.fine).stencil.mesh
        return b.device.type in GRAPH_DEVICES and (
            mesh is None or mesh.comm.transport in comm.CAPTURED_TRANSPORTS)

    def _coarsest_graph(self, level: MGLevel, s, B: int) -> CoarsestGraph:
        """The level's graph of the coarsest GCR for B lanes on stencil s
        (its cycle view), captured at first use; a level whose stencil is
        not the one its graphs were captured from, or whose graphs hold
        other marks than the tracer's level asks for, drops them first, and
        a setup keeps one graph at a time."""
        cfg = self.cfg
        key = (B, s.dtype, s.Pk.dtype)
        g = level.graphs.get(key)
        if any(h.stencil is not s or h.marked != PROF.marks for h in level.graphs.values()):
            self.drop_graphs([level])
            g = None
        if g is None:
            if self._defer_dense:
                self.drop_graphs([level])
            g = level.graphs[key] = CoarsestGraph(
                s, B, cfg.coarse_iter, cfg.coarse_tol, cfg.coarse_restart,
                self._odd_even(level), capture=GRAPH_CAPTURE, depth=level.depth)
            self._captured()
        return g

    def _captured(self):
        """After a capture: the tracer's peak of the pools held."""
        if PROF.on:
            c = PROF.counters
            c["peak pool bytes"] = max(c["peak pool bytes"], self.graph_pool_bytes())

    def _program(self, cls, B: int, dtype, m: int = 0, op=None):
        """The device program cls (mg/programs.py) for B lanes, captured at
        first use; one of a kind is kept (of a kind and depth m for the
        setup's programs, cls.per_depth; another batch, GCR length, dtype,
        fine operator op, or marks other than the tracer's level asks for
        replace it), and every program is dropped first where a level's
        stencil, interpolation, inverse or smoother it read was replaced
        (holds, by identity)."""
        holds = self._program_holds()
        if any(len(g.holds) != len(holds) or any(a is not b for a, b in zip(g.holds, holds))
               for g in self.programs.values()):
            self.drop_programs()
        key = (cls.__name__, B, m, dtype)
        g = self.programs.get(key)
        if g is None or g.op is not op or g.marked != PROF.marks:
            # one program of a kind: its pool holds the bases (GBs at 32^4)
            for k in [k for k in self.programs
                      if k[0] == key[0] and (not cls.per_depth or k[2] == m)]:
                self.programs.pop(k).close()
            g = self.programs[key] = cls(self, B, dtype, m=m, op=op, holds=holds,
                                         capture=GRAPH_CAPTURE)
            self._captured()
        return g

    def _program_holds(self) -> tuple:
        """What a device program reads besides its inputs and its fine
        operator: every level's cycle stencil, interpolation, inverses and
        smoother (the bf16 views made here, before any capture)."""
        return tuple(obj for lvl in self._levels() for obj in (
            self._cycle_view(lvl), lvl.P, lvl.dense_inv, lvl.block_inv, lvl.smoother))

    def drop_programs(self):
        """Free the device programs (inner restarts and cycles)."""
        for g in self.programs.values():
            g.close()
        self.programs = {}

    def drop_graphs(self, levels=None):
        """Free the coarsest-GCR graphs of `levels`, or (default) every
        graph: those of all levels and the device programs."""
        if levels is None:
            self.drop_programs()
        for lvl in self._levels() if levels is None else levels:
            for g in lvl.graphs.values():
                g.close()
            lvl.graphs = {}

    def graph_pool_bytes(self) -> int:
        """Device memory the captures of the graphs held now reserved."""
        graphs = [*self.programs.values(), *(g for lvl in self._levels()
                                             for g in lvl.graphs.values())]
        return sum(g.graph.pool_bytes for g in graphs)

    def _odd_even(self, level: MGLevel) -> bool:
        """Whether the coarsest level is solved through its Schur complement."""
        return self.cfg.odd_even and all(e % 2 == 0 for e in level.geom.lattice)

    def _cycle_view(self, level: MGLevel):
        """The stencil the cycles apply at this level: the level's stencil,
        or with coarse_block_bf16 (depth > 0, no y/x split: module note) its
        bf16 copy, made at first use after each re_setup.  A coarsest level
        solved by the Schur GCR (odd-even, no coarsest_direct) and not
        sharded gets the view's parity-split blocks (K4-schur) at the same
        time; re_setup in place rewrites them (CoarseStencilSoA.refresh)."""
        mesh = self.cfg.mesh
        if (not self.cfg.coarse_block_bf16 or level.depth == 0
                or (mesh is not None and mesh.splits_yx)):
            view = level.stencil
        else:
            if level.cycle_stencil is None:
                level.cycle_stencil = level.stencil.compress()
            view = level.cycle_stencil
        if (view.mesh is None and level.is_coarsest and level.depth > 0 and view.E is None
                and self._odd_even(level) and not self.cfg.coarsest_direct):
            view.split()
        return view

    def _timed(self, name: str, fn):
        """fn() timed on the host clock around a device synchronization."""
        sync = (torch.cuda.synchronize if self.fine.stencil.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        self.build_times[name] = time.perf_counter() - t0
        return out

    def _ensure_inverses(self):
        """Build the missing inverses the options ask for (never during
        bootstrap_setup): the coarsest level's dense inverse from its
        full-precision stencil (the Schur-complement inverse where odd-even
        applies) and the block inverses of every coarse level with a
        smoother, each stored in bf16 with coarse_block_bf16."""
        cfg = self.cfg
        if self._defer_dense:
            return
        bf16 = cfg.coarse_block_bf16

        def build(region, name, lvl, fn):
            """fn() as the profiler's region and timed into build_times."""
            return _prof(region, lvl.depth, lambda: self._timed(f"{name} depth {lvl.depth}", fn),
                         lvl.stencil.device)

        for lvl in self._levels()[1:]:
            if cfg.coarsest_direct and lvl.is_coarsest and lvl.dense_inv is None:
                s = lvl.stencil
                if self._odd_even(lvl):
                    idx = schur_even_indices(s)
                    lvl.dense_inv = (build("setup: coarsest dense inverse",
                                           "coarsest Schur inverse", lvl,
                                           lambda: dense_schur_inverse(s, idx, bf16=bf16)), idx)
                else:
                    lvl.dense_inv = build("setup: coarsest dense inverse",
                                          "coarsest dense inverse", lvl,
                                          lambda: dense_inverse(s, bf16=bf16))
            if cfg.smoother_direct and lvl.smoother is not None and lvl.block_inv is None:
                lvl.block_inv = build("setup: block inverses", "block inverses", lvl,
                                      lambda: build_block_inverse(lvl.stencil, bf16=bf16))

    def _restrict(self, level: MGLevel, r):
        """P^H r, gathered whole onto every rank for a replicated next level."""
        b_c = restrict(level.agg, level.P, r)
        if level.gathers:
            b_c = gather_field(level.stencil.mesh, b_c, level.agg.coarse_lattice)
        return b_c

    def _interpolate(self, level: MGLevel, x_c):
        """P x_c, from this rank's slab of a replicated next level's x_c."""
        if level.gathers:
            x_c = shard_field(level.stencil.mesh, x_c, level.next.geom.lattice)
        return interpolate(level.agg, level.P, x_c)

    def _cycle(self, depth: int, eta, kcycle_tol: float, collect=None, ctl=None):
        """One preconditioning cycle at `depth` (vcycle_PRECISION) of every
        lane of eta [B, dof, V]; returns (x, counters [B, 3]).  `collect`
        receives the next level's solution of the top-level coarse
        correction (the bootstrap's test-vector update), [B, ...].  ctl:
        the control of the device program the cycle is part of
        (solvers/cuda_graph.py), whose loops then run its K-cycle GCR and
        its coarsest GCR; None: driven from the host, the coarsest GCR a
        graph of its own on a card (_coarsest_solve)."""
        cfg = self.cfg
        levels = self._levels()
        level, nxt = levels[depth], levels[depth + 1]
        s = self._cycle_view(level)
        counters = torch.zeros((eta.shape[0], 3), dtype=COUNTER_DTYPE, device=eta.device)
        x = None
        for _ in range(level.cfg.n_cy):
            if x is None:
                r = eta
            else:
                with site("residual", depth):
                    r = eta - s.full_op(x)
            with site("restrict", depth):
                b_c = self._restrict(level, r)
            if nxt.is_coarsest:
                with site("coarsest", depth + 1):
                    x_c, it = self._coarsest_solve(nxt, b_c, ctl)
            elif cfg.kcycle:
                def kprec(v, _d=depth + 1):
                    return self._cycle(_d, v, kcycle_tol, ctl=ctl)

                ns = self._cycle_view(nxt)
                with site("kcycle", depth + 1):
                    x_c, _, _, it = gcr_program(
                        ctl or HOST, ns.full_op, b_c, cfg.kcycle_length, kcycle_tol,
                        n_restarts=cfg.kcycle_restarts, prec=kprec, allsum=ns.allsum,
                        n_aux=3)
            else:
                x_c, it = self._cycle(depth + 1, b_c, kcycle_tol, collect=collect, ctl=ctl)
            counters = counters + it
            if collect is not None:
                collect[depth + 1] = x_c
            with site("interpolate", depth):
                corr = self._interpolate(level, x_c)
                x = corr if x is None else x + corr
            with site("smoother", depth):
                x = sap_smooth_from(s, level.smoother.colors, eta, x,
                                    cycles=level.cfg.post_smooth_iter,
                                    block_iter=level.cfg.block_iter,
                                    odd_even=(depth == 0 and cfg.odd_even),
                                    block_inv=level.block_inv, blocks=level.smoother.blocks)
        return x, counters

    def _kcycle_tol(self, depth: int, tol: float) -> float:
        """No K-cycle runs below the last two levels (its tolerance is then
        unused; kept 0 as in the JAX package)."""
        return 0.0 if self.cfg.num_levels - depth <= 2 else float(tol)

    def __call__(self, eta):
        """Depth-0 preconditioner application M(eta) of one field [dof, V]
        or of a batch [B, dof, V] (batch 1 of the same cycle for one): one
        replay of the cycle's graph on a card with one rank (the JAX
        package's one dispatch, hierarchy.py:792-804)."""
        self._ensure_inverses()
        s = self.fine.stencil
        lanes = eta.reshape(-1, *eta.shape[-2:]).to(s.dtype)
        if self.uses_graphs(lanes):
            out = self._program(CycleGraph, lanes.shape[0], lanes.dtype)(eta=lanes)
            x, counters = out["x"], out["counters"]
        else:
            x, counters = self._cycle(0, lanes, self._kcycle_tol(0, self.cfg.kcycle_tol))
        self._count(counters)
        return x.reshape(eta.shape)

    def _count(self, counters):
        """Add the [B, 3] counters of a cycle or an inner restart to stats
        (one read of the device)."""
        with span("read counters", kind="read"):
            sums = counters.sum(dim=0).tolist()
        for key, c in zip(("coarse_iterations", "coarse_matvecs",
                           "coarsest_inverse_applies"), sums):
            self.stats[key] += c

    def inner_program(self, ctl, r, rel_tol, m: int, active=None, op=None, wrap=None):
        """The inner restart as a program of ctl (the JAX package's
        _inner_restart_impl, hierarchy.py:806-827): m iterations of
        flexible GCR over op (the fine stencil's full_op by default) on
        the lanes r [B, 12, V] in the fine dtype, preconditioned by the
        cycle (wrap(prec), if given, in its place), each lane stopped once
        its residual falls below its rel_tol (a float or a [B] tensor),
        lanes off in `active` [B] frozen.  Returns (z, iterations [B],
        counters [B, 3])."""
        s = self.fine.stencil
        ktol = self._kcycle_tol(0, self.cfg.kcycle_tol)
        # driven from the host (HOST), the cycle is too: its coarsest GCR is
        # then a replay of its own graph where the level allows one
        # (_coarsest_solve), as on a gloo grid's replicated level
        cycle_ctl = None if ctl is HOST else ctl

        def prec(w):
            return self._cycle(0, w, ktol, ctl=cycle_ctl)

        z, iters, _, counters = gcr_program(
            ctl, op or s.full_op, r, m, rel_tol, n_restarts=1,
            prec=prec if wrap is None else wrap(prec), allsum=s.allsum, active=active, n_aux=3,
            site="fine GCR")
        return z, iters, counters

    def inner_restart(self, r, rel_tol, m: int, active=None, wrap=None, op=None):
        """One inner restart of the mixed-precision outer loop for every lane
        of r [B, 12, V] (inner_program): one replay of its graph on a card
        with one rank (InnerRestartGraph), else driven from the host.  op
        is the fine operator of the GCR (the fine level's by default);
        wrap(fn), if given, times fn (the profiler): driven from the host
        the GCR calls wrap(prec) in place of the cycle prec; a replay is
        the tracer's row of the inner restart (InnerRestartGraph.row).
        Returns (z, iterations [B]), both on the device."""
        self._ensure_inverses()
        r = r.to(self.fine.stencil.dtype)
        if self.uses_graphs(r):
            # the operator's stencil: op is a bound method, made anew at every access
            g = self._program(InnerRestartGraph, r.shape[0], r.dtype, m=m,
                              op=getattr(op, "__self__", op))

            out = g(r=r, rel_tol=rel_tol, active=True if active is None else active)
            z, iters, counters = out["z"], out["iters"], out["counters"]
        else:
            z, iters, counters = self.inner_program(HOST, r, rel_tol, m, active, op, wrap)
        self._count(counters)
        return z, iters

    # ------------------------------------------------------------------
    # adaptive (bootstrap) setup
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def _setup_scope(self):
        """A setup's sweeps: the inverses deferred (the setup cycles run the
        GCR coarsest solve and the MinRes smoother; the inverses are built
        for the final hierarchy only), every level's lane chunk fixed at the
        start, before any program holds memory (_setup_chunk), re_setup in
        place where the sweeps run as device programs, and every graph
        dropped at the start and at the end."""
        self.drop_graphs()
        self._defer_dense = True
        self._chunks = {}
        for lvl in self._levels()[:-1]:
            self._setup_chunk(lvl, lvl.cfg.num_test_vectors)
        try:
            yield
        finally:
            self._defer_dense = False
            self._chunks = None
            self.drop_graphs()

    def bootstrap_setup(self, setup_iter: Optional[int] = None):
        """inv_iter_inv_fcycle_PRECISION: refine test vectors with the
        current hierarchy, rebuilding P / D_c each iteration."""
        self.require_setup("bootstrap_setup")
        it = setup_iter if setup_iter is not None else self.cfg.levels[0].setup_iter
        if self.cfg.num_levels < 2 or it <= 0:
            return
        with self._setup_scope():
            self._inv_iter_fcycle(self.fine, it)

    def twolevel_extension_setup(self, setup_iter: Optional[int] = None):
        """Interpolation 1 (inv_iter_2lvl_extension_setup_PRECISION,
        src/setup_generic.c:324-416; the JAX package's hierarchy.py:878-941):
        every setup iteration gives each test vector one plain two-level
        update (an unpreconditioned coarse GCR of P^H tv on the next level,
        the odd-even Schur GCR where that level is the coarsest, then
        interpolation and post-smoothing towards tv) and rebuilds that one
        coarsening; then the next level does the same."""
        self.require_setup("twolevel_extension_setup")
        it = setup_iter if setup_iter is not None else self.cfg.levels[0].setup_iter
        if self.cfg.num_levels < 2 or it <= 0:
            return
        with self._setup_scope():
            self._inv_iter_2lvl(self.fine, it)

    def _inv_iter_2lvl(self, level: MGLevel, setup_iter: int):
        for _ in range(setup_iter):
            level.test_vectors = self._twolevel_update(level, level.test_vectors)
            self.re_setup(level, depth_only=True)
        if not level.next.is_coarsest:
            self._inv_iter_2lvl(level.next, setup_iter)

    def _twolevel_update(self, level: MGLevel, tvs):
        """The interpolation-1 update of all test vectors of a level as one
        batch (the JAX package vmaps _twolevel_update_one; the updates of
        one iteration are independent), in chunks as _setup_cycles_batch:
        each chunk one replay of TwoLevelUpdateGraph on a card with one
        rank, else driven from the host."""
        n = tvs.shape[0]
        chunk = self._setup_chunk(level, n)
        out = []
        for c0 in range(0, n, chunk):
            lanes = padded_chunk(tvs, c0, chunk)
            if self.uses_graphs(lanes, level):
                v = self._program(TwoLevelUpdateGraph, chunk, lanes.dtype, m=level.depth)(lanes)
            else:
                v = self._twolevel_lanes(level, lanes)
            out.append(v[:n - c0])
        return torch.cat(out)

    def _twolevel_lanes(self, level: MGLevel, tv, ctl=None):
        """The interpolation-1 update of the lanes tv [B, dof, V] of a
        level: the coarse solve of P^H tv on the next level (the odd-even
        Schur GCR where it is the coarsest, else the reference's gmres with
        prec = _NOTHING), interpolation, post-smoothing towards tv and
        normalization; its GCR under the control ctl of the program it is
        part of (TwoLevelUpdateGraph), or driven from the host."""
        cfg = self.cfg
        nxt = level.next
        s = self._cycle_view(level)
        b_c = self._restrict(level, tv)
        if nxt.is_coarsest:
            x_c, _ = self._coarsest_solve(nxt, b_c, ctl)
        else:
            ns = self._cycle_view(nxt)
            x_c, _, _, _ = gcr_program(ctl or HOST, ns.full_op, b_c, cfg.coarse_iter,
                                       cfg.coarse_tol, n_restarts=cfg.coarse_restart,
                                       allsum=ns.allsum)
        buf = sap_smooth_from(s, level.smoother.colors, tv, self._interpolate(level, x_c),
                              cycles=level.cfg.post_smooth_iter,
                              block_iter=level.cfg.block_iter,
                              odd_even=(level.depth == 0 and cfg.odd_even),
                              block_inv=level.block_inv, blocks=level.smoother.blocks)
        return _normalize(buf, level.stencil)

    def _setup_cycles_batch(self, level: MGLevel, tvs):
        """The bootstrap cycles of all test vectors of a level as one batch
        (the JAX package's _setup_cycles_batch, hierarchy.py:946-987; kcycle
        tolerance = coarse_tol during setup, src/setup_generic.c:448): the
        reference's i-loop over test vectors has no dependency between
        vectors inside one bootstrap iteration.  The lanes run in chunks
        that fit the device's free memory (one chunk unless the level is
        large; _setup_chunk), the last one padded (padded_chunk), each
        chunk one replay of SetupCycleGraph on a card with one rank, else
        driven from the host.  Returns (xs, {depth: collected [N, ...]})."""
        n = tvs.shape[0]
        chunk = self._setup_chunk(level, n)
        xs, coll = [], {}
        for c0 in range(0, n, chunk):
            lanes = padded_chunk(tvs, c0, chunk)
            if self.uses_graphs(lanes, level):
                x, collect = self._program(SetupCycleGraph, chunk, lanes.dtype,
                                           m=level.depth)(lanes)
            else:
                collect = {}
                x, _ = self._cycle(level.depth, lanes,
                                   self._kcycle_tol(level.depth, self.cfg.coarse_tol),
                                   collect=collect)
            xs.append(x[:n - c0])
            for dep, xc in collect.items():
                coll.setdefault(dep, []).append(xc[:n - c0])
        return torch.cat(xs), {d: torch.cat(v) for d, v in coll.items()}

    def _lane_bytes(self, level: MGLevel) -> int:
        """An estimate of the device bytes one lane of a setup cycle at
        `level` holds at its peak: LANE_FIELDS fields of every level from
        `level` down, plus the GCR bases (2 m fields) of the levels below."""
        cfg = self.cfg
        total = 0
        for lvl in self._levels()[level.depth:]:
            fields = LANE_FIELDS
            if lvl is not level:
                fields += 2 * (cfg.coarse_iter if lvl.is_coarsest else cfg.kcycle_length)
            field = math.prod(lvl.stencil.field_shape) * lvl.stencil.dtype.itemsize
            total += fields * field
        return total

    def program_bytes(self, B: int, m: int) -> int:
        """An estimate of the pool of a device program of B lanes with a fine
        GCR of length m: a setup cycle's lane at depth 0 (_lane_bytes) and
        the fine bases."""
        s = self.fine.stencil
        field = math.prod(s.field_shape) * s.dtype.itemsize
        return B * (self._lane_bytes(self.fine) + 2 * m * field)

    def _setup_chunk(self, level: MGLevel, n: int) -> int:
        """Lanes of one setup batch of n at `level`, fixed for a setup at its
        start (_setup_scope): the programs are captured at that batch, and
        the host loops take it too, so both run every kernel at the same
        batch.  At most lane_chunk's, in the fewest chunks, or in one chunk
        more where that pads fewer lanes (a padded lane costs a real one's
        work: 28 lanes in 7 chunks of 4, not 6 of 5)."""
        chunks = {} if self._chunks is None else self._chunks
        if level.depth not in chunks:
            most = lane_chunk(n, self._lane_bytes(level), level.stencil.device, self.cfg.mesh)
            fewest = -(-n // most)
            k = min((fewest, min(n, fewest + 1)), key=lambda k: k * -(-n // k))
            chunks[level.depth] = -(-n // k)
        return chunks[level.depth]

    def _inv_iter_fcycle(self, level: MGLevel, setup_iter: int):
        dev = level.stencil.device
        for j in range(setup_iter):
            tvs = level.test_vectors
            n = tvs.shape[0]
            q = _prof("setup: gram schmidt", level.depth,
                      lambda: block_qr(tvs.reshape(n, -1).transpose(0, 1),
                                       level.stencil.allsum).transpose(0, 1).reshape(tvs.shape),
                      dev)
            xs, collect = _prof("setup: tv cycles (F-cycle)", level.depth,
                                lambda: self._setup_cycles_batch(level, q), dev)
            level.test_vectors = _normalize(xs, level.stencil)
            # test_vector_PRECISION_update: coarse solutions of the cycles
            lvl = level.next
            while lvl is not None and not lvl.is_coarsest:
                if lvl.depth in collect and lvl.test_vectors is not None:
                    k = min(n, lvl.test_vectors.shape[0])
                    lvl.test_vectors[:k] = _normalize(collect[lvl.depth][:k],
                                                      lvl.stencil)
                lvl = lvl.next
            _prof("setup: P/Galerkin rebuild", level.depth, lambda: self.re_setup(level), dev)
            if level.depth == 0 and not level.next.is_coarsest:
                sub = max(1, round((j + 1) * level.next.cfg.setup_iter / setup_iter))
                self._inv_iter_fcycle(level.next, sub)
        if level.depth > 0 and not level.next.is_coarsest:
            sub = max(1, round(level.next.cfg.setup_iter * setup_iter
                               / max(1, level.cfg.setup_iter)))
            self._inv_iter_fcycle(level.next, sub)
