"""Library API, mirroring the reference C API (dd_alpha_amg.h:42-84) and the
JAX package's api.Solver: set_conf / setup / update_setup / solve /
apply_preconditioner / shift_update.

    params = config.parse_ini("sample.ini")
    solver = api.Solver(params, device="cuda")
    plaq = solver.set_conf(U)            # U [4,T,Z,Y,X,3,3] numpy, raw links
    solver.setup()                       # preconditioner (hierarchy + setup)
    x, info = solver.solve(rhs, tol=1e-10, x0=None)
    xs, infos = solver.solve_multi(rhs_batch)   # [B, T, Z, Y, X, 4, 3]
    solver.shift_update(m0 + 0.01)       # next solves at another mass
    solver.update_setup(1)               # one more setup iteration

Methods (the reference's `method`): -1 CGN; 0 GMRES; 1, 2, 3 FGMRES with
additive, red-black or sixteen-colour SAP, the smoother of an adaptive
multigrid hierarchy when number of levels > 1 and interpolation > 0 (1 the
two-level extension setup, 2 the bootstrap F-cycle setup, 4 test vectors
read from `tv io file name`), else the whole preconditioner; 4 FGMRES with
the odd-even Schur GMRES preconditioner; 5 FGMRES with a BiCGstab
preconditioner (tol 1e-1, 50 iterations).  Preconditioners run in the
inner precision: complex128 with mixed precision 0, complex64 with 1 or 2.

The multigrid methods run the port's outer loop (_solve_mp): the true
residual in complex128 once per restart, each restart's inner solve a
flexible GCR preconditioned by the multigrid cycle, over a batch of
right-hand sides (solve_multi; solve is batch 1), each lane with its own
tolerance and stop.  The other methods run the host-driven Krylov solvers
of solvers/ (one right-hand side at a time): CGN on D and D^dagger in
complex128, FGMRES in complex128, or with mixed precision 2 FGMRES with a
complex128 outer and complex64 inner loop, as the JAX package's CPU path.

The JAX package's accelerator options (`coarse block bf16`, `coarsest
direct`, `smoother direct`; mg/hierarchy.py describes them): bf16 coarse
blocks (complex64 inner solve only), a dense inverse on the coarsest level
and direct Schwarz block solves on the coarse levels.  An ini key decides
where it is set (an option that is on builds its inverse at any size);
where it is not, accelerator_options applies the JAX package's rule for an
accelerator that is not a TPU (its api.py:211-260) on a CUDA card: bf16
blocks on (not with mixed precision 0, whose complex128 coarse levels K4-
bf16 cannot take), the coarsest dense inverse while the coarsest problem
has at most 16,384 unknowns with the Schur form (8,192 without), direct
block solves off (the JAX rule turns them on on a TPU only); on the CPU all
three stay off.  SolveInfo.options says what was chosen and why.

The outer loop of a complex64 inner solve asks each restart for the
reduction that remains, but no more than a clip that adapts to the problem
(adapt_clip: 1e-5, raised towards the measured per-sweep floor), and caps
the inner GCR length by the memory of its two bases (inner_restart_cap);
both are reported in SolveInfo.  slim_for_solve drops what only the setup
needs once the setup is done.

Time boundaries (`bc`, else from `antiperiodic boundary conditions`): 2
anti-periodic, 1 periodic, 0 open (Dirichlet: the clover from the whole
field, the hopping time links zeroed at global t in {0, T-2, T-1}, and the
field's U_T on the last slice must be zero; reference
dd_alpha_amg_set_conf, src/dd_alpha_amg.c:195-237).

With a mesh (parallel/mesh.SolverMesh, one process per rank) every method
is domain-decomposed over a process grid that may split any of the four
axes: every rank computes the plaquette and the complex128 clover on the
global field and keeps its slab, solve scatters the right-hand side, the
outer loop (the multigrid methods' and the host Krylov solvers') runs on
slabs with global inner products, and the solution is gathered so that
solve returns the same global array on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from . import io as dio
from .config import SolverParams, make_rhs
from .gauge import average_plaquette
from .geometry import Geometry
from .mg.hierarchy import LevelConfig, MGConfig, Multigrid
from .operators import fast
from .operators.oddeven import OddEvenPreconditioner
from .operators.stencil import WilsonStencilSoA, shift_stencil
from .operators.wilson import WilsonOperator, shift_diagonal
from .parallel import comm
from .parallel.mesh import (check_blocks, gather_field, local_lattice, replicate,
                            shard_operator)
from .profiling import FLOPS_FINE_FULL, PROF, site, solve_memory_mb, span
from .smoothers import SchwarzPreconditioner
from .solvers.fgmres import fgmres, fgmres_mp
from .solvers.krylov import bicgstab, cgn
from .utils import pin_full_precision


@dataclasses.dataclass
class SetupStatus:
    """Reference dd_alpha_amg_setup_status."""

    setup_time: float = 0.0
    gauge_updates_since_setup: int = 0


@dataclasses.dataclass
class SolveInfo:
    iterations: int
    relres: float
    converged: bool
    solve_time: float
    # coarsest iterations per outer iteration (one per dense-inverse apply
    # with coarsest direct, as in the JAX package); on a card (one rank or
    # any grid, whose coarsest level is replicated) the coarsest GCR is a
    # CUDA graph replay whose [B, 3] counters come out of the graph with x
    # (mg/coarsest.py), elsewhere the host loop's
    coarse_average: float = 0.0
    # coarsest GCR operator applications per outer iteration, and dense
    # inverse applies in the solve (the JAX package's SolveInfo fields)
    coarse_matvec_average: float = 0.0
    coarsest_inverse_applies: float = 0.0
    resvec: list = dataclasses.field(default_factory=list)
    # the card's allocator high-water mark, else the Solver's tensor ledger
    # (profiling.solve_memory_mb; reference main.h:88-140)
    memory_mb: float = 0.0
    # the multigrid outer loop's inner GCR length (inner_restart_cap) and
    # the last inner-sweep clip it applied (adapt_clip; 0 for a complex128
    # inner solve), as the JAX package's SolveInfo reports them
    inner_restart_cap: int = 0
    inner_tol_clip: float = 0.0
    # the accelerator options of the hierarchy: {name: (on, why)}
    options: dict = dataclasses.field(default_factory=dict)


_SCHEMES = {1: "additive", 2: "red_black", 3: "sixteen_color"}
OPTIONS = ("coarse_block_bf16", "coarsest_direct", "smoother_direct")
# the largest coarsest problem (unknowns) whose dense inverse the defaults
# build: with the Schur form (a quarter of the bytes) and without
COARSEST_DIRECT_MAX = {True: 16384, False: 8192}
# the inner sweep's clip (adapt_clip): where it starts, and its cap
CLIP_START, CLIP_MAX = 1e-5, 5e-2
# up to this many lattice sites a learned clip takes effect one restart
# later, as in the JAX package's fused outer step (api.py:703, :723-733);
# above, at once, as in its loop with the residual apart (:734-760)
CLIP_LAG_SITES = 200_000
# the two inner GCR bases may take this share of a card's memory
# (inner_restart_cap): the JAX package's 150M complex elements a basis on a
# 16 GB chip; its default budget where there is no card
INNER_BASIS_SHARE = 0.15
INNER_BASIS_BUDGET = 150_000_000


def coarsest_n(p: SolverParams) -> int:
    """Unknowns of the coarsest problem: its sites x 2 N of the level above
    (the JAX package's _coarsest_n; huge without multigrid levels)."""
    if p.num_levels < 2:
        return 1 << 30
    sites = int(np.prod(p.depth[p.num_levels - 1].global_lattice))
    return sites * 2 * p.depth[p.num_levels - 2].test_vectors


def coarsest_schur_ok(p: SolverParams) -> bool:
    """Whether the coarsest level's dense inverse is the Schur complement's
    (a quarter of the bytes): the gate of Multigrid._odd_even, on the
    parameters (the JAX package's _coarsest_schur_ok)."""
    if not p.odd_even or p.num_levels < 2:
        return False
    return all(e % 2 == 0 for e in p.depth[p.num_levels - 1].global_lattice)


def accelerator_options(p: SolverParams, accelerator: bool) -> dict:
    """The three options of the hierarchy, {name: (on, why)}: an ini key
    decides where it is set; elsewhere the JAX package's rule for an
    accelerator that is not a TPU (its api.py:228-260) on an accelerator,
    all off on the CPU."""
    n, schur = coarsest_n(p), coarsest_schur_ok(p)
    limit = COARSEST_DIRECT_MAX[schur]
    form = "Schur form" if schur else "no Schur form"
    if not accelerator:
        rule = {k: (False, "default off on the CPU") for k in OPTIONS}
    else:
        rule = {
            "coarse_block_bf16": (
                (True, "CUDA default") if p.mixed_precision else
                (False, "off by default with mixed precision 0 (complex128 coarse "
                        "levels; K4-bf16 takes complex64 fields)")),
            "coarsest_direct": (n <= limit, f"CUDA default: coarsest n = {n:,} "
                                            f"{'<=' if n <= limit else '>'} {limit:,} ({form})"),
            "smoother_direct": (False, "CUDA default off (the JAX rule turns it on on a "
                                       "TPU only)"),
        }
    out = {}
    for key in OPTIONS:
        val = getattr(p, key)
        out[key] = (bool(val), "ini") if val is not None else rule[key]
    return out


def adapt_clip(clip: float, prev_rel, cur_rel, tol: float) -> float:
    """The inner sweep's clip after the restart that took every lane's
    relative residual from prev_rel to cur_rel (the JAX package's
    adapt_clip, api.py:705-716): a lane whose sweep fell well short of its
    target (more than 3x the reduction asked for, yet some reduction)
    exposes the f32 per-sweep floor of this problem, and the clip rises to
    0.7 of the weakest such reduction, at most CLIP_MAX."""
    prev_rel, cur_rel = np.asarray(prev_rel), np.asarray(cur_rel)
    with np.errstate(divide="ignore", invalid="ignore"):
        ach = cur_rel / np.maximum(prev_rel, 1e-300)
    req = np.maximum(tol / np.maximum(prev_rel, 1e-300), clip)
    learn = (prev_rel >= tol) & (ach > 3.0 * req) & (ach < 1.0)
    if learn.any():
        return float(min(max(clip, 0.7 * ach[learn].max()), CLIP_MAX))
    return clip


def inner_restart_cap(restart_length: int, n_dof: int, batch: int, device,
                      mesh=None) -> int:
    """The inner GCR's length for `batch` lanes of n_dof unknowns (this
    rank's slab): max(5, min(restart_length, budget // (n_dof batch))), so
    that one basis holds at most `budget` complex elements (the JAX
    package's rule, api.py:653-662).  DDAAMG_INNER_BASIS_BUDGET sets the
    budget and DDAAMG_INNER_M_CAP the cap itself; unset, the budget is the
    JAX package's 150M elements, or on a card INNER_BASIS_SHARE of its
    memory for both bases in complex64 (150M on 16 GB).  Under a mesh every
    rank takes the smallest rank's cap: the ranks' GCRs make the same
    collective calls."""
    env_cap = os.environ.get("DDAAMG_INNER_M_CAP")
    if env_cap is not None:
        cap = int(env_cap)
    else:
        env = os.environ.get("DDAAMG_INNER_BASIS_BUDGET")
        if env is not None:
            budget = int(env)
        elif torch.device(device).type == "cuda":
            total = torch.cuda.mem_get_info(device)[1]
            budget = int(INNER_BASIS_SHARE * total) // (2 * 8)
        else:
            budget = INNER_BASIS_BUDGET
        cap = max(5, min(restart_length, budget // max(n_dof * batch, 1)))
    if mesh is not None:
        cap = -int(comm.all_reduce_max(mesh, -cap))
    return cap


class Solver:
    """Wilson-clover solver on one device (`device`, e.g. "cuda" or "cpu";
    nothing moves to another device behind the caller's back), or on this
    rank's device of a process grid (`mesh`; every rank constructs its
    Solver and calls the same methods in the same order)."""

    def __init__(self, params: SolverParams, device="cuda", mesh=None):
        pin_full_precision()
        self.p = params.validate()
        self.device = torch.device(device)
        self.mesh = mesh
        self.op: Optional[WilsonOperator] = None     # global, logical layout
        self._op_slab: Optional[WilsonOperator] = None
        self.outer: Optional[WilsonStencilSoA] = None
        self.mg: Optional[Multigrid] = None
        # the preconditioner of the solve: the Multigrid, or that of a
        # method without multigrid (None for methods -1 and 0)
        self.preconditioner = None
        # the fine stencil in the inner precision of the methods without
        # multigrid; rebuilt whenever the operator changes
        self._inner: Optional[WilsonStencilSoA] = None
        # the operator slab the hierarchy's fine level was built from
        self._mg_op: Optional[WilsonOperator] = None
        self.status = SetupStatus()
        self._inner_dtype = (torch.complex64 if params.mixed_precision
                             else torch.complex128)
        # the options of the last hierarchy built (accelerator_options)
        self.options: dict = {}

    @property
    def lattice(self):
        return tuple(self.p.depth[0].global_lattice)

    @property
    def local_lattice(self):
        if self.mesh is None:
            return self.lattice
        return local_lattice(self.mesh, self.lattice)

    @property
    def multigrid(self) -> bool:
        """Whether the method runs the multigrid hierarchy (methods 1-3 with
        more than one level and an interpolation)."""
        p = self.p
        if not (p.method in (1, 2, 3) and p.num_levels > 1 and p.interpolation > 0):
            return False
        if p.interpolation not in (1, 2, 4):
            raise ValueError(f"interpolation: {p.interpolation} unsupported (0 off, 1 "
                             "two-level extension, 2 bootstrap F-cycle, 4 test vectors "
                             "from a file)")
        return True

    # --- configuration -------------------------------------------------

    def read_conf(self, path: Optional[str] = None):
        """Returns (computed plaquette, plaquette in the file header)."""
        U, header_plaq = dio.read_gauge_field(path or self.p.configuration,
                                              anti_periodic=self.p.anti_pbc)
        return self.set_conf(U, links_have_bc=True), header_plaq

    def set_conf(self, U, links_have_bc: bool = False) -> float:
        """Store the gauge field and build the Dirac operator in complex128;
        returns the average plaquette (reference dd_alpha_amg_set_conf)."""
        bc = self.p.bc if self.p.bc is not None else (2 if self.p.anti_pbc else 1)
        U = np.array(U, dtype=np.complex128)
        if bc == 2 and not links_have_bc:
            U[0, -1] *= -1.0
        if bc == 0 and np.abs(U[0, -1]).max() != 0.0:
            raise ValueError("bc 0 (open): the gauge field does not fit the boundary "
                             "conditions (U_T on the last time slice must be zero)")
        Ud = torch.as_tensor(U, device=self.device)
        self.op = WilsonOperator.from_gauge(Ud, m0=self.p.m0, csw=self.p.csw)
        if bc == 0:       # the clover keeps the whole field, the hops do not
            links = self.op.links.clone()
            T = links.shape[1]
            links[0, [0, T - 2, T - 1]] = 0
            self.op = self.op._replace(links=links)
        self._op_slab = self.op
        if self.mesh is not None:
            self._op_slab = shard_operator(self.mesh, self.op)
        # the outer loop's true residual: complex128 operator through K1
        self.outer = WilsonStencilSoA.build(self._op_slab, self._geom(),
                                            dtype=torch.complex128, mesh=self.mesh)
        self._inner = None
        if self.mg is not None:         # its programs captured the old operator
            self.mg.drop_graphs()
        self.status.gauge_updates_since_setup += 1
        return average_plaquette(Ud)

    def _geom(self) -> Geometry:
        """The fine level's geometry (this rank's slab under a mesh)."""
        return Geometry(lattice=self.local_lattice,
                        block=tuple(self.p.depth[0].block_lattice))

    def _inner_stencil(self) -> WilsonStencilSoA:
        """The fine stencil in the inner precision (the methods without
        multigrid; self.outer itself for mixed precision 0)."""
        if self._inner_dtype == torch.complex128:
            return self.outer
        if self._inner is None:
            self._inner = WilsonStencilSoA.build(self._op_slab, self._geom(),
                                                 dtype=self._inner_dtype, mesh=self.mesh)
        return self._inner

    # --- setup ---------------------------------------------------------

    def _mg_config(self) -> MGConfig:
        p = self.p
        self.options = accelerator_options(p, self.device.type == "cuda")
        on = {k: v[0] for k, v in self.options.items()}
        return MGConfig(
            levels=[LevelConfig(
                lattice=tuple(d.global_lattice), block=tuple(d.block_lattice),
                post_smooth_iter=d.post_smooth_iter, block_iter=d.block_iter,
                num_test_vectors=d.test_vectors, setup_iter=d.setup_iter,
                n_cy=d.preconditioner_cycles,
            ) for d in p.depth[:p.num_levels]],
            kcycle=p.kcycle, kcycle_tol=p.kcycle_tol,
            kcycle_length=p.kcycle_length, kcycle_restarts=p.kcycle_restarts,
            coarse_tol=p.coarse_tol, coarse_iter=p.coarse_iter,
            coarse_restart=p.coarse_restart, odd_even=p.odd_even,
            scheme=_SCHEMES[p.method], dtype=self._inner_dtype,
            seed=self._seed(), mesh=self.mesh,
            **on)

    def _seed(self) -> int:
        if not self.p.randomize_test_vectors:
            return self.p.seed
        seed = int(time.time())
        if self.mesh is not None:       # one hierarchy: rank 0's seed
            seed = int(replicate(self.mesh, torch.tensor([seed]))[0])
        return seed

    def build_hierarchy(self) -> Multigrid:
        """The multigrid hierarchy with its initial (smoothed random) test
        vectors, before any setup iteration."""
        if self.op is None:
            raise RuntimeError("call set_conf first")
        if not self.multigrid:
            raise ValueError(f"method {self.p.method} with interpolation "
                             f"{self.p.interpolation} and {self.p.num_levels} levels "
                             "runs no multigrid")
        self.mg = self.preconditioner = Multigrid(self._op_slab, self._mg_config())
        self._mg_op = self._op_slab
        return self.mg

    def setup(self) -> SetupStatus:
        """Build the preconditioner (reference dd_alpha_amg_setup; the JAX
        package's api.py:262-316): the hierarchy and its setup for the
        multigrid methods, else the method's own preconditioner.  With the
        tracer on (profiling.PROF) the call is one request."""
        if PROF.on:
            with PROF.request("setup"):
                return self._setup()
        return self._setup()

    def _setup(self) -> SetupStatus:
        if self.op is None:
            raise RuntimeError("call set_conf first")
        p = self.p
        t0 = time.perf_counter()
        if self.mg is not None:
            self.mg.drop_graphs()
        self.mg = None
        if self.multigrid:
            mg = self.build_hierarchy()       # also the preconditioner
            if p.interpolation == 4:
                if not p.tv_io_file_name:
                    raise ValueError("interpolation 4 needs a `test vector io file name`")
                n = p.depth[0].test_vectors
                tvs = dio.read_test_vectors(p.tv_io_file_name, self.lattice, n=n,
                                            single_file=p.tv_io_single_file)
                mg.set_test_vectors(tvs.reshape(n, *self.lattice, 4, 3))
            elif p.interpolation == 2:
                mg.bootstrap_setup()
            else:
                mg.twolevel_extension_setup()
        else:
            self.preconditioner = self._plain_preconditioner()
        self._sync()
        self.status.setup_time = self._wall(time.perf_counter() - t0)
        self.status.gauge_updates_since_setup = 0
        return self.status

    def _plain_preconditioner(self):
        """The preconditioner of a method without multigrid, on the fine
        stencil in the inner precision (None for methods -1 and 0)."""
        p = self.p
        if p.method in (-1, 0):
            return None
        d0 = p.depth[0]
        s = self._inner_stencil()
        if p.method in (1, 2, 3):
            if self.mesh is not None:
                check_blocks(self.mesh, self.lattice, d0.block_lattice)
            return SchwarzPreconditioner(s, block_iter=d0.block_iter,
                                         cycles=d0.preconditioner_cycles,
                                         odd_even=p.odd_even, scheme=_SCHEMES[p.method])
        if p.method == 4:
            return OddEvenPreconditioner(s, block_iter=d0.block_iter,
                                         cycles=d0.preconditioner_cycles)
        if p.method == 5:
            def bicgstab_prec(eta):
                return bicgstab(s.full_op, eta.to(s.dtype), tol=1e-1, max_iter=50,
                                mesh=self.mesh).x
            return bicgstab_prec
        raise ValueError(f"method: {p.method} unsupported (-1 to 5)")

    def update_setup(self, iterations: int = 1) -> SetupStatus:
        """More setup iterations of the configured kind on the existing
        hierarchy (reference dd_alpha_amg_setup_update)."""
        if self.mg is None:
            raise RuntimeError("update_setup needs a multigrid setup")
        t0 = time.perf_counter()
        if self.p.interpolation == 1:
            self.mg.twolevel_extension_setup(iterations)
        else:
            self.mg.bootstrap_setup(iterations)
        self._sync()
        self.status.setup_time += self._wall(time.perf_counter() - t0)
        return self.status

    def shift_update(self, new_m0: float):
        """Set the mass for the next solves without a new setup (reference
        dd_alpha_amg_set_mass_for_next_solve / shift_update,
        src/dirac_generic.c:504-551): the operator, its slab and the
        complex128 outer stencil are shifted, and so is every level of the
        hierarchy (Multigrid.shift_update); a preconditioner without
        multigrid is built anew."""
        delta = new_m0 - self.p.m0
        if delta == 0.0:
            return
        if self.mg is not None:
            self.mg.require_setup("shift_update")    # before anything moves
        self.p.m0 = new_m0
        self.op = shift_diagonal(self.op, delta)
        self._op_slab = (self.op if self.mesh is None
                         else shift_diagonal(self._op_slab, delta))
        self.outer = shift_stencil(self.outer, delta, self._op_slab)
        self._inner = None
        if self.mg is not None:
            self.mg.shift_update(delta, self._op_slab)
            self._mg_op = self._op_slab
        elif self.preconditioner is not None:
            self.preconditioner = self._plain_preconditioner()

    def write_test_vectors(self, path: Optional[str] = None,
                           single_file: Optional[bool] = None):
        """Write the fine level's test vectors (reference vector_io WRITE,
        src/io.c:951), for a later setup with `interpolation: 4`; under a
        mesh rank 0 writes."""
        if self.mg is None:
            raise RuntimeError("no multigrid setup to write")
        path = path or self.p.tv_io_file_name
        single = self.p.tv_io_single_file if single_file is None else single_file
        tvs = self.mg.get_test_vectors()
        if self.mesh is None or self.mesh.rank == 0:
            dio.write_test_vectors(path, tvs.reshape(tvs.shape[0], *self.lattice, 12),
                                   single_file=single,
                                   header={"m0": self.p.m0, "csw": self.p.csw})

    def slim_for_solve(self):
        """Drop what only the setup needs, once it is done (the JAX
        package's Solver.slim_for_solve, api.py:868-876; a 32^4 hierarchy
        holds its full-precision depth-1 stencil, 14.8 GB, beside the bf16
        view the cycles read): Multigrid.slim_for_solve.  Solves go on
        with the same bits; update_setup, shift_update and
        write_test_vectors raise until the next setup(), which builds the
        whole hierarchy anew.  A set_conf keeps the slim hierarchy as the
        preconditioner of the new operator, as it keeps a full one."""
        if self.mg is not None:
            self.mg.slim_for_solve()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wall(self, seconds: float) -> float:
        """A wall time every rank reports alike: the slowest rank's."""
        return seconds if self.mesh is None else comm.all_reduce_max(self.mesh, seconds)

    def _norms(self, v) -> np.ndarray:
        """The global 2-norm of every lane of fine fields [*B, 12, V] (slabs
        [*B, 12, V_l] under a mesh), on the host: one read of the device."""
        f = v.reshape(-1, v.shape[-2] * v.shape[-1])
        with span("read norms", kind="read"):
            if self.mesh is None:
                return torch.linalg.vector_norm(f, dim=1).cpu().numpy()
            return np.sqrt(self.outer.allsum(torch.linalg.vecdot(f, f).real).cpu().numpy())

    def _scatter(self, a) -> torch.Tensor:
        """Global numpy fine fields [*B, T, Z, Y, X, 4, 3] -> this rank's
        dof-major slabs [*B, 12, V_l] in complex128 (rank 0's copy under a
        mesh)."""
        with span("scatter"):
            b = fast.spinor_to_soa(torch.as_tensor(np.asarray(a, np.complex128),
                                                   device=self.device))
            if self.mesh is None:
                return b
            return self.outer.slab(replicate(self.mesh, b))

    def _gather(self, x) -> np.ndarray:
        """Dof-major (slabs of) fields [*B, 12, V_l] -> global numpy
        [*B, T, Z, Y, X, 4, 3] on every rank."""
        with span("gather"):
            if self.mesh is not None:
                x = gather_field(self.mesh, x, self.local_lattice)
            return fast.spinor_from_soa(x, self.lattice).cpu().numpy()

    # --- solves --------------------------------------------------------

    def apply_operator(self, v: torch.Tensor) -> torch.Tensor:
        """D v in complex128 for dof-major fields [*, 12, V] (K1; slabs
        [*, 12, V_l] under a mesh)."""
        return self.outer.full_op(v)

    def apply_preconditioner(self, v):
        """The preconditioner applied to a numpy field [T, Z, Y, X, 4, 3]
        (reference dd_alpha_amg_preconditioner); returns numpy of that shape
        (the field itself for methods -1 and 0)."""
        if self.preconditioner is None and self.p.method not in (-1, 0):
            raise RuntimeError("call setup first")
        b = self._scatter(v)
        if self.preconditioner is None:
            return self._gather(b)
        return self._gather(self.preconditioner(b).to(torch.complex128))

    def solve(self, rhs=None, tol: Optional[float] = None, x0=None):
        """Solve D x = rhs from x0 (zero if None); rhs, x0 and x are numpy
        [T, Z, Y, X, 4, 3] (batch 1 of solve_multi)."""
        if rhs is None:
            rhs = make_rhs(self.p.right_hand_side, self.lattice, seed=self.p.seed)
        x, infos = self.solve_multi(np.asarray(rhs)[None], tol,
                                    None if x0 is None else np.asarray(x0)[None])
        return x[0], infos[0]

    def solve_multi(self, rhs_batch, tol: Optional[float] = None, x0=None):
        """Solve D x_i = rhs_i for a stack of right-hand sides rhs_batch
        [B, T, Z, Y, X, 4, 3] (numpy) from the initial guesses x0 (same
        shape, or None for zeros) with one setup.  The multigrid methods
        run all B systems together (the JAX package's Solver.solve_multi,
        api.py:792-839): every cycle, GCR and kernel runs the batch, and
        each system stops on its own; as in the JAX package's batched path,
        solve_time is the batch's wall time over B, the coarse averages are
        over the batch's iterations and coarsest_inverse_applies is the
        batch's over B.  The other methods solve the systems one after the
        other.  Returns (x [B, T, Z, Y, X, 4, 3], [SolveInfo] * B).  With
        the tracer on (profiling.PROF) the call is one request."""
        if PROF.on:
            with PROF.request("solve_multi", rhs=len(rhs_batch)):
                return self._solve_multi(rhs_batch, tol, x0)
        return self._solve_multi(rhs_batch, tol, x0)

    def _solve_multi(self, rhs_batch, tol, x0):
        if self.op is None:
            raise RuntimeError("call set_conf first")
        if (self.mg is None if self.multigrid
                else self.preconditioner is None and self.p.method not in (-1, 0)):
            raise RuntimeError("call setup first")
        tol = self.p.tol if tol is None else tol
        rhs_batch = np.asarray(rhs_batch)
        if self.mg is None:
            return self._solve_krylov_multi(rhs_batch, tol, x0)
        B = rhs_batch.shape[0]
        self.mg.stats.update(coarse_iterations=0.0, coarse_matvecs=0.0,
                             coarsest_inverse_applies=0.0)
        t0 = time.perf_counter()
        b = self._scatter(rhs_batch)
        x, iters, relres, resvec, cap, clip = self._solve_mp(
            b, tol, None if x0 is None else self._scatter(x0))
        x_log = self._gather(x)
        self._sync()
        dt = self._wall(time.perf_counter() - t0)
        st = self.mg.stats
        total = max(int(iters.sum()), 1)
        mem = solve_memory_mb(self)
        infos = [SolveInfo(iterations=int(iters[i]), relres=float(relres[i]),
                           converged=bool(relres[i] < tol), solve_time=dt / B,
                           coarse_average=st["coarse_iterations"] / total,
                           coarse_matvec_average=st["coarse_matvecs"] / total,
                           coarsest_inverse_applies=st["coarsest_inverse_applies"] / B,
                           resvec=[float(rv[i]) for rv in resvec], memory_mb=mem,
                           inner_restart_cap=cap, inner_tol_clip=clip,
                           options=dict(self.options))
                 for i in range(B)]
        return x_log, infos

    def _profiled(self, fn, name, fine_op=False):
        """fn timed by the profiler as the JAX package's solve hooks time
        the fine operator and the preconditioner (its api.py:914-932; the
        reference's PROF_PRECISION_START/STOP), the fine operator at
        FLOPS_FINE_FULL a site of each lane; fn itself with PROF off."""
        if not PROF.on:
            return fn
        vol = int(np.prod(self.lattice))
        per_call = ((lambda v: FLOPS_FINE_FULL * vol * (v.numel() // (12 * v.shape[-1])))
                    if fine_op else (lambda v: 0.0))
        return PROF.wrap(fn, name, per_call, self.device)

    def _solve_mp(self, b, tol, x0=None):
        """Outer loop of every lane of b [B, 12, V]: once per restart the
        complex128 true residual of all lanes (one K1 apply at batch B;
        also at restart 0 when x0 is given), then one inner flexible-GCR
        restart of all lanes in the inner precision, of at most
        inner_restart_cap iterations, each lane asked to reduce its
        residual by what remains to be done, but by no more than the clip;
        lanes that have converged are masked off and keep their x.  The
        clip is DDAAMG_INNER_CLIP or inner_tol_clip where either is set;
        else, for a complex64 inner solve, it adapts (adapt_clip) from
        CLIP_START, the reference's inner threshold MAX(tol, 1e-5)
        (src/linsolve.c:44), after every restart but the last: at once
        above CLIP_LAG_SITES, one restart later up to there, as the JAX
        package's loop does at each size; a complex128 inner solve has none and
        runs as one Krylov space like the reference's double-precision
        FGMRES.  Returns (x, iterations [B], relres [B], resvec: the relres
        of every restart, the inner GCR length, the last clip)."""
        p = self.p
        env = os.environ.get("DDAAMG_INNER_CLIP")
        fixed = float(env) if env is not None else p.inner_tol_clip
        adaptive = fixed is None and self._inner_dtype == torch.complex64
        if fixed is not None:
            clip = float(fixed)
        else:
            clip = CLIP_START if adaptive else 0.0
        m = inner_restart_cap(p.restart_length, b.shape[-2] * b.shape[-1], b.shape[0],
                              b.device, self.mesh)
        norm_b = self._norms(b)
        norm_b = np.where(norm_b == 0, 1.0, norm_b)
        x = torch.zeros_like(b) if x0 is None else x0.clone()
        iters = torch.zeros(b.shape[0], device=b.device)
        resvec = []
        apply_fine = self._profiled(self.apply_operator, "fine_op (d_plus_clover)", True)

        def wrap(fn):
            # the host-driven inner restart times the cycle (a replay is a row itself)
            return self._profiled(fn, "preconditioner (v-cycle)")

        # the inner GCR runs on the solve operator: the hierarchy's fine level,
        # unless that was built from another operator (a set_conf since the
        # setup, or compat's setup mass and clover scaling), as the JAX
        # package's FGMRES runs on Solver.op with the hierarchy as its
        # preconditioner
        gcr_op = (None if self._mg_op is None or self._mg_op is self._op_slab
                  else self._inner_stencil().full_op)
        lag = int(np.prod(self.lattice)) <= CLIP_LAG_SITES
        prev = None
        for restart in range(p.max_restarts + 1):
            with span("outer iteration"):
                if restart == 0 and x0 is None:
                    r = b
                else:
                    with span("residual"), site("outer residual", 0):
                        r = b - apply_fine(x)
                nr = self._norms(r)
                relres = nr / norm_b
                resvec.append(relres)
                last = restart == p.max_restarts
                learned = (adapt_clip(clip, prev, relres, tol)
                           if adaptive and prev is not None and not last else clip)
                rel_tol = np.maximum(tol * norm_b / np.maximum(nr, 1e-300),
                                     clip if lag else learned)
                clip, prev = learned, relres
                active = relres >= tol
                if not active.any() or last:
                    break
                z, it = self.mg.inner_restart(
                    r.to(self._inner_dtype), torch.as_tensor(rel_tol, device=b.device),
                    m=m, active=torch.as_tensor(active, device=b.device),
                    wrap=wrap, op=gcr_op)
                x = x + z.to(torch.complex128)
                iters = iters + it
        with span("read iterations", kind="read"):
            iters = iters.cpu().numpy().astype(int)
        return x, iters, relres, resvec, m, clip

    def _solve_krylov_multi(self, rhs_batch, tol, x0):
        """The methods without multigrid, one right-hand side after the
        other (the JAX package's solve dispatch, api.py:937-979, without its
        accelerator branches)."""
        xs, infos = [], []
        for i in range(rhs_batch.shape[0]):
            t0 = time.perf_counter()
            res = self._solve_krylov(self._scatter(rhs_batch[i]), tol,
                                     None if x0 is None else self._scatter(x0[i]))
            x = self._gather(res.x)
            self._sync()
            xs.append(x)
            infos.append(SolveInfo(iterations=res.iterations, relres=res.relres,
                                   converged=res.converged,
                                   solve_time=time.perf_counter() - t0,
                                   resvec=res.resvec, memory_mb=solve_memory_mb(self)))
        return np.stack(xs), infos

    def _solve_krylov(self, b, tol, x0):
        """One system [12, V]: method -1 CGN, mixed precision 2 FGMRES with a
        complex64 inner loop, else FGMRES in complex128."""
        p = self.p
        fine = "fine_op (d_plus_clover)"
        prec = self.preconditioner
        if prec is not None:
            prec = self._profiled(prec, "preconditioner (v-cycle)")
        if p.method == -1:
            return cgn(self._profiled(self.outer.full_op, fine, True), self.outer.dagger_op,
                       b, x0=x0, tol=tol, max_iter=p.restart_length * p.max_restarts,
                       mesh=self.mesh)
        if p.mixed_precision == 2:
            inner = self._inner_stencil()

            def apply_mp(v):        # keeps v's precision
                return (self.outer if v.dtype == torch.complex128 else inner).full_op(v)

            return fgmres_mp(self._profiled(apply_mp, fine, True), b, x0=x0,
                             preconditioner=prec, tol=tol,
                             restart_length=p.restart_length,
                             max_restarts=p.max_restarts, inner_dtype=inner.dtype,
                             mesh=self.mesh, single_reduce=self._single_reduce())
        return fgmres(self._profiled(self.outer.full_op, fine, True), b, x0=x0,
                      preconditioner=prec, tol=tol, restart_length=p.restart_length,
                      max_restarts=p.max_restarts, mesh=self.mesh,
                      single_reduce=self._single_reduce())

    def _single_reduce(self):
        """The Arnoldi form of the host FGMRES (solvers/fgmres.py), the JAX
        package's policy (its api.py:331-343): "fused" under a mesh, where
        each all-reduce and each read of the device costs most, False on
        one rank; DDAAMG_SINGLE_REDUCE=0/1/fused/pythagoras overrides it
        (1 is "fused")."""
        env = os.environ.get("DDAAMG_SINGLE_REDUCE")
        if env is not None:
            return {"0": False, "1": "fused"}.get(env, env)
        return "fused" if self.mesh is not None else False

    def true_residual(self, x, rhs) -> float:
        """||rhs - D x|| / ||rhs|| in complex128 (the reference's
        FGMRES_RESTEST); x and rhs are global arrays."""
        b = self._scatter(rhs)
        r = b - self.apply_operator(self._scatter(x))
        return float(self._norms(r)[0] / self._norms(b)[0])
