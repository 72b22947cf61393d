"""Library API, mirroring the reference C API (dd_alpha_amg.h:42-84) and the
JAX package's api.Solver: set_conf / setup / solve.

    params = config.parse_ini("sample.ini")
    solver = api.Solver(params, device="cuda")
    plaq = solver.set_conf(U)            # U [4,T,Z,Y,X,3,3] numpy, raw links
    solver.setup()                       # hierarchy + bootstrap
    x, info = solver.solve(rhs, tol=1e-10)
    xs, infos = solver.solve_multi(rhs_batch)   # [B, T, Z, Y, X, 4, 3]

Ported: method 2 (FGMRES + red-black SAP) with interpolation 2 (bootstrap
F-cycle setup) and two or more levels, mixed precision 0 (complex128 inner
solve) or 1 and 2 (complex64 inner solve).  The outer loop refreshes the
true residual in complex128 once per restart and runs each restart's inner
solve as flexible GCR preconditioned by the multigrid cycle.  It runs a
batch of right-hand sides (solve_multi; solve is batch 1), each with its
own tolerances and stop.

The JAX package's accelerator options are ported and off unless the ini
turns them on (`coarse block bf16: 1`, `coarsest direct: 1`,
`smoother direct: 1`; mg/hierarchy.py describes them): bf16 coarse blocks
(complex64 inner solve only), a dense inverse on the coarsest level and
direct Schwarz block solves on the coarse levels.  An option that is on
builds its inverse at any size.  The JAX package turns all three on by
default on its accelerator (its api.py:228-238); the CUDA defaults wait
for a GPU benchmark.

With a mesh (parallel/mesh.SolverMesh, one process per rank) the solve is
domain-decomposed over a t/z process grid: every rank computes the
plaquette and the complex128 clover on the global field and keeps its slab,
solve scatters the right-hand side, the outer loop runs on slabs with
global norms, and the solution is gathered so that solve returns the same
global array on every rank.
"""

from __future__ import annotations

import dataclasses
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
from .operators.stencil import WilsonStencilSoA
from .operators.wilson import WilsonOperator
from .parallel import comm
from .parallel.mesh import gather_field, local_lattice, replicate, shard_operator
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
    # with coarsest direct, as in the JAX package)
    coarse_average: float = 0.0
    # coarsest GCR operator applications per outer iteration, and dense
    # inverse applies in the solve (the JAX package's SolveInfo fields)
    coarse_matvec_average: float = 0.0
    coarsest_inverse_applies: float = 0.0
    resvec: list = dataclasses.field(default_factory=list)


_SCHEMES = {1: "additive", 2: "red_black", 3: "sixteen_color"}


class Solver:
    """Wilson-clover solver on one device (`device`, e.g. "cuda" or "cpu";
    nothing moves to another device behind the caller's back), or on this
    rank's device of a t/z process grid (`mesh`; every rank constructs its
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
        self.status = SetupStatus()
        self._inner_dtype = (torch.complex64 if params.mixed_precision
                             else torch.complex128)

    @property
    def lattice(self):
        return tuple(self.p.depth[0].global_lattice)

    @property
    def local_lattice(self):
        if self.mesh is None:
            return self.lattice
        return local_lattice(self.mesh, self.lattice)

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
        if bc == 0:
            raise NotImplementedError("Dirichlet (open) time boundaries are not "
                                      "ported yet (ROADMAP A, still to port 4)")
        U = np.array(U, dtype=np.complex128)
        if bc == 2 and not links_have_bc:
            U[0, -1] *= -1.0
        Ud = torch.as_tensor(U, device=self.device)
        self.op = WilsonOperator.from_gauge(Ud, m0=self.p.m0, csw=self.p.csw)
        self._op_slab = self.op
        if self.mesh is not None:
            self._op_slab = shard_operator(self.mesh, self.op)
        geom = Geometry(lattice=self.local_lattice,
                        block=tuple(self.p.depth[0].block_lattice))
        # the outer loop's true residual: complex128 operator through K1
        self.outer = WilsonStencilSoA.build(self._op_slab, geom,
                                            dtype=torch.complex128, mesh=self.mesh)
        self.status.gauge_updates_since_setup += 1
        return average_plaquette(Ud)

    # --- setup ---------------------------------------------------------

    def _mg_config(self) -> MGConfig:
        p = self.p
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
            coarse_block_bf16=bool(p.coarse_block_bf16),
            coarsest_direct=bool(p.coarsest_direct),
            smoother_direct=bool(p.smoother_direct))

    def _seed(self) -> int:
        if not self.p.randomize_test_vectors:
            return self.p.seed
        seed = int(time.time())
        if self.mesh is not None:       # one hierarchy: rank 0's seed
            seed = int(replicate(self.mesh, torch.tensor([seed]))[0])
        return seed

    def build_hierarchy(self) -> Multigrid:
        """The multigrid hierarchy with its initial (smoothed random) test
        vectors, before any bootstrap iteration."""
        if self.op is None:
            raise RuntimeError("call set_conf first")
        p = self.p
        if not (p.method == 2 and p.interpolation == 2 and p.num_levels > 1):
            raise NotImplementedError(
                f"method {p.method} with interpolation {p.interpolation} and "
                f"{p.num_levels} levels is not ported yet; the port runs "
                "method 2, interpolation 2, >= 2 levels (ROADMAP A, still to port 4)")
        self.mg = Multigrid(self._op_slab, self._mg_config())
        return self.mg

    def setup(self) -> SetupStatus:
        """Build the preconditioner (reference dd_alpha_amg_setup): the
        hierarchy, then the bootstrap setup."""
        t0 = time.perf_counter()
        self.build_hierarchy().bootstrap_setup()
        self._sync()
        self.status.setup_time = self._wall(time.perf_counter() - t0)
        self.status.gauge_updates_since_setup = 0
        return self.status

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
        if self.mesh is None:
            return torch.linalg.vector_norm(f, dim=1).cpu().numpy()
        return np.sqrt(self.outer.allsum(torch.linalg.vecdot(f, f).real).cpu().numpy())

    def _scatter(self, a) -> torch.Tensor:
        """Global numpy fine fields [*B, T, Z, Y, X, 4, 3] -> this rank's
        dof-major slabs [*B, 12, V_l] in complex128 (rank 0's copy under a
        mesh)."""
        b = fast.spinor_to_soa(torch.as_tensor(np.asarray(a, np.complex128),
                                               device=self.device))
        if self.mesh is None:
            return b
        return self.outer.slab(replicate(self.mesh, b))

    # --- solves --------------------------------------------------------

    def apply_operator(self, v: torch.Tensor) -> torch.Tensor:
        """D v in complex128 for dof-major fields [*, 12, V] (K1; slabs
        [*, 12, V_l] under a mesh)."""
        return self.outer.full_op(v)

    def solve(self, rhs=None, tol: Optional[float] = None):
        """Solve D x = rhs; rhs and x are numpy [T, Z, Y, X, 4, 3] (batch 1
        of solve_multi)."""
        if rhs is None:
            rhs = make_rhs(self.p.right_hand_side, self.lattice, seed=self.p.seed)
        x, infos = self.solve_multi(np.asarray(rhs)[None], tol)
        return x[0], infos[0]

    def solve_multi(self, rhs_batch, tol: Optional[float] = None):
        """Solve D x_i = rhs_i for a stack of right-hand sides rhs_batch
        [B, T, Z, Y, X, 4, 3] (numpy) with one setup, all B systems
        together (the JAX package's Solver.solve_multi, api.py:792-839):
        every cycle, GCR and kernel runs the batch, and each system stops
        on its own.  Returns (x [B, T, Z, Y, X, 4, 3], [SolveInfo] * B);
        as in the JAX package's batched path, solve_time is the batch's
        wall time over B, the coarse averages are over the batch's
        iterations and coarsest_inverse_applies is the batch's over B."""
        if self.mg is None:
            raise RuntimeError("call setup first")
        tol = self.p.tol if tol is None else tol
        rhs_batch = np.asarray(rhs_batch)
        B = rhs_batch.shape[0]
        self.mg.stats.update(coarse_iterations=0.0, coarse_matvecs=0.0,
                             coarsest_inverse_applies=0.0)
        t0 = time.perf_counter()
        b = self._scatter(rhs_batch)
        x, iters, relres, resvec = self._solve_mp(b, tol)
        if self.mesh is not None:
            x = gather_field(self.mesh, x, self.local_lattice)
        self._sync()
        dt = self._wall(time.perf_counter() - t0)
        x_log = fast.spinor_from_soa(x, self.lattice).cpu().numpy()
        st = self.mg.stats
        total = max(int(iters.sum()), 1)
        infos = [SolveInfo(iterations=int(iters[i]), relres=float(relres[i]),
                           converged=bool(relres[i] < tol), solve_time=dt / B,
                           coarse_average=st["coarse_iterations"] / total,
                           coarse_matvec_average=st["coarse_matvecs"] / total,
                           coarsest_inverse_applies=st["coarsest_inverse_applies"] / B,
                           resvec=[float(rv[i]) for rv in resvec])
                 for i in range(B)]
        return x_log, infos

    def _solve_mp(self, b, tol):
        """Outer loop of every lane of b [B, 12, V]: once per restart the
        complex128 true residual of all lanes (one K1 apply at batch B),
        then one inner flexible-GCR restart of all lanes in the inner
        precision, each lane asked to reduce its residual by what remains
        to be done, but by no more than inner_tol_clip; lanes that have
        converged are masked off and keep their x.  The default clip is
        1e-5 for a complex64 inner solve (the reference's inner threshold
        MAX(tol, 1e-5), src/linsolve.c:44: an f32 sweep cannot verify a
        deeper reduction and stalls when asked to) and none for a
        complex128 inner solve, which then runs as one Krylov space like
        the reference's double-precision FGMRES.  Returns (x, iterations
        [B], relres [B], resvec: the relres of every restart)."""
        p = self.p
        if p.inner_tol_clip is not None:
            clip = float(p.inner_tol_clip)
        else:
            clip = 1e-5 if self._inner_dtype == torch.complex64 else 0.0
        norm_b = self._norms(b)
        norm_b = np.where(norm_b == 0, 1.0, norm_b)
        x = torch.zeros_like(b)
        iters = torch.zeros(b.shape[0], device=b.device)
        resvec = []
        for restart in range(p.max_restarts + 1):
            r = b if restart == 0 else b - self.apply_operator(x)
            nr = self._norms(r)
            relres = nr / norm_b
            resvec.append(relres)
            active = relres >= tol
            if not active.any() or restart == p.max_restarts:
                break
            rel_tol = np.maximum(tol * norm_b / np.maximum(nr, 1e-300), clip)
            z, it = self.mg.inner_restart(
                r.to(self._inner_dtype), torch.as_tensor(rel_tol, device=b.device),
                m=p.restart_length, active=torch.as_tensor(active, device=b.device))
            x = x + z.to(torch.complex128)
            iters = iters + it
        return x, iters.cpu().numpy().astype(int), relres, resvec

    def true_residual(self, x, rhs) -> float:
        """||rhs - D x|| / ||rhs|| in complex128 (the reference's
        FGMRES_RESTEST); x and rhs are global arrays."""
        b = self._scatter(rhs)
        r = b - self.apply_operator(self._scatter(x))
        return float(self._norms(r)[0] / self._norms(b)[0])
