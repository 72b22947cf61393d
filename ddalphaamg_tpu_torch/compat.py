"""Embedding API shaped like the reference C library
(src/dd_alpha_amg.h:29-90, dd_alpha_amg_parameters.h,
dd_alpha_amg_setup_status.h; the JAX package's compat.py), on an api.Solver
of the port:

    from ddalphaamg_tpu_torch import compat as amg
    par = amg.dd_alpha_amg_par(param_file_path="sample.ini", m0=-0.5, csw=1.0)
    amg.dd_alpha_amg_init(par)                  # on the card (device="cuda")
    plaq = amg.dd_alpha_amg_set_conf(U)         # U [4,T,Z,Y,X,3,3] numpy
    amg.dd_alpha_amg_setup(iterations=4)
    x, relres, status = amg.dd_alpha_amg_wilson_solve(b, tol=1e-10)
    amg.dd_alpha_amg_free()

Reference features with no meaning here: the external-threading variants
(the plain entry points are their equivalents), the conf_index_fct /
vector_index_fct layout callbacks (pass arrays in the documented layouts;
`bc` replaces the boundary handling the callbacks fed) and
get_gauge_pointer / get_clover_pointer (use dd_alpha_amg_set_conf and
dd_alpha_amg_fields_updated).

The setup mass and the clover scaling act on what the port's solve reads,
which the JAX package's Solver.op swap does on its CPU path: a setup at
another mass builds the hierarchy from the shifted operator slab
(Solver._op_slab) while the complex128 outer stencil keeps the solve mass;
a scaled solve runs its outer loop (Solver.outer, and the inner-precision
stencil of the methods without multigrid) on the clover-scaled operator,
while the preconditioner keeps what its setup built.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import api
from .config import DepthParams, SolverParams, parse_ini
from .operators.stencil import WilsonStencilSoA, shift_stencil
from .operators.wilson import WilsonOperator, shift_diagonal
from .parallel.mesh import shard_operator

MAX_MG_LEVELS = 4

_BC_DIRICHLET, _BC_PERIODIC, _BC_ANTI_PERIODIC = 0, 1, 2


@dataclasses.dataclass
class dd_alpha_amg_parameters:
    """Mirror of dd_alpha_amg_parameters.h:26-51."""
    number_of_levels: int = 2
    global_lattice: Optional[list] = None        # [level][4]
    block_lattice: Optional[list] = None
    mg_basis_vectors: Optional[list] = None      # per level
    setup_iterations: Optional[list] = None
    discard_setup_after: int = 10**9
    update_setup_iterations: Optional[list] = None
    update_setup_after: int = 10**9
    post_smooth_iterations: Optional[list] = None
    post_smooth_block_iterations: Optional[list] = None
    coarse_grid_iterations: int = 100
    coarse_grid_maximum_number_of_restarts: int = 5
    coarse_grid_tolerance: float = 5e-2
    # None = from the parameter file (see dd_alpha_amg_par)
    solver_mass: Optional[float] = None
    setup_mass: Optional[float] = None
    c_sw: Optional[float] = None


@dataclasses.dataclass
class dd_alpha_amg_par:
    """Mirror of the init struct (src/dd_alpha_amg.h:29-39)."""
    param_file_path: str = ""
    bc: int = _BC_ANTI_PERIODIC
    # None = from the parameter file; a value overrides it (the reference
    # struct has no unset state, but a concrete default here would silently
    # replace the file's m0 / csw)
    m0: Optional[float] = None
    csw: Optional[float] = None
    setup_m0: Optional[float] = None
    amg_params: Optional[dd_alpha_amg_parameters] = None


@dataclasses.dataclass
class dd_alpha_amg_setup_status:
    """Mirror of dd_alpha_amg_setup_status.h:25-28."""
    gauge_updates_since_last_setup: int = 10**9
    gauge_updates_since_last_setup_update: int = 10**9


_solver: Optional[api.Solver] = None
_par: Optional[dd_alpha_amg_par] = None
_status = dd_alpha_amg_setup_status()
_mass_for_next_solve: Optional[float] = None
# the hierarchy's mass minus the solve mass after a setup at a setup mass
_setup_shift: float = 0.0


def _params_from(par: dd_alpha_amg_par) -> SolverParams:
    if par.param_file_path:
        p = parse_ini(par.param_file_path)
    else:
        p = SolverParams()
        p.depth = []
    a = par.amg_params
    if a is not None:
        p.num_levels = a.number_of_levels
        while len(p.depth) < p.num_levels:
            p.depth.append(DepthParams())
        for i in range(p.num_levels):
            d = p.depth[i]
            if a.global_lattice:
                d.global_lattice = tuple(a.global_lattice[i])
            if a.block_lattice:
                d.block_lattice = tuple(a.block_lattice[i])
            if a.mg_basis_vectors:
                d.test_vectors = a.mg_basis_vectors[i]
            if a.setup_iterations:
                d.setup_iter = a.setup_iterations[i]
            if a.post_smooth_iterations:
                d.post_smooth_iter = a.post_smooth_iterations[i]
            if a.post_smooth_block_iterations:
                d.block_iter = a.post_smooth_block_iterations[i]
        p.coarse_iter = a.coarse_grid_iterations
        p.coarse_restart = a.coarse_grid_maximum_number_of_restarts
        p.coarse_tol = a.coarse_grid_tolerance
        if a.solver_mass is not None:
            p.m0 = a.solver_mass
        if a.c_sw is not None:
            p.csw = a.c_sw
    p.m0 = par.m0 if par.m0 is not None else p.m0
    p.csw = par.csw if par.csw is not None else p.csw
    p.anti_pbc = par.bc == _BC_ANTI_PERIODIC
    p.bc = par.bc
    return p.validate()


def dd_alpha_amg_init(par: dd_alpha_amg_par, device="cuda") -> None:
    """A Solver from the parameters on `device` (the card unless the caller
    asks for the CPU)."""
    global _solver, _par, _setup_shift
    _par = par
    _setup_shift = 0.0
    _solver = api.Solver(_params_from(par), device=device)


def dd_alpha_amg_update_parameters(amg_params: dd_alpha_amg_parameters) -> None:
    """Live parameter update (reference src/init.c:1139-1182); takes effect
    at the next setup, as in the reference."""
    assert _par is not None, "call dd_alpha_amg_init first"
    _par.amg_params = amg_params
    _solver.p = _params_from(_par)


def dd_alpha_amg_set_conf(gauge_field) -> float:
    """Store links (row-major SU(3), [4,T,Z,Y,X,3,3]); returns the plaquette."""
    assert _solver is not None, "call dd_alpha_amg_init first"
    plaq = _solver.set_conf(np.asarray(gauge_field))
    dd_alpha_amg_fields_updated()
    return plaq


def dd_alpha_amg_fields_updated() -> None:
    """Gauge / clover changed outside: bump the staleness counters
    (src/dd_alpha_amg.h:51-59)."""
    _status.gauge_updates_since_last_setup += 1
    _status.gauge_updates_since_last_setup_update += 1


@contextlib.contextmanager
def _setup_at(delta: float):
    """The Solver's operator and its slab shifted by delta while the block
    runs (a setup at the setup mass), then restored; the outer stencil keeps
    the solve mass.  A preconditioner without multigrid is built from the
    inner-precision stencil, or in complex128 from the outer one: for the
    block both are built from the shifted slab."""
    s = _solver
    saved = (s.op, s._op_slab, s.outer)
    s.op = shift_diagonal(s.op, delta)
    s._op_slab = s.op if s.mesh is None else shift_diagonal(s._op_slab, delta)
    s._inner = None
    if not s.multigrid:
        s.outer = WilsonStencilSoA.build(s._op_slab, s._geom(), dtype=torch.complex128,
                                         mesh=s.mesh)
    try:
        yield
    finally:
        s.op, s._op_slab, s.outer = saved
        s._inner = None          # rebuilt at the solve mass when needed


def dd_alpha_amg_setup(iterations: Optional[int] = None) -> dict:
    """Build the preconditioner; at setup_m0 (or amg_params.setup_mass)
    where one is given and differs from m0 (reference g.setup_m0,
    src/dd_alpha_amg.c:258-321), while the solves keep m0."""
    global _setup_shift
    assert _solver is not None
    if iterations is not None:
        for d in _solver.p.depth:
            d.setup_iter = iterations
    a = _par.amg_params if _par is not None else None
    sm = None
    if _par is not None and _par.setup_m0 is not None:
        sm = _par.setup_m0
    elif a is not None and a.setup_mass is not None:
        sm = a.setup_mass
    if sm is not None and sm != _solver.p.m0 and _solver.op is not None:
        with _setup_at(sm - _solver.p.m0):
            _solver.setup()
        _setup_shift = sm - _solver.p.m0
    else:
        _solver.setup()
        _setup_shift = 0.0
    _status.gauge_updates_since_last_setup = 0
    _status.gauge_updates_since_last_setup_update = 0
    return {"setup_time": _solver.status.setup_time}


def dd_alpha_amg_setup_update(iterations: int = 1) -> dict:
    assert _solver is not None
    _solver.update_setup(iterations)
    _status.gauge_updates_since_last_setup_update = 0
    return {"setup_time": _solver.status.setup_time}


def _shift_update(m0: float):
    """Solver.shift_update to m0.  It rebuilds the fine level from the
    solve-mass operator; after a setup at a setup mass the fine level is
    rebuilt at that mass moved alike, as the JAX package shifts every level
    by the same delta."""
    s = _solver
    delta = m0 - s.p.m0
    s.shift_update(m0)
    if _setup_shift and s.mg is not None:
        fine = s.mg.fine
        s._mg_op = shift_diagonal(s._op_slab, _setup_shift)
        fine.stencil = shift_stencil(fine.stencil, delta, s._mg_op)
        fine.smoother.replace_stencil(fine.stencil)


def run_dd_alpha_amg_setup_if_necessary() -> None:
    """Staleness-counter driven re-setup (src/dd_alpha_amg.c:85-93): a full
    setup after discard_setup_after gauge updates, a setup update after
    update_setup_after, and a shift update when the next solve's mass
    moved."""
    global _mass_for_next_solve
    assert _solver is not None and _par is not None
    a = _par.amg_params or dd_alpha_amg_parameters()
    if _status.gauge_updates_since_last_setup >= a.discard_setup_after:
        dd_alpha_amg_setup()
    elif _status.gauge_updates_since_last_setup_update >= a.update_setup_after:
        dd_alpha_amg_setup_update()
    if _mass_for_next_solve is not None and _mass_for_next_solve != _solver.p.m0:
        _shift_update(_mass_for_next_solve)
        _mass_for_next_solve = None


def dd_alpha_amg_set_mass_for_next_solve(m0: float) -> None:
    global _mass_for_next_solve
    _mass_for_next_solve = m0


@contextlib.contextmanager
def _scaled_clover(scale_even: float, scale_odd: float):
    """The clover of even / odd sites scaled while the block runs (reference
    scale_clover, src/dirac.c:646-668): the operator, its slab and the
    complex128 outer stencil are those of the scaled clover, the
    inner-precision stencil is rebuilt from them where a method asks for
    it; all are restored afterwards.  The hierarchy is not rescaled."""
    if scale_even == 1.0 and scale_odd == 1.0:
        yield
        return
    s = _solver
    saved = (s.op, s._op_slab, s.outer, s._inner)
    op = s.op
    parity = np.indices(op.lattice).sum(axis=0) % 2
    factor = torch.as_tensor(np.where(parity == 0, scale_even, scale_odd),
                             dtype=op.clover.real.dtype, device=op.clover.device)
    s.op = WilsonOperator(op.links, op.clover * factor[..., None, None, None])
    s._op_slab = s.op if s.mesh is None else shard_operator(s.mesh, s.op)
    s.outer = WilsonStencilSoA.build(s._op_slab, s._geom(), dtype=torch.complex128,
                                     mesh=s.mesh)
    s._inner = None
    try:
        yield
    finally:
        s.op, s._op_slab, s.outer, s._inner = saved


def dd_alpha_amg_wilson_solve(vector_in, tol: float = 1e-10, scale_even: float = 1.0,
                              scale_odd: float = 1.0):
    """Returns (vector_out, relres, status dict) -- reference
    dd_alpha_amg_wilson_solve (src/dd_alpha_amg.c:324)."""
    assert _solver is not None
    run_dd_alpha_amg_setup_if_necessary()
    with _scaled_clover(scale_even, scale_odd):
        x, info = _solver.solve(np.asarray(vector_in), tol=tol)
    status = {"iterations": info.iterations,
              "coarse_iterations": info.coarse_average * max(1, info.iterations)}
    return x, info.relres, status


def dd_alpha_amg_preconditioner(vector_in, scale_even: float = 1.0,
                                scale_odd: float = 1.0):
    assert _solver is not None
    with _scaled_clover(scale_even, scale_odd):
        return np.asarray(_solver.apply_preconditioner(np.asarray(vector_in)))


def dd_alpha_amg_free() -> None:
    global _solver, _par, _mass_for_next_solve, _setup_shift
    _solver = None
    _par = None
    _mass_for_next_solve = None
    _setup_shift = 0.0
    _status.gauge_updates_since_last_setup = 10**9
    _status.gauge_updates_since_last_setup_update = 10**9
