"""Profiling and solve observability (reference PROFILING subsystem:
PROF_PRECISION_START/STOP macros src/main_pre_def_generic.h:101-122, kernel
class table src/init_generic.c:24-96, printout src/solver_analysis.c:65-89;
the JAX package's profiling.py).

Kernels run asynchronously on the card, so a host timer around a launch
measures the launch.  The profiler records
  * wall time per region, with torch.cuda.synchronize(device) at the
    region's exit when syncing is on (sync=True: one sync a region, which
    brackets a whole operator or preconditioner call);
  * call counts;
  * analytic flop counts from the reference's flop models
    (src/init_generic.c:58-68), so flop/s uses modelled work like the
    reference does.

    prof = Profiler(enabled=True)
    with prof.region("fine_op", level=0, flops=1920 * volume, device=v.device):
        eta = stencil.full_op(v)
    print(prof.table())

The module-level PROF is switched on by DDAAMG_PROFILE=1 or the cli's
--profile; api.Solver then times the fine operator and the preconditioner
of every solve, and the setup times its phases under the JAX package's
names and depths (mg/hierarchy._prof: "setup: initial tv smoothing",
"setup: gram schmidt", "setup: tv cycles (F-cycle)", "setup: P/Galerkin
rebuild", "setup: block inverses", "setup: coarsest dense inverse").
Switched off, nothing is wrapped: the solve and the setup run as without
the profiler, with no extra synchronization or launch.

Memory: hbm_highwater_mb is the caching allocator's high-water mark of a
card (torch.cuda.max_memory_allocated), solver_memory_mb a ledger of the
tensors a Solver holds (the reference's MALLOC ledger, src/main.h:88-140),
solve_memory_mb the first on a card and the second elsewhere.  The JAX
package's compile_time_tracker exists for XLA only; the port's counterpart
is the kernels' build time (kernels.build_seconds).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

# reference flop models per lattice site (src/init_generic.c:58-68)
FLOPS_FINE_SELF = 552          # clover (self-coupling)
FLOPS_FINE_NEIGHBOR = 1368     # hopping
FLOPS_FINE_FULL = FLOPS_FINE_SELF + FLOPS_FINE_NEIGHBOR


def flops_coarse_self(n2: int) -> int:
    """Coarse self-coupling flops a site; n2 = 2 * num_eig_vect."""
    return 8 * n2 * n2


def flops_coarse_neighbor(n2: int) -> int:
    return 8 * 8 * n2 * n2


def synchronize(device):
    """Wait for the card's work (nothing to wait for on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class _Entry:
    time: float = 0.0
    count: int = 0
    flops: float = 0.0


@dataclass
class Profiler:
    enabled: bool = False
    sync: bool = True
    entries: dict = field(default_factory=lambda: defaultdict(_Entry))

    def reset(self):
        self.entries.clear()

    @contextmanager
    def region(self, name: str, level: int = 0, flops: float = 0.0, device=None):
        """Time a region; with syncing on, the card `device` is synchronized
        at its exit."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if self.sync and device is not None:
            synchronize(device)
        self.add(name, level, time.perf_counter() - t0, flops)

    def add(self, name: str, level: int, dt: float, flops: float = 0.0,
            count: int = 1):
        if not self.enabled:
            return
        e = self.entries[(level, name)]
        e.time += dt
        e.count += count
        e.flops += flops

    def wrap(self, fn, name: str, flops_of, device, level: int = 0):
        """fn timed as region `name` at every call (flops_of(v) modelled
        flops of the call fn(v)); fn itself while the profiler is off."""
        if not self.enabled:
            return fn

        def timed(v):
            with self.region(name, level, flops_of(v), device):
                return fn(v)
        return timed

    def table(self) -> str:
        """Reference-style per-level profiling table
        (src/init_generic.c:84-96)."""
        if not self.entries:
            return "| profiling: no data |"
        rule = "+----------------------------------------------------------------------+"
        lines = [rule,
                 "| kernel (per level)              |   count |  time (s) |     GFLOP/s |",
                 rule]
        total_t = 0.0
        total_f = 0.0
        for (level, name), e in sorted(self.entries.items()):
            gfs = e.flops / e.time / 1e9 if e.time > 0 and e.flops else 0.0
            lines.append(f"| depth {level}: {name:<22s} | {e.count:7d} | {e.time:9.4f} |"
                         f" {gfs:11.2f} |")
            total_t += e.time
            total_f += e.flops
        lines.append(rule)
        gfs = total_f / total_t / 1e9 if total_t > 0 else 0.0
        lines.append(f"| total                           |         | {total_t:9.4f} |"
                     f" {gfs:11.2f} |")
        lines.append(rule)
        return "\n".join(lines)


def profile_hierarchy(mg, reps: int = 5, seed: int = 0) -> Profiler:
    """Per-level, per-kernel-class timing of a Multigrid hierarchy
    (reference prof_print table, src/init_generic.c:84-96 /
    src/solver_analysis.c:65-89), with the JAX package's rows and flops:
    the operator apply, the smoother, P^H and P, the coarsest GCR solve and
    one whole cycle (Multigrid._cycle at batch 1), each timed alone over
    `reps` calls on random fields after one untimed call, with a
    synchronization of the card before and after.  The stored inverses the
    options ask for are built before anything is timed.  Under a mesh every
    rank calls this (the calls hold collectives)."""
    from .smoothers.sap import sap_smooth

    prof = Profiler(enabled=True)
    rng = np.random.default_rng(seed)
    device = mg.fine.stencil.device
    mg._ensure_inverses()

    def rand_field(lvl):
        """A random field of the level in the JAX package's draw order
        (logical [T, Z, Y, X, dof], real then imaginary parts), this rank's
        slab of it on the level's device."""
        s = lvl.stencil
        shape = (*lvl.geom.lattice, s.field_shape[0])
        rdtype = torch.empty((), dtype=s.dtype).real.dtype
        re = torch.as_tensor(rng.normal(size=shape), dtype=rdtype)
        im = torch.as_tensor(rng.normal(size=shape), dtype=rdtype)
        v = s.from_logical(torch.complex(re, im)[None])[0]
        return s.slab(v).to(device)

    def timeit(fn, *args):
        fn(*args)                    # not timed: builds, first launches
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        synchronize(device)
        return (time.perf_counter() - t0) / reps

    levels = mg._levels()
    for lvl in levels:
        vol = int(np.prod(lvl.geom.lattice))
        v = rand_field(lvl)
        if lvl.depth == 0:
            op_flops = FLOPS_FINE_FULL * vol
        else:
            n2 = lvl.stencil.field_shape[0]
            op_flops = (flops_coarse_self(n2) + flops_coarse_neighbor(n2)) * vol
        prof.add("op_apply", lvl.depth, timeit(lvl.stencil.full_op, v), op_flops)

        if lvl.smoother is not None:
            sm = lvl.smoother
            dt = timeit(lambda w: sap_smooth(sm.s, sm.colors, w, sm.cycles,
                                             sm.block_iter, sm.odd_even), v)
            # reference SAP flop model (src/init_generic.c:63-68)
            prof.add("smoother (SAP)", lvl.depth, dt,
                     op_flops * (sm.block_iter + 2) * sm.cycles)

        if lvl.agg is not None and lvl.P is not None:
            n = lvl.agg.num_vectors
            pt_flops = 8 * lvl.agg.m * n * 2 * int(np.prod(lvl.agg.coarse_lattice))
            dt = timeit(lambda w: mg._restrict(lvl, w), v)
            prof.add("restrict (P^H)", lvl.depth, dt, pt_flops)
            vc = rand_field(lvl.next)
            dt = timeit(lambda w: mg._interpolate(lvl, w), vc)
            prof.add("interpolate (P)", lvl.depth, dt, pt_flops)

        if lvl.is_coarsest and lvl.depth > 0:
            b = rand_field(lvl)[None]
            saved, lvl.dense_inv = lvl.dense_inv, None     # the GCR, as the JAX row
            try:
                dt = timeit(lambda w: mg._coarsest_solve(lvl, w), b)
            finally:
                lvl.dense_inv = saved
            prof.add("coarsest solve (OE-GCR)", lvl.depth, dt, 0.0)

    eta = rand_field(levels[0])[None]
    ktol = mg._kcycle_tol(0, mg.cfg.kcycle_tol)
    prof.add("FULL CYCLE", 0, timeit(lambda w: mg._cycle(0, w, ktol), eta), 0.0)
    return prof


def hbm_highwater_mb(device) -> float:
    """The card's allocator high-water mark in MiB (reference memory
    accounting, src/main.h:88-140, printed in the solve summary,
    src/linsolve_generic.c:371); 0.0 off a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 2**20


def _tensors(x, seen: dict):
    """Every tensor reachable from x (tensors, sequences, dicts,
    dataclasses), each storage once, into seen {storage pointer: bytes}."""
    if isinstance(x, torch.Tensor):
        st = x.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, seen)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, seen)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _tensors(getattr(x, f.name), seen)


def solver_memory_mb(solver) -> float:
    """A ledger in MiB of the tensors a Solver holds: the operator and its
    slab, the complex128 outer stencil and the inner one, and on every
    level the stencil and its bf16 copy, P, the test vectors, the stored
    inverses and the smoother's masks and block lists; a preconditioner
    without multigrid its stencil and masks."""
    seen: dict = {}
    _tensors([solver.op, solver._op_slab, solver.outer, solver._inner], seen)
    mg = solver.mg
    if mg is not None:
        for lvl in mg._levels():
            _tensors([lvl.stencil, lvl.cycle_stencil, lvl.P, lvl.test_vectors,
                      lvl.dense_inv, lvl.block_inv], seen)
            if lvl.smoother is not None:
                _tensors([lvl.smoother.colors, lvl.smoother.blocks], seen)
    elif solver.preconditioner is not None:
        prec = solver.preconditioner
        _tensors([getattr(prec, "s", None), getattr(prec, "colors", None)], seen)
    return sum(seen.values()) / 2**20


def solve_memory_mb(solver) -> float:
    """The allocator's high-water mark on a card, the ledger elsewhere."""
    mb = hbm_highwater_mb(solver.device)
    return mb if mb > 0.0 else solver_memory_mb(solver)


PROF = Profiler(enabled=bool(os.environ.get("DDAAMG_PROFILE")))
