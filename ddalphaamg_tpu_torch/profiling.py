"""Profiling, tracing and solve observability (reference PROFILING
subsystem: PROF_PRECISION_START/STOP macros src/main_pre_def_generic.h:
101-122, kernel class table src/init_generic.c:24-96, printout
src/solver_analysis.c:65-89; the JAX package's profiling.py).

Kernels run asynchronously on the card, so a host timer around a launch
measures the launch.  The port's one tracer is PROF, a Profiler, at one of
four levels, each adding to the one before:

1. OFF, the default: nothing is wrapped.  Every call site asks PROF.on (or
   PROF.marks) first, through span() and site() below, and runs as without
   the tracer: no event, range, mark or counter.
2. SPANS: spans and counters, with no synchronization.  A span records its
   name, its depth (the multigrid depth it works at), its host start and
   end (perf_counter_ns), its parent and its request.  Every
   Solver.solve_multi and Solver.setup is one request, one in-memory
   record.  The spans are the port's own boundaries: the request
   ("solve_multi", "setup"); "scatter", every "outer iteration" of the
   outer loop with its complex128 "residual", every host read of the
   device ("read norms", "read counters", "read iterations"), "gather";
   every device program's "replay <class>" and "capture <class>" at its
   depth; the setup's six phases (mg/hierarchy._prof) and the solve hooks
   of the fine operator and the preconditioner (wrap), which are also the
   rows of table(), as is the inner restart's replay (the programs' row).
   Each replay and each row is timed on the card by a
   pair of CUDA events, read once at the request's end, after the
   synchronization solve_multi and setup already make (outside a request:
   at report() or table()); on the CPU by the host clock.  Counters:
   replays, captures and their seconds, the graph pools' peak bytes, host
   reads of the device, empty_cache calls made by a capture, and each
   request's kernel launches by family (kernels.counts() since the last
   request's end); chip_smoke.py prints them for its setups and first
   solves.
3. RANGES: every span is also a torch.profiler.record_function range
   "ddaamg:<span>", on the profiler's clock, which is the device trace's,
   so a profile puts each idle gap on the innermost port span open on the
   host.
4. MARKS: device marks (csrc/mark.cu).  Every port kernel launch (kernels.
   launched / kernels.check), every call site of the cycle (site(): the
   residual, the restriction, the coarsest solve or the K-cycle GCR, the
   interpolation and add, the SAP smoother, the fine GCR's own step) and
   the outer complex128 residual is bracketed by two one-thread mark
   kernels, which add the elapsed nanoseconds (%globaltimer) and one pass
   to the table row of (site path, family).  Captured into the programs'
   loop bodies, the rows accumulate over every pass of every replay; the
   host reads the table once, at report().  A program captured at another
   level holds no mark: the Multigrid recaptures a program whose marks
   differ from the level, one of a kind, the old one dropped first.  On the
   CPU, where the tests' stand-in capture replays on the host, the marks
   time the host (not while a capture runs, as a capture runs nothing).
   mark_split gives each section's time: a bracket's elapsed time less the
   marks' own cost (an empty section's, measured at report()); a section's
   "torch" time is what is left of it after the brackets inside it.

DDAAMG_PROFILE set (any value but 3 or 4) or the cli's --profile: level 2;
DDAAMG_PROFILE=3 or 4: that level; set_level sets any, `enabled` is level
>= 2.

    prof = Profiler(enabled=True)
    with prof.region("fine_op", level=0, flops=1920 * volume, device=v.device):
        eta = stencil.full_op(v)
    print(prof.table())

table() is the reference's per-level table of the rows: call counts,
device seconds, and analytic flop counts from the reference's flop models
(src/init_generic.c:58-68), so flop/s uses modelled work like the
reference does.

Memory: hbm_highwater_mb is the caching allocator's high-water mark of a
card (torch.cuda.max_memory_allocated), solver_memory_mb a ledger of the
tensors a Solver holds (the reference's MALLOC ledger, src/main.h:88-140),
solve_memory_mb the first on a card and the second elsewhere.  The JAX
package's compile_time_tracker exists for XLA only; the port's counterpart
is the kernels' build time (kernels.build_seconds).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import Counter, defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# reference flop models per lattice site (src/init_generic.c:58-68)
FLOPS_FINE_SELF = 552          # clover (self-coupling)
FLOPS_FINE_NEIGHBOR = 1368     # hopping
FLOPS_FINE_FULL = FLOPS_FINE_SELF + FLOPS_FINE_NEIGHBOR

OFF, SPANS, RANGES, MARKS = 1, 2, 3, 4
RANGE_PREFIX = "ddaamg:"
TIMED = ("replay", "row")       # the span kinds timed by CUDA events
SECTION = "section"             # a marked call site's family in the marks' table
MARK_SLOTS = 4096               # rows of the marks' table
CALIBRATION_MARKS = 256         # empty sections the marks' own cost is read from
NULL = contextlib.nullcontext()


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


def span(name: str, depth: int = 0, kind: str = "", device=None):
    """PROF's span at a call site of the port; nothing below level 2."""
    return PROF.span(name, depth, kind, device) if PROF.on else NULL


def site(name: str, depth: int):
    """PROF's marked section of a call site at multigrid depth `depth`;
    nothing below level 4."""
    return PROF.site(f"{name} d{depth}") if PROF.marks else NULL


@dataclass
class _Entry:
    time: float = 0.0
    count: int = 0
    flops: float = 0.0


class Span:
    """One span (module note); device_s: its CUDA events' seconds (the host
    clock's on the CPU) for the timed kinds, else None."""

    __slots__ = ("name", "depth", "kind", "start_ns", "end_ns", "parent", "request",
                 "device_s", "flops", "row", "events", "range")
    FIELDS = ("name", "depth", "kind", "start_ns", "end_ns", "parent", "request", "device_s")

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.FIELDS}


class _Marks:
    """The device marks' table (level 4) on `device`: MARK_SLOTS rows
    [elapsed ns, passes, open mark's start ns] by (site path, family),
    written by csrc/mark.cu on a card and by the host on the CPU.  Slots
    stay assigned for the table's life: captured graphs hold them (row 0:
    the calibration's)."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.table = (torch.zeros((MARK_SLOTS, 3), dtype=torch.long, device=device)
                      if self.cuda else np.zeros((MARK_SLOTS, 3), np.int64))
        self.slots = {("", "calibration"): 0}
        self.cost_ns = None

    def slot(self, path: str, family: str) -> int:
        s = self.slots.get((path, family))
        if s is None:
            s = self.slots[(path, family)] = len(self.slots)
            if s >= MARK_SLOTS:
                raise RuntimeError(f"the marks' table holds {MARK_SLOTS} rows")
        return s

    def mark(self, slot: int, end: int):
        if self.cuda:
            from . import kernels
            rc = kernels.lib().ddaamg_mark(self.table.data_ptr(), slot, end,
                                           kernels.stream_ptr(self.device))
            if rc != 0:
                raise RuntimeError(f"mark: CUDA launch failed with error {rc}")
            return
        row, t = self.table[slot], time.perf_counter_ns()
        if end:
            row[0] += t - row[2]
            row[1] += 1
        else:
            row[2] = t

    def zero(self):
        self.table[:] = 0

    def rows(self) -> list:
        """[(path, family, passes, elapsed ns)] of every row with a pass
        (one read of the device)."""
        t = self.table.cpu().numpy() if self.cuda else self.table
        return [(path, fam, int(t[s, 1]), int(t[s, 0])) for (path, fam), s in self.slots.items()
                if s and t[s, 1]]

    def calibrate(self) -> float:
        """The marks' own cost: an empty section's elapsed ns, the mean of
        CALIBRATION_MARKS of them in one CUDA graph replayed after a warm
        replay (on the CPU: on the host)."""
        if self.cost_ns is not None:
            return self.cost_ns

        def empty(_ctl=None):
            for _ in range(CALIBRATION_MARKS):
                self.mark(0, 0)
                self.mark(0, 1)

        if self.cuda:
            from . import kernels
            from .solvers.cuda_graph import CudaGraph

            g = CudaGraph(self.device)
            g.capture(empty)
            stream = torch.cuda.current_stream(self.device).cuda_stream
            try:
                for _ in range(2):
                    self.table[0] = 0
                    if kernels.lib().ddaamg_graph_launch(g.handle, stream) != 0:
                        raise RuntimeError("the marks' calibration graph failed to launch")
                row = self.table[0].tolist()
            finally:
                g.close()
        else:
            self.table[0] = 0
            empty()
            row = self.table[0].tolist()
        self.table[0] = 0
        self.cost_ns = row[0] / max(row[1], 1)
        return self.cost_ns


def mark_split(rows, cost_ns: float) -> dict:
    """The marks' rows [(path, family, passes, ns)] as times: every port
    kernel family's ns (each bracket less cost_ns, the marks' own cost),
    every section's (its ns less its marks' cost, the port kernels inside
    it by family, and its "torch" ns: what is left after every bracket
    directly inside it, each with the one transition its marks add outside
    it), and the sum of the sections' torch ns."""
    families, sections = Counter(), {}
    inner = Counter()           # the brackets directly inside a section path
    for path, fam, n, ns in rows:
        if fam == SECTION:
            sections[path] = {"passes": n, "ns": ns - cost_ns * n, "kernels": {}}
            parent = path.rpartition("/")[0]
        else:
            families[fam] += ns - cost_ns * n
            parent = path
        inner[parent] += ns + cost_ns * n
    for path, fam, n, ns in rows:
        if fam != SECTION and path in sections:
            sections[path]["kernels"][fam] = ns - cost_ns * n
    for path, sec in sections.items():
        sec["torch_ns"] = sec["ns"] - inner[path]
    return {"families": dict(families), "sections": sections,
            "torch_ns": sum(sec["torch_ns"] for sec in sections.values())}


class Profiler:
    """The tracer (module note) at `level` (enabled=True: SPANS).  Its
    rows, entries[(depth, name)], make table()."""

    def __init__(self, enabled: bool = False, level: Optional[int] = None):
        self.entries = defaultdict(_Entry)
        self.level, self.on, self.ranges, self.marks = OFF, False, False, False
        self._marks = None
        self._events = []           # CUDA event pairs read and free for reuse
        self.reset()
        self.set_level(level if level is not None else SPANS if enabled else OFF)

    @property
    def enabled(self) -> bool:
        return self.on

    @enabled.setter
    def enabled(self, on: bool):
        self.set_level(SPANS if on else OFF)

    def set_level(self, level: int, device=None):
        """Switch to `level`; MARKS keeps its table on `device` (the current
        card by default, else the CPU)."""
        from . import kernels

        if level not in (OFF, SPANS, RANGES, MARKS):
            raise ValueError(f"no tracing level {level}")
        if level >= MARKS:
            dev = torch.device(device if device is not None
                               else "cuda" if torch.cuda.is_available() else "cpu")
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            if self._marks is None or self._marks.device != dev:
                self._marks = _Marks(dev)
            kernels.tracer = self
        elif kernels.tracer is self:
            kernels.tracer = None
        self.level = level
        self.on, self.ranges, self.marks = level >= SPANS, level >= RANGES, level >= MARKS

    def reset(self):
        """Forget every request, span, row and counter, and zero the marks."""
        self.entries.clear()
        self.requests, self.loose, self.counters = [], [], Counter()
        self._open, self._pending, self._sites = [], [], []
        self._request = self._launches = self._kernel = None
        self._captures = 0
        if self._marks is not None:
            self._marks.zero()

    # -- spans and requests ------------------------------------------------

    @contextmanager
    def span(self, name: str, depth: int = 0, kind: str = "", device=None,
             flops: float = 0.0, row: str = ""):
        """One span of `kind` ("replay", "capture", "read", "row", or "") on
        `device` (the timed kinds take CUDA events on a card); a "row" span,
        and a replay given a `row`, is also row `row` of table() at its
        depth."""
        sp = Span()
        sp.name, sp.depth, sp.kind, sp.flops = name, depth, kind, flops
        sp.row = row or (name if kind == "row" else "")
        sp.device_s = sp.events = sp.range = None
        rec = self._request
        spans = self.loose if rec is None else rec["spans"]
        parent = self._open[-1] if self._open else None
        sp.parent = parent[1] if parent is not None and parent[2] is spans else -1
        sp.request = None if rec is None else rec["id"]
        self._open.append((sp, len(spans), spans))
        spans.append(sp)
        if self.ranges:
            sp.range = torch.profiler.record_function(RANGE_PREFIX + name)
            sp.range.__enter__()
        if kind == "capture":
            self._captures += 1
        sp.start_ns = time.perf_counter_ns()
        if kind in TIMED and device is not None and torch.device(device).type == "cuda":
            sp.events = self._events.pop() if self._events else (
                torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            sp.events[0].record()
        try:
            yield sp
        finally:
            self._close(sp)

    def _close(self, sp: Span):
        if sp.events is not None:
            sp.events[1].record()
            self._pending.append(sp)
        sp.end_ns = time.perf_counter_ns()
        if sp.range is not None:
            sp.range.__exit__(None, None, None)
            sp.range = None
        self._open.pop()
        host_s = (sp.end_ns - sp.start_ns) / 1e9
        if sp.kind in TIMED and sp.events is None:
            sp.device_s = host_s
        if sp.kind == "replay":
            self.counters["replays"] += 1
        elif sp.kind == "capture":
            self._captures -= 1
            self.counters["captures"] += 1
            self.counters["capture seconds"] += host_s
        elif sp.kind == "read":
            self.counters["host reads"] += 1
        if sp.row:
            e = self.entries[(sp.depth, sp.row)]
            e.count += 1
            e.flops += sp.flops
            if sp.events is None:
                e.time += host_s

    def _resolve(self):
        """Read the pending spans' CUDA events (recorded before the caller's
        synchronization, so no wait), and keep them for reuse."""
        if self._pending:
            self._pending[-1].events[1].synchronize()
        for sp in self._pending:
            sp.device_s = sp.events[0].elapsed_time(sp.events[1]) / 1e3
            self._events.append(sp.events)
            sp.events = None
            if sp.row:
                self.entries[(sp.depth, sp.row)].time += sp.device_s
        self._pending = []

    @contextmanager
    def request(self, kind: str, rhs: int = 0):
        """One request (a solve_multi of `rhs` right-hand sides, a setup):
        its spans, counters and kernel launches in one record, its events
        read at its end, after the caller's synchronization."""
        from . import kernels

        if self._launches is None:
            self._launches = kernels.counts()
        rec = {"id": len(self.requests), "kind": kind, "rhs": rhs, "spans": []}
        before = Counter(self.counters)
        self._request = rec
        try:
            with self.span(kind):
                yield rec
        finally:
            self._request = None
            self._resolve()
            now = kernels.counts()
            rec["launches"] = {k: n - self._launches.get(k, 0) for k, n in now.items()}
            self._launches = now
            rec["counters"] = {k: v if k == "peak pool bytes" else v - before.get(k, 0)
                               for k, v in self.counters.items()}
            self.requests.append(rec)

    # -- device marks (level 4) ---------------------------------------------

    def _mark(self, slot: int, end: int):
        if self._marks.cuda or not self._captures:
            self._marks.mark(slot, end)

    @contextmanager
    def site(self, name: str):
        """The marked section `name` inside the sections open now."""
        self._sites.append(name)
        slot = self._marks.slot("/".join(self._sites), SECTION)
        self._mark(slot, 0)
        try:
            yield
        finally:
            self._mark(slot, 1)
            self._sites.pop()

    def kernel_begin(self, key: str):
        """Open the mark of a launch of port kernel `key` (kernels.launched)."""
        self._kernel = self._marks.slot("/".join(self._sites), key)
        self._mark(self._kernel, 0)

    def kernel_end(self):
        """Close the open launch's mark, if any (kernels.check)."""
        if self._kernel is not None:
            slot, self._kernel = self._kernel, None
            self._mark(slot, 1)

    # -- results -------------------------------------------------------------

    def report(self) -> dict:
        """Every request's record since reset (its spans as dicts, counters
        and launches), the spans outside requests, the counters, and, once
        marks ran, their rows, own cost and mark_split (one read of the
        table)."""
        self._resolve()
        out = {"level": self.level, "counters": dict(self.counters),
               "requests": [dict(r, spans=[sp.as_dict() for sp in r["spans"]])
                            for r in self.requests],
               "spans": [sp.as_dict() for sp in self.loose], "marks": None}
        rows = self._marks.rows() if self._marks is not None else []
        if rows:
            cost = self._marks.calibrate()
            out["marks"] = dict(mark_split(rows, cost), cost_ns=cost, rows=rows)
        return out

    @contextmanager
    def region(self, name: str, level: int = 0, flops: float = 0.0, device=None):
        """A row of table() at depth `level`, timed on `device` (CUDA events
        on a card, the host clock elsewhere); nothing while off."""
        if not self.on:
            yield
            return
        with self.span(name, level, "row", device, flops):
            yield

    def add(self, name: str, level: int, dt: float, flops: float = 0.0,
            count: int = 1):
        if not self.on:
            return
        e = self.entries[(level, name)]
        e.time += dt
        e.count += count
        e.flops += flops

    def wrap(self, fn, name: str, flops_of, device, level: int = 0):
        """fn timed as row `name` at every call (flops_of(v) modelled
        flops of the call fn(v)); fn itself while the profiler is off."""
        if not self.on:
            return fn

        def timed(v):
            with self.region(name, level, flops_of(v), device):
                return fn(v)
        return timed

    def table(self) -> str:
        """Reference-style per-level profiling table
        (src/init_generic.c:84-96) of the rows, device seconds."""
        self._resolve()
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


PROF = Profiler(level={"": OFF, "3": RANGES, "4": MARKS}.get(
    os.environ.get("DDAAMG_PROFILE", ""), SPANS))
