"""The port's own tracer in a --trace 1 run (ddalphaamg_tpu_torch/profiling.py:
PROF at levels 2-4), beside trace.py's profile from outside the port.

1. Level 2 (spans and counters, CUDA events around every replay, no
   synchronization) from before the solver is built; the records are
   emptied after the warm-up and reported right after the window: every
   request's replay device seconds, its right-hand sides, its launches.
2. After the window and trace.py's host-loop rerun, the window's first
   request twice more:
   a. at level 3 under torch.profiler: the spans are ranges "ddaamg:<span>"
      on the profiler's clock, so each idle gap of the device goes to the
      innermost port span open on the host.  Busy: the kernels, copies and
      sets the profiler sees, and the device-side ranges of the replays
      (it sees no kernel inside a replay's loops); no other "ddaamg:" range
      counts as busy;
   b. at level 4: the device marks of every port kernel launch and cycle
      call site, captured into the programs, which the Multigrid captures
      again for it (a first run, not reported): the replayed path's device
      time by call site and kernel family (profiling.mark_split).

ProgramTrace does nothing where the port has no PROF.report() (a tree before
the tracer): reruns() then returns None, and every metric that reads it
too.
The harness calls it, in run_cell: ProgramTrace(device) before api.Solver,
warmed_up() after the warm-up, window_done() after the window, and
record["program"] = reruns(first request, its right-hand sides).
"""

from __future__ import annotations

import torch

from .trace import _innermost, _union

RANGE = "ddaamg:"
REPLAY = RANGE + "replay "
# the spans whose time is the outer loop's own host code (an outer
# iteration outside its replays, reads, scatter and gather)
OUTER_OWN = ("outer iteration", "residual", "fine_op (d_plus_clover)", "scatter", "gather",
             "read norms", "read counters", "read iterations")
COARSE = ("K4", "K4-bf16", "K5", "K5-bf16", "K4-schur")


def _tracer():
    try:
        from ddalphaamg_tpu_torch import profiling
    except ImportError:
        return None, None
    prof = getattr(profiling, "PROF", None)
    if prof is None or not hasattr(prof, "report") or not hasattr(prof, "set_level"):
        return None, None
    return profiling, prof


def window_summary(rep: dict) -> dict:
    """A level-2 report's solve requests: each one's right-hand sides,
    replay device seconds (CUDA events), host seconds, and the launches,
    counters of them all."""
    reqs = [r for r in rep["requests"] if r["kind"] == "solve_multi"]
    launches, counters = {}, {}
    for r in reqs:
        for table, src in ((launches, r["launches"]), (counters, r["counters"])):
            for k, v in src.items():
                table[k] = table.get(k, 0) + v
    return dict(rhs=[r["rhs"] for r in reqs],
                replay_s=[sum(sp["device_s"] or 0.0 for sp in r["spans"]
                              if sp["kind"] == "replay") for r in reqs],
                request_s=[(r["spans"][0]["end_ns"] - r["spans"][0]["start_ns"]) / 1e9
                           for r in reqs],
                launches=launches, counters=counters)


def idle_by_span(events, rhs: int) -> dict:
    """A level-3 profile's events of one request (torch.profiler's
    FunctionEvents): its span (the "ddaamg:solve_multi" host range), the
    device's busy seconds in it (kernels, copies, sets, replays' ranges),
    and its idle seconds by the innermost port span open on the host."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        r = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(RANGE) or e.name.startswith(REPLAY):
                device.append(r)
        elif e.name.startswith(RANGE):
            host.append((*r, e.name[len(RANGE):]))
    reqs = [s for s in host if s[2] == "solve_multi"]
    if not reqs:
        return None
    w0, w1 = min(s[0] for s in reqs), max(s[1] for s in reqs)
    busy = _union(sorted((max(a, w0), min(b, w1)) for a, b in device if b > w0 and a < w1))
    idle = {}
    pieces = _innermost(host, w0, w1)
    for a, b in zip([w0] + [iv[1] for iv in busy], [iv[0] for iv in busy] + [w1]):
        for p0, p1, name in pieces:
            lo, hi = max(a, p0), min(b, p1)
            if hi > lo:
                idle[name] = idle.get(name, 0.0) + (hi - lo) / 1e6
    return dict(rhs=rhs, span_s=(w1 - w0) / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6,
                idle_s=idle, outer_idle_s=sum(v for k, v in idle.items() if k in OUTER_OWN))


def marks_summary(rep: dict, rhs: int) -> dict:
    """A level-4 report of one request: its replay device seconds and
    launches, and the marks' split in seconds (coarse: K4 / K4-bf16 / K5 /
    K5-bf16 / K4-schur; torch: the sections' own time)."""
    (req,) = [r for r in rep["requests"] if r["kind"] == "solve_multi"]
    marks = rep["marks"] or {"families": {}, "sections": {}, "torch_ns": 0.0, "cost_ns": None}
    fam = marks["families"]
    return dict(rhs=rhs, launches=req["launches"],
                replay_s=sum(sp["device_s"] or 0.0 for sp in req["spans"]
                             if sp["kind"] == "replay"),
                request_s=(req["spans"][0]["end_ns"] - req["spans"][0]["start_ns"]) / 1e9,
                cost_ns=marks["cost_ns"], families_s={k: v / 1e9 for k, v in fam.items()},
                coarse_s=sum(fam.get(k, 0.0) for k in COARSE) / 1e9,
                torch_s=marks["torch_ns"] / 1e9,
                sections={p: dict(passes=s["passes"], s=s["ns"] / 1e9,
                                  torch_s=s["torch_ns"] / 1e9,
                                  kernels_s={k: v / 1e9 for k, v in s["kernels"].items()})
                          for p, s in marks["sections"].items()})


class ProgramTrace:
    """The port's tracer over one traced run (module note)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.profiling, self.prof = _tracer()
        self.window = None
        if self.prof is not None:
            self.prof.reset()
            self.prof.set_level(self.profiling.SPANS)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmed_up(self):
        if self.prof is not None:
            self.prof.reset()

    def window_done(self):
        """The window's report; the tracer off until the reruns."""
        if self.prof is not None and self.window is None:
            self.window = window_summary(self.prof.report())
            self.prof.set_level(self.profiling.OFF)
            self.prof.reset()

    def reruns(self, run, rhs: int):
        """run() (the window's first request) at level 3 under the
        profiler and twice at level 4; returns the record's "program" entry
        (None without the tracer)."""
        if self.prof is None:
            return None
        self.window_done()
        P, prof = self.profiling, self.prof
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof.set_level(P.RANGES)
            with torch.profiler.profile(activities=acts) as p:
                run()
                self._sync()
            ranges = idle_by_span(p.events(), rhs)
            prof.set_level(P.MARKS, self.device)
            run()                   # the programs captured again, with the marks
            self._sync()
            prof.reset()
            run()
            self._sync()
            marks = marks_summary(prof.report(), rhs)
        finally:
            prof.set_level(P.OFF)
            prof.reset()
        return dict(window=self.window, ranges=ranges, marks=marks)
