"""What a --trace 1 run reads from torch.profiler.

Two profiles of the same requests:

1. Inside the window, the timed path (every inner restart one CUDA graph
   replay): the device's busy time and its idle gaps, named by the
   benchmark span that was innermost on the host while the device idled.
   The profiler does not see the kernels that run inside a replay's loops
   (on an H100 with torch 2.11 it sees those outside them), so each replay
   is also a span: a `record_function` around `CudaGraph.launch`, whose
   device-side range (the profiler's GPU annotation) counts as busy, and a
   pair of CUDA events, whose elapsed times are printed beside it.
2. After the window, the window's first request again with the port's
   documented switch of every GCR to host loops
   (mg.hierarchy.GRAPH_DEVICES empty): the port's kernels at the same
   shapes and, as the launch counts printed beside each other show, as
   often a right-hand side as in the replays, each one seen, so the device
   time by kernel family comes from here.  PyTorch's own kernels there
   include the host loops' loop control, which the replays' bodies do not
   run, so the "torch" family can read higher than in the window.

Spans are the benchmark's: ranges named "bench:<what>" around the calls it
makes into the port (the request, the draw of its right-hand sides,
solve_multi and, inside it, the port's scatter, outer loop, gather and each
replay).  Each profile's events of every kernel family are printed beside
the launches the port counted (kernels.counts()) over the same requests.
"""

from __future__ import annotations

import contextlib
import re

import torch

SPAN = "bench:"
REPLAY = "replay"
# kernel families by the names of their instances (the port's csrc/*.cu);
# a kernel that matches none is one of PyTorch's own ("torch")
FAMILIES = (("K1", re.compile(r"dslash_(mrhs_)?kernel<(float|double), true")),
            ("K2", re.compile(r"dslash_(mrhs_)?kernel<(float|double), false")),
            ("K3", re.compile(r"clover_kernel<")),
            ("coarse", re.compile(r"coarse_(b1|mrhs)_kernel")),
            ("K6", re.compile(r"dense_bf16")),
            ("K7", re.compile(r"gcr_(cluster_step|dots|update)")),
            ("G loops", re.compile(r"loop_(start|next)_kernel")),
            ("K8", re.compile(r"(post|finish|allreduce|allgather)_kernel")),
            ("copies", re.compile(r"^(Memcpy|Memset|memcpy|memset)")))
# the port's launch counters (kernels.counts()) of each family
COUNTED = {"K1": ("K1",), "K2": ("K2",), "K3": ("K3",),
           "coarse": ("K4", "K5", "K4-bf16", "K5-bf16", "K4-schur"), "K6": ("K6",),
           "K7": ("K7",), "K8": ("K8",)}
TOP = 10


def family(name: str) -> str:
    return next((f for f, pat in FAMILIES if pat.search(name)), "torch")


def span(name: str):
    """A benchmark span (a no-op unless the profiler records)."""
    return torch.profiler.record_function(SPAN + name)


def _wrapped(fn, label, events=None):
    """fn inside a span; with `events`, also between two CUDA events,
    appended there."""
    def wrapped(*a, **k):
        with span(label):
            if events is None:
                return fn(*a, **k)
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
            out = fn(*a, **k)
            pair[1].record()
            events.append(pair)
            return out
    return wrapped


@contextlib.contextmanager
def graphs_off():
    """Every GCR of the port driven from the host (mg.hierarchy.GRAPH_DEVICES
    empty) inside the block; on a process grid every rank enters it for the
    same requests."""
    from ddalphaamg_tpu_torch.mg import hierarchy

    saved = hierarchy.GRAPH_DEVICES
    hierarchy.GRAPH_DEVICES = ()
    try:
        yield
    finally:
        hierarchy.GRAPH_DEVICES = saved


def _union(intervals):
    """Merged [start, end] intervals of sorted (start, end) pairs."""
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _events(prof):
    """(kernels, copies and sets: [(start, end, name)], the GPU annotations
    of the benchmark's spans and its host spans: [(start, end, span)]), in
    microseconds on the profiler's clock."""
    from torch.autograd import DeviceType

    device, notes, host = [], [], []
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(SPAN):
                notes.append((*r, e.name[len(SPAN):]))
            else:
                device.append((*r, e.name))
        elif e.name.startswith(SPAN):
            host.append((*r, e.name[len(SPAN):]))
    return device, notes, host


def _families(device):
    """({family: [events, seconds]}, the TOP kernels by seconds)."""
    families, names = {}, {}
    for a, b, name in device:
        for table, key in ((families, family(name)), (names, name)):
            row = table.setdefault(key, [0, 0.0])
            row[0] += 1
            row[1] += (b - a) / 1e6
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:TOP]
    return families, [(k, family(k), n, s) for k, (n, s) in top]


def _coverage(families, launches):
    """{family: (the profile's events, the port's launches)}."""
    return {f: (families.get(f, [0, 0.0])[0], sum(launches.get(k, 0) for k in keys))
            for f, keys in COUNTED.items()}


def _innermost(host, w0, w1):
    """[(start, end, span)]: [w0, w1] cut where a host span opens or
    closes, each piece named by the innermost span open over it."""
    cuts = sorted({w0, w1, *(t for a, b, _ in host for t in (a, b) if w0 < t < w1)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        open_ = [s for s in host if s[0] <= a and b <= s[1]]
        out.append((a, b, max(open_)[2] if open_ else "between requests"))
    return out


class Tracer:
    """The two profiles of a traced run (module note) on `solver`, with
    the port's launch counts `counts` (kernels.counts) over the same
    requests."""

    def __init__(self, solver, counts, device):
        self.solver, self.counts, self.device = solver, counts, torch.device(device)
        self.prof = self.launches = None
        self.replays = []

    @contextlib.contextmanager
    def _spans(self):
        from ddalphaamg_tpu_torch.solvers import cuda_graph

        launch = cuda_graph.CudaGraph.launch
        cuda_graph.CudaGraph.launch = _wrapped(launch, REPLAY, self.replays)
        names = {"_scatter": "scatter", "_solve_mp": "outer loop", "_gather": "gather"}
        for attr, label in names.items():
            setattr(self.solver, attr, _wrapped(getattr(self.solver, attr), label))
        try:
            yield
        finally:
            cuda_graph.CudaGraph.launch = launch
            for attr in names:
                delattr(self.solver, attr)

    def _activities(self, cpu: bool):
        acts = ([torch.profiler.ProfilerActivity.CPU] if cpu or self.device.type != "cuda"
                else [])
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        """Starts the window's profile, with the spans."""
        self.prof = torch.profiler.profile(activities=self._activities(cpu=True))
        self.prof.start()
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._spans())
        self.before = self.counts()

    def stop(self):
        """Ends the window's profile (once)."""
        if self.prof is None or self.launches is not None:
            return
        self._sync()
        self.prof.stop()
        self._stack.close()
        self.launches = {k: n - self.before.get(k, 0) for k, n in self.counts().items()}

    def host_loops(self, run, rhs: int) -> dict:
        """run() (the window's first request again) with every GCR driven
        from the host, profiled: each family's device events and seconds, the top
        kernels and the coverage, over `rhs` right-hand sides."""
        before = self.counts()
        with graphs_off(), torch.profiler.profile(
                activities=self._activities(cpu=False)) as prof:
            run()
            self._sync()
        launches = {k: n - before.get(k, 0) for k, n in self.counts().items()}
        families, top = _families(_events(prof)[0])
        return dict(families=families, top_events=top, rhs=rhs,
                    coverage=_coverage(families, launches))

    def summarize(self, rhs: int, host_loops: dict) -> dict:
        """The window's profile of `rhs` right-hand sides: busy and window
        seconds (the first request span's start to the last one's end),
        idle gaps by span, the replays (count, annotated and CUDA-event
        seconds), the visible families' coverage; the host-loop profile
        gives the breakdown's device operations."""
        device, notes, host = _events(self.prof)
        requests = [s for s in host if s[2] == "request"]
        w0, w1 = min(s[0] for s in requests), max(s[1] for s in requests)
        replays = [(a, b) for a, b, name in notes if name == REPLAY]
        busy = _union(sorted((max(a, w0), min(b, w1))
                             for a, b in [(a, b) for a, b, _ in device] + replays
                             if b > w0 and a < w1))
        gaps = {}
        pieces = _innermost(host, w0, w1)
        for a, b in zip([w0] + [iv[1] for iv in busy], [iv[0] for iv in busy] + [w1]):
            for p0, p1, name in pieces:
                lo, hi = max(a, p0), min(b, p1)
                if hi > lo:
                    gaps[name] = gaps.get(name, 0.0) + (hi - lo) / 1e6
        visible, top = _families(device)
        ops = sorted(((f, s) for f, (_, s) in host_loops["families"].items()),
                     key=lambda kv: -kv[1])
        return dict(busy_s=sum(b - a for a, b in busy) / 1e6, window_s=(w1 - w0) / 1e6,
                    rhs=rhs, requests=len(requests), visible=visible, top_events=top,
                    coverage=_coverage(visible, self.launches),
                    replays=(len(replays), sum(b - a for a, b in replays) / 1e6,
                             sum(p[0].elapsed_time(p[1]) for p in self.replays) / 1e3),
                    host_loops=host_loops,
                    breakdown={"device_ops": [[f, s] for f, s in ops[:TOP]],
                               "idle_gaps": [[k, v] for k, v in sorted(
                                   gaps.items(), key=lambda kv: -kv[1])[:TOP]]})
