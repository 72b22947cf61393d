"""Device programs with loops: a function written against a control
interface (`loop(m, pred, body)`: body(j) for j = 0, 1, ... while j < m and
some element of the device bool pred() holds) runs either with its control
flow decided on the host (solvers/device_gmres.HostControl: the plain
version, one read of the device per pass) or captured once into a CUDA
graph whose WHILE nodes decide it on the device (CudaGraph,
csrc/graph.cu), replayed with no read of the device.  A loop has one body
whatever its number of passes; in a graph j is a device int64 scalar that
the loop's own kernels count, on the host a Python int.  Loops nest.

Capture rules for a captured function: every tensor that outlives a body
(a loop pass) is allocated before the body and updated in place, because a
body is captured once and runs again on the same memory, and a skipped
body leaves it as it was; no body reads the device (no .item(), bool() or
int() of a CUDA tensor, no host branch on device data); a loop predicate
keeps its storage; every kernel launches on torch's current stream, which
is the capture stream while the function is captured.  The graph's allocations go to a memory pool of its
own (torch.cuda.MemPool), held as long as the graph.  That pool takes fresh
device memory: while it is routed to, the caching allocator neither hands
it the general pool's idle blocks nor frees them on a shortage, so a
capture that needs more than the device has free empties the cache first.
A failed capture or launch raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from collections import Counter

import torch

from .. import kernels
from ..profiling import NULL, PROF, span

_capture_streams: dict = {}     # one capture stream per device
MAX_LOOPS = 64                  # loops of one graph (trip counters)


class CudaGraph:
    """A function captured once into a CUDA graph with one WHILE node per
    loop (csrc/graph.cu) on a capture stream of its device, with its own
    memory pool.  The launches of the wrappers called while it is captured
    are recorded, not counted: `call` for those outside every loop,
    `loops[k]` for one pass of loop k's body (outside the loops nested in
    it), in the order the loops were opened; `parents[k]` is the loop that
    encloses loop k (-1: none) and `trips[k]` counts loop k's passes on the
    device (kernels.GraphLaunches folds them in)."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.handle = ctypes.c_void_p()
        self.pool = None
        self.stream = None
        self.call, self.loops, self.parents = Counter(), [], []
        self.trips = torch.zeros(MAX_LOOPS, dtype=torch.long, device=device)
        self.capture_seconds = 0.0
        self.pool_bytes = 0         # device memory the capture reserved
        self._index = []            # each loop's j, kept as long as the graph
        self._open = []             # the loops being captured, innermost last

    def capture(self, fn, need: int = 0):
        """Capture fn(self) (fn calls self.loop) and instantiate the graph;
        need: the bytes its pool will take, an estimate (module note)."""
        t0 = time.perf_counter()
        if need and torch.cuda.mem_get_info(self.device)[0] < need:
            torch.cuda.empty_cache()
            if PROF.on:
                PROF.counters["empty_cache"] += 1
        reserved = torch.cuda.memory_reserved(self.device)
        with self._capturing(), kernels.recording(self.call):
            fn(self)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved

    @contextlib.contextmanager
    def _capturing(self):
        """The capture: on the device's capture stream, into a new memory
        pool; instantiated at the end, freed if anything fails."""
        lib = kernels.lib()
        dev = self.device
        stream = _capture_streams.get(dev)
        if stream is None:
            stream = _capture_streams[dev] = torch.cuda.Stream(dev)
            # cuBLAS takes its handle and workspace for a stream at its
            # first product there, which must not happen under capture
            with torch.cuda.stream(stream):
                a = torch.ones((1, 2, 2), dtype=torch.complex64, device=dev)
                a @ a
        stream.wait_stream(torch.cuda.current_stream(dev))
        self.stream, self.pool = stream, torch.cuda.MemPool()
        sptr = stream.cuda_stream
        kernels.check(lib.ddaamg_graph_begin(ctypes.byref(self.handle), sptr), "graph capture")
        try:
            with torch.cuda.stream(stream), torch.cuda.use_mem_pool(self.pool, dev):
                yield
                kernels.check(lib.ddaamg_graph_end(self.handle, sptr), "graph instantiation")
        except BaseException:
            lib.ddaamg_graph_destroy(self.handle, sptr)
            self.handle = ctypes.c_void_p()
            raise

    def _begin_loop(self, j, go, m: int):
        """Open loop k's WHILE node: j = 0, then passes while j < m and
        any of go (a bool tensor, or None)."""
        kernels.check(kernels.lib().ddaamg_graph_loop(
            self.handle, j.data_ptr(), None if go is None else go.data_ptr(),
            0 if go is None else go.numel(), m, self.stream.cuda_stream), "graph loop")

    def _end_loop(self, k: int, j, go, m: int):
        """Close loop k's body: j += 1, trips[k] += 1, again while j < m and
        any of go."""
        kernels.check(kernels.lib().ddaamg_graph_loop_end(
            self.handle, j.data_ptr(), self.trips[k].data_ptr(),
            None if go is None else go.data_ptr(), 0 if go is None else go.numel(), m,
            self.stream.cuda_stream), "graph loop end")

    def loop(self, m: int, pred, body):
        """One WHILE node whose one body, captured once, is body(j) with j
        a device int64 scalar; pred() a contiguous bool tensor (the same
        storage before the node and after the body), or None."""
        k = len(self.loops)
        if k == MAX_LOOPS:
            raise RuntimeError(f"a graph holds at most {MAX_LOOPS} loops")
        seg = Counter()
        self.loops.append(seg)
        self.parents.append(self._open[-1] if self._open else -1)
        j = torch.zeros((), dtype=torch.long, device=self.device)
        self._index.append(j)
        go = None if pred is None else pred()
        if go is not None and (go.dtype != torch.bool or not go.is_contiguous()):
            raise ValueError("a loop predicate is a contiguous bool tensor")
        self._begin_loop(j, go, m)
        self._open.append(k)
        try:
            with kernels.recording(seg):
                body(j)
                after = None if pred is None else pred()
            if after is not None and after.data_ptr() != go.data_ptr():
                raise RuntimeError("a loop predicate must keep its storage")
            self._end_loop(k, j, after, m)
        finally:
            self._open.pop()

    def launch(self):
        """One replay on the current stream (kernel "G" of kernels.KERNELS)."""
        kernels.launched("G")
        kernels.check(kernels.lib().ddaamg_graph_launch(
            self.handle, torch.cuda.current_stream(self.device).cuda_stream), "graph launch")

    def close(self):
        """Free the graph, then its pool (once the caller has dropped the
        tensors it made under capture)."""
        if self.handle:
            kernels.check(kernels.lib().ddaamg_graph_destroy(self.handle, None), "graph free")
            self.handle = ctypes.c_void_p()
        self._index.clear()
        self.pool = None

    def __del__(self):
        with contextlib.suppress(Exception):
            self.close()


class GraphProgram:
    """program(ctl, **inputs) -> {name: output} captured once (capture: the
    graph class, CudaGraph; tests give a stand-in) on static input buffers
    made beforehand; calling it copies the given values (tensors, or
    numbers to fill with) into the inputs,
    replays the graph once and returns clones of the outputs.  need: the
    pool's bytes, an estimate (CudaGraph.capture).  The graph's launches
    are accounted from its recording and its loops' trips
    (kernels.GraphLaunches), so the counts equal the host loop's.  With
    the tracer on (profiling.PROF) the capture and every replay are spans
    of the program's class at its multigrid depth, a replay timed by CUDA
    events around the graph's launch (and the row `row` of the tracer's
    table(), where the class names one); `marked`: the capture holds the
    tracer's device marks (level 4)."""

    per_depth = False       # a Multigrid keeps one program of a kind (True: of a depth)
    depth = 0               # the multigrid depth the program starts at
    row = ""                # the row of the tracer's table() its replays are, if any

    def __init__(self, program, inputs: dict, device, need: int = 0, capture=CudaGraph):
        self.inputs = inputs
        self.graph = capture(device)
        self.marked = PROF.marks
        out = self._out = {}
        with span(f"capture {type(self).__name__}", self.depth, "capture"):
            self.graph.capture(lambda ctl: out.update(program(ctl, **inputs)), need=need)
        self.graph.trips.zero_()        # a capture runs nothing; a stand-in may have
        self.launches = kernels.GraphLaunches(self, self.graph.call, self.graph.loops,
                                              self.graph.trips)

    def __call__(self, **values) -> dict:
        for name, v in values.items():
            if isinstance(v, torch.Tensor):
                self.inputs[name].copy_(v)
            else:
                self.inputs[name].fill_(v)
        with (PROF.span(f"replay {type(self).__name__}", self.depth, "replay", self.graph.device,
                        row=self.row) if PROF.on else NULL):
            self.graph.launch()
        self.launches.replayed()
        return {name: v.clone() for name, v in self._out.items()}

    def close(self):
        """Free the graph and its memory pool (the outputs first: they live
        in the pool)."""
        self._out.clear()
        self.graph.close()
