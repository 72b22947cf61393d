"""Device programs with loops and early exits: a function written against a
control interface (`repeat` for a loop of fixed length, `chain` for a run of
iterations that stops at the first false predicate) runs either with its
control flow decided on the host (HostControl: the plain version, one read
of the device per predicate) or captured once into a CUDA graph whose WHILE
and IF nodes decide it on the device (CudaGraph, csrc/graph.cu), replayed
with no read of the device.

Capture rules for a captured function: every tensor that outlives a body
(a loop pass or a chain iteration) is allocated before the body and updated
in place, because a skipped body leaves it as it was; no body reads the
device (no .item(), bool() or int() of a CUDA tensor, no host branch on
device data); every kernel launches on torch's current stream, which is the
capture stream while the function is captured.  The graph's allocations go
to a memory pool of its own (torch.cuda.MemPool), held as long as the graph.
That pool takes fresh device memory: while it is routed to, the caching
allocator neither hands it the general pool's idle blocks nor frees them on
a shortage, so a capture that needs more than the device has free empties
the cache first.  A failed capture or launch raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from collections import Counter

import torch

from .. import kernels

_capture_streams: dict = {}     # one capture stream per device


class HostControl:
    """The plain version of a graph's control flow: every predicate is
    read on the host."""

    def repeat(self, n: int, body):
        for _ in range(n):
            body()

    def chain(self, m: int, pred, body):
        """body(j) for j = 0, 1, ... while pred() (a device bool) holds, at
        most m times."""
        for j in range(m):
            if not bool(pred()):
                return
            body(j)


class CudaGraph:
    """A function captured once into a CUDA graph with conditional nodes
    (csrc/graph.cu) on a capture stream of its device, with its own memory
    pool.  The launches of the wrappers called while it is captured are
    recorded, not counted: `call` for the parts every replay runs (loop
    bodies counted by their passes), `trip` for one chain iteration, the
    same for every iteration (checked)."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.handle = ctypes.c_void_p()
        self.pool = None
        self.stream = None
        self.call, self.trip = Counter(), None
        self.trips_captured = 0     # chain iterations captured
        self.capture_seconds = 0.0
        self.pool_bytes = 0         # device memory the capture reserved
        self._counts = []           # the WHILE nodes' pass counters

    def capture(self, fn, need: int = 0):
        """Capture fn(self) (fn calls self.repeat / self.chain) and
        instantiate the graph; need: the bytes its pool will take, an
        estimate (module note)."""
        t0 = time.perf_counter()
        if need and torch.cuda.mem_get_info(self.device)[0] < need:
            torch.cuda.empty_cache()
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

    def _node(self, pred=None):
        """Open an IF node on the bool pred, or a WHILE node (pred None)."""
        lib, sptr = kernels.lib(), self.stream.cuda_stream
        if pred is None:
            kernels.check(lib.ddaamg_graph_while(self.handle, sptr), "graph WHILE node")
        else:
            kernels.check(lib.ddaamg_graph_if(self.handle, pred.data_ptr(), sptr),
                          "graph IF node")

    def _close(self, count=None, n: int = 0):
        """Close the innermost node (a WHILE node: its body runs n times)."""
        kernels.check(kernels.lib().ddaamg_graph_close(
            self.handle, self.stream.cuda_stream,
            None if count is None else count.data_ptr(), n), "graph node")

    def repeat(self, n: int, body):
        """A WHILE node whose body runs n times a replay."""
        if n < 1:
            raise ValueError("a captured loop runs at least once")
        count = torch.zeros((), dtype=torch.int32, device=self.device)
        self._counts.append(count)          # kept as long as the graph
        seg = Counter()
        self._node()
        with kernels.recording(seg):
            body()
        self._close(count, n)
        for key, k in seg.items():
            self.call[key] += k * n

    def chain(self, m: int, pred, body):
        """m nested IF nodes: iteration j runs where pred() holds after
        iteration j - 1."""
        opened = 0
        try:
            for j in range(m):
                self._node(pred())
                opened += 1
                seg = Counter()
                with kernels.recording(seg):
                    body(j)
                if self.trip is None:
                    self.trip = seg
                elif seg != self.trip:
                    raise RuntimeError(f"chain iteration {j} launched {dict(seg)}, the "
                                       f"first {dict(self.trip)}: launches per trip differ")
                self.trips_captured += 1
        finally:
            for _ in range(opened):
                self._close()

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
        self._counts.clear()
        self.pool = None

    def __del__(self):
        with contextlib.suppress(Exception):
            self.close()
