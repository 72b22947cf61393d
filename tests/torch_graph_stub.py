"""A stand-in for the CUDA capture of the port's device programs
(ddalphaamg_tpu_torch/solvers/cuda_graph.py), for the CPU tests: StubGraph
records a program as CudaGraph does (every loop body once, its launches
into the graph's segments) and replays it with its control flow on the host
(TrackingHost), counting each loop's passes into the graph's trip counters,
its own launches not counted (the graph's accounting counts them).  The
fixture `traced` turns the port's tracer on for a test."""

import contextlib
from collections import Counter

import pytest
import torch

from ddalphaamg_tpu_torch import kernels, profiling
from ddalphaamg_tpu_torch.solvers.cuda_graph import CudaGraph
from ddalphaamg_tpu_torch.solvers.device_gmres import HostControl


class TrackingHost(HostControl):
    """HostControl that adds each pass of a loop to trips[k], k the index
    the capture gave that loop: the loops open in the captured order under
    each pass of their enclosing loop (parents[k], -1 for none)."""

    def __init__(self, parents, trips):
        self.children = {}
        for k, p in enumerate(parents):
            self.children.setdefault(p, []).append(k)
        self.trips = trips
        self.stack, self.cursor = [-1], {-1: 0}

    def loop(self, m, pred, body):
        parent = self.stack[-1]
        k = self.children[parent][self.cursor[parent]]
        self.cursor[parent] += 1

        def counted(j):
            self.cursor[k] = 0
            self.stack.append(k)
            try:
                body(j)
            finally:
                self.stack.pop()
            self.trips[k] += 1

        super().loop(m, pred, counted)


# the reads of a tensor's values on the host, which a captured body must not
# make (solvers/cuda_graph.py): a stand-in capture refuses them
HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist")


def _host_read(*args, **kwargs):
    raise RuntimeError("a captured program read a tensor's value on the host")


class StubGraph(CudaGraph):
    """CudaGraph's recording without CUDA (module note); its capture
    refuses every read of a tensor's value on the host, as a CUDA capture
    does."""

    captures = 0

    @contextlib.contextmanager
    def _capturing(self):
        StubGraph.captures += 1
        saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}
        for name in HOST_READS:
            setattr(torch.Tensor, name, _host_read)
        try:
            with torch.no_grad():
                yield
        finally:
            for name, fn in saved.items():
                setattr(torch.Tensor, name, fn)

    def _begin_loop(self, j, go, m):
        pass

    def _end_loop(self, k, j, go, m):
        pass

    def capture(self, fn, need=0):
        self.fn = fn
        super().capture(fn)

    def launch(self):
        kernels.launched("G")
        with kernels.recording(Counter()):
            self.fn(TrackingHost(self.parents, self.trips))

    def close(self):
        self.fn = None


@pytest.fixture
def traced():
    """The port's tracer (profiling.PROF) at level 2, emptied, for the
    test; off and emptied after it."""
    profiling.PROF.reset()
    profiling.PROF.set_level(profiling.SPANS)
    yield profiling.PROF
    profiling.PROF.set_level(profiling.OFF)
    profiling.PROF.reset()
