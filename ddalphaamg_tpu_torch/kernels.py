"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with nvcc for sm_90a, one nvcc process per source,
all started together, and linked into one shared library with a plain C
interface, loaded with ctypes.  The build happens at first use, never at
import, into build/torch_kernels/ under the repository root (listed in
.gitignore), keyed by a hash of the sources.  A failed build raises.

Every kernel has a `Kernel` record whose `launches` counter its wrapper
increments exactly where it launches the CUDA kernel (`launched`); a run can
reset the counters and read them afterwards to show that it went through the
kernels.  A wrapper called while a CUDA graph is captured (solvers/
cuda_graph.py) launches nothing: `launched` then records the launch into the
segment of the graph being captured (`recording`: the part outside its
loops, or the body of the innermost loop being captured), and the graph's
`GraphLaunches` turn its replays and its loops' device trip counters into
launches when the counts are next read (`counts`, `reset_counts`), so that
a replay adds no read of the device.

With the tracer's device marks on (profiling.py, level 4) `tracer` is the
profiler: `launched` then opens a mark before the launch and `check`, which
every wrapper calls right after it, closes it, so each port kernel launch
is bracketed by two one-thread marks (csrc/mark.cu); graph replays ("G")
are not marked.  Below level 4 `tracer` is None and nothing more runs.
"""

from __future__ import annotations

import ctypes
import contextlib
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import weakref
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times its wrapper launched it."""

    name: str
    route: str
    source: str
    replaces: str
    launches: int = 0


KERNELS = {
    "K1": Kernel("K1 dslash full", "cuda", "ddalphaamg_tpu_torch/csrc/dslash.cu",
                 "ddalphaamg_tpu/operators/pallas_dslash.py:385"),
    "K2": Kernel("K2 dslash hop", "cuda", "ddalphaamg_tpu_torch/csrc/dslash.cu",
                 "ddalphaamg_tpu/operators/pallas_dslash.py:385"),
    "K3": Kernel("K3 clover", "cuda", "ddalphaamg_tpu_torch/csrc/dslash.cu",
                 "ddalphaamg_tpu/operators/pallas_dslash.py:353"),
    "K4": Kernel("K4 coarse", "cuda", "ddalphaamg_tpu_torch/csrc/coarse.cu",
                 "ddalphaamg_tpu/operators/pallas_coarse.py:200"),
    "K5": Kernel("K5 coarse halo", "cuda", "ddalphaamg_tpu_torch/csrc/coarse.cu",
                 "ddalphaamg_tpu/operators/pallas_coarse.py:223"),
    "K4-bf16": Kernel("K4-bf16 coarse, bf16 blocks", "cuda",
                      "ddalphaamg_tpu_torch/csrc/coarse.cu",
                      "ddalphaamg_tpu/operators/pallas_coarse.py:200 (bf16 blocks "
                      "widened at pallas_coarse.py:114-116)"),
    "K5-bf16": Kernel("K5-bf16 coarse halo, bf16 blocks", "cuda",
                      "ddalphaamg_tpu_torch/csrc/coarse.cu",
                      "ddalphaamg_tpu/operators/pallas_coarse.py:223 (bf16 blocks "
                      "widened at pallas_coarse.py:140-142)"),
    "K4-schur": Kernel("K4-schur the coarsest level's even-site Schur complement on "
                       "parity-split blocks, two launches an apply", "cuda",
                       "ddalphaamg_tpu_torch/csrc/coarse.cu",
                       "ddalphaamg_tpu/operators/pallas_coarse.py:200 (four K4 applies of "
                       "ddalphaamg_tpu/mg/hierarchy.py:659's Schur operator)"),
    "K6": Kernel("K6 bf16 batched matvec", "cuda", "ddalphaamg_tpu_torch/csrc/dense.cu",
                 "ddalphaamg_tpu/operators/stencil.py:710, :727 and "
                 "ddalphaamg_tpu/smoothers/sap.py:193 (XLA einsums, no pallas_call)"),
    "K7": Kernel("K7 GCR step (Gram-Schmidt, alpha, x / r updates, norm, stop test) with "
                 "the row count read from the device", "cuda",
                 "ddalphaamg_tpu_torch/csrc/gcr.cu",
                 "ddalphaamg_tpu/solvers/device_gmres.py:106-136 (XLA einsums over all m "
                 "rows and fused updates inside the lax.while_loop, no pallas_call)"),
    "K8": Kernel("K8 grid collectives over peer pointers (face exchange post / finish, "
                 "all-reduce, gather), which a graph's loop body can hold", "cuda",
                 "ddalphaamg_tpu_torch/csrc/peer.cu",
                 "ddalphaamg_tpu/parallel/halo.py:60-114 (lax.ppermute), "
                 "ddalphaamg_tpu/solvers/device_gmres.py:111-136 (lax.psum) and "
                 "ddalphaamg_tpu/mg/hierarchy.py:223-232 (the gather to the replicated "
                 "level), no pallas_call"),
    "G": Kernel("G CUDA graph replays: the coarsest GCR, the inner restart, the cycle "
                "(one-body WHILE loops with a device-side index)",
                "cuda", "ddalphaamg_tpu_torch/csrc/graph.cu",
                "ddalphaamg_tpu/mg/hierarchy.py:659, :806-836, :792-804 (the coarsest "
                "solve, the inner restart and the cycle as one XLA program each: "
                "lax.while_loop, no pallas_call)"),
}


_recording: list = []       # the launch counters of the graph segments being captured
tracer = None               # the profiler whose device marks are on (module note)
_graphs: list = []          # the GraphLaunches of graphs replayed since their last fold


def launched(key: str):
    """One launch of kernel `key` by its wrapper, or, while a graph is
    captured, one launch recorded into the segment being captured."""
    if _recording:
        _recording[-1][key] += 1
    else:
        KERNELS[key].launches += 1
    if tracer is not None and key != "G":
        tracer.kernel_begin(key)


@contextlib.contextmanager
def recording(segment: Counter):
    """Record the launches of the wrappers called inside into `segment`
    (a graph segment being captured) instead of counting them."""
    _recording.append(segment)
    try:
        yield segment
    finally:
        _recording.pop()


class GraphLaunches:
    """The launches of one captured graph: `per_call` kernels launched by
    every replay outside its loops, `per_loop[k]` by one pass of loop k's
    body (outside the loops nested in it); `trips` [>= len(per_loop)] is
    the graph's device counter of each loop's passes (it only grows).
    Replays are counted on the host (`replayed`); the trips are read, in
    one read, when the counts are next read."""

    def __init__(self, owner, per_call: Counter, per_loop: list, trips):
        self._owner = weakref.ref(owner)
        self.per_call, self.per_loop, self.trips = per_call, per_loop, trips
        self.replays = self._folded_replays = 0
        self._folded_trips = [0] * len(per_loop)

    def replayed(self):
        self.replays += 1
        if self not in _graphs:
            _graphs.append(self)

    def fold(self):
        """Add the launches since the last fold to KERNELS."""
        trips = self.trips[:len(self.per_loop)].tolist()
        calls = self.replays - self._folded_replays
        for key, n in self.per_call.items():
            KERNELS[key].launches += n * calls
        for seg, now, before in zip(self.per_loop, trips, self._folded_trips):
            for key, n in seg.items():
                KERNELS[key].launches += n * (now - before)
        self._folded_replays, self._folded_trips = self.replays, trips


def _fold_graphs():
    for g in _graphs:
        g.fold()
    _graphs[:] = [g for g in _graphs if g._owner() is not None]


def reset_counts():
    _fold_graphs()
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict:
    _fold_graphs()
    return {key: k.launches for key, k in KERNELS.items()}


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "ddaamg_dslash_f32": [_P, _P, _P, _P, _P] + [_I] * 8 + [_P],
    "ddaamg_dslash_f64": [_P, _P, _P, _P, _P] + [_I] * 8 + [_P],
    "ddaamg_clover_f32": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    "ddaamg_clover_f64": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    "ddaamg_coarse_f32": [_P, _P, _P] + [_I] * 15 + [_P],
    "ddaamg_coarse_f64": [_P, _P, _P] + [_I] * 15 + [_P],
    "ddaamg_coarse_halo_f32": [_P] * 11 + [_I] * 9 + [_P],
    "ddaamg_coarse_halo_f64": [_P] * 11 + [_I] * 9 + [_P],
    "ddaamg_coarse_bf16": [_P, _P, _P] + [_I] * 15 + [_P],
    "ddaamg_coarse_halo_bf16": [_P] * 11 + [_I] * 9 + [_P],
    "ddaamg_schur_f32": [_P] * 5 + [_I] * 7 + [_P],
    "ddaamg_schur_f64": [_P] * 5 + [_I] * 7 + [_P],
    "ddaamg_schur_bf16": [_P] * 5 + [_I] * 7 + [_P],
    "ddaamg_dense_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    "ddaamg_dense_bf16_mrhs": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ddaamg_gcr_path": [_L, _I, _I],
    "ddaamg_gcr_cluster_fits": [_L, _I, _I],
    "ddaamg_gcr_cluster_shape": [_L, _P, _P, _P],
    "ddaamg_gcr_work_bytes": [_I, _I, _L, _I],
    "ddaamg_gcr_sync_words": [_I, _I],
    "ddaamg_gcr_step_c64": [_P] * 15 + [_I, _I, _L, _I, _P],
    "ddaamg_gcr_step_c128": [_P] * 15 + [_I, _I, _L, _I, _P],
    "ddaamg_peer_handle_bytes": [],
    "ddaamg_peer_row": [],
    "ddaamg_peer_alloc": [_L, _P, _P],
    "ddaamg_peer_open": [_P, _P],
    "ddaamg_peer_close": [_P],
    "ddaamg_peer_free": [_P],
    "ddaamg_peer_post": [_P, _P, _P, _P, _P, _P, _I, _L, _P],
    "ddaamg_peer_finish": [_P, _P, _P, _P, _P, _P, _I, _L, _P],
    "ddaamg_peer_allreduce": [_P, _P, _P, _P, _P, _I, _P, _P, _L, _I, _L, _P],
    "ddaamg_peer_allgather": [_P, _P, _P, _P, _P, _I, _P, _P, _L, _L, _L, _P],
    "ddaamg_graph_begin": [_P, _P],
    "ddaamg_graph_loop": [_P, _P, _P, _I, _I, _P],
    "ddaamg_graph_loop_end": [_P, _P, _P, _P, _I, _I, _P],
    "ddaamg_graph_end": [_P, _P],
    "ddaamg_graph_launch": [_P, _P],
    "ddaamg_graph_destroy": [_P, _P],
    "ddaamg_mark": [_P, _I, _I, _P],
}

_RESTYPES = {"ddaamg_gcr_work_bytes": ctypes.c_longlong}   # the rest return an int

_lib = None
build_seconds = 0.0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _run_all(cmds):
    """Run the commands side by side; raises with the first failure's
    output once all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n"
                               f"{out}\n{err}")


def build() -> Path:
    """Compile the library if no build of the current sources exists;
    returns its path."""
    global build_seconds
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libddaamg_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(srcs, objs)])
        so = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", so, *objs]])
        os.replace(so, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _lib = handle
    return _lib


def check(rc: int, what: str):
    if tracer is not None:
        tracer.kernel_end()
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
